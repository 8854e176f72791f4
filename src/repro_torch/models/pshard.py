"""Activation-sharding hook (the port's ``repro/models/pshard.py``).

Model code calls ``shard(x, "dp", None, "model")`` at the points where the
JAX package constrains an activation's layout (post-embedding, block
boundaries, attention heads, logits). By default this is the identity, so
``models/`` runs with no mesh at all; a launcher may install a hook that
maps the symbolic names onto a device mesh. The JAX package's
``make_mesh_hook`` (``with_sharding_constraint`` on a JAX mesh) is not
ported yet: it comes with the model half of ``launch/sharding.py``
(ROADMAP Queue 1 item 10, step 2).
"""

from __future__ import annotations

from typing import Callable, Optional

_HOOK: Optional[Callable] = None


def set_hook(fn: Optional[Callable]) -> None:
    global _HOOK
    _HOOK = fn


def shard(x, *names):
    if _HOOK is None:
        return x
    return _HOOK(x, names)
