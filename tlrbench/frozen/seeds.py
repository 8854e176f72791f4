"""Seeds derived from a run's ``--seed``: any whole number, also past 64
bits, names a stream by its keys (``derive(seed, "probe", 3)``), each
stream a valid seed of a ``torch.Generator``."""

from __future__ import annotations

import hashlib


def derive(seed: int, *keys) -> int:
    """A seed in [0, 2**63) determined by ``seed`` and ``keys``."""
    text = ":".join(str(k) for k in (int(seed), *keys))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
