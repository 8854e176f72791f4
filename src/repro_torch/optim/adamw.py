"""AdamW with optional low-precision moments (the port's
``repro/optim/adamw.py``), on trees of tensors.

The arithmetic is the JAX package's (``adamw.py:60-75``): gradients clipped
by their global float32 norm, float32 moments stored in ``moment_dtype``,
bias correction, and weight decay added to the step before the learning
rate. It is not ``torch.optim.AdamW``, which clips nothing and decays the
weights apart from the step. ``adamw_update`` is functional, as JAX's: it
returns new tensors and leaves its arguments as they were (TLR-KFAC grafts
its step from the difference). ``moment_dtype=bfloat16`` halves the
optimizer state. A leaf larger than ``_CHUNK`` elements is updated in
slices (the same bits), so the update holds little beyond the old and the
new state (granite-moe's stacked expert leaves hold 1.0 B elements each).
On a sharded model (DTensor leaves) each rank updates its block of a
leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..device import is_dtensor, torch_dtype
from ..tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the parameters' device
    m: Any
    v: Any


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    dt = torch_dtype(cfg.moment_dtype)
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params),
    )


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in leaves(tree)]).sum())



# Elements of a leaf updated at a time (float32 temporaries of 256 MiB).
_CHUNK = 1 << 26


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """Returns (new_params, new_state)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    t = step.float()
    bc1 = 1 - torch.pow(cfg.b1, t)       # float32, as JAX's b1 ** step
    bc2 = 1 - torch.pow(cfg.b2, t)

    def upd_flat(g, m, v, p):
        g = g.float() * clip
        mf = m.float() * cfg.b1 + (1 - cfg.b1) * g
        vf = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        newp = p.float() - cfg.lr * delta
        return newp.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    def upd(g, m, v, p):
        if is_dtensor(p):
            return upd_blocks(g, m, v, p)
        if p.numel() <= _CHUNK:
            return upd_flat(g, m, v, p)
        # elementwise, so a leaf updated in slices gives the same bits
        # while its float32 temporaries stay at _CHUNK elements
        out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        flat = [x.reshape(-1) for x in (g, m, v, p)]
        dst = [x.view(-1) for x in out]
        for a in range(0, p.numel(), _CHUNK):
            for d, x in zip(dst, upd_flat(*(f[a:a + _CHUNK] for f in flat))):
                d[a:a + _CHUNK] = x
        return out

    def upd_blocks(g, m, v, p):
        # a DTensor leaf (a sharded model): elementwise, so each rank
        # updates its block of the leaf, with every tensor at the
        # parameter's placements
        mesh, places = p.device_mesh, p.placements
        blocks = [x.redistribute(mesh, places).to_local() for x in (g, m, v)]
        out = upd(*blocks, p.to_local())
        return tuple(type(p).from_local(o, mesh, places, run_check=False,
                                        shape=p.shape, stride=p.stride())
                     for o in out)

    if is_dtensor(clip):       # the scalars whole on every rank
        clip, bc1, bc2 = (x.full_tensor() if is_dtensor(x) else x
                          for x in (clip, bc1, bc2))
    out = [upd(*xs) for xs in zip(leaves(grads), leaves(state.m),
                                  leaves(state.v), leaves(params))]
    new_params = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_params, AdamWState(step=step, m=new_m, v=new_v)
