"""Generators of the benchmark's inputs, one module per problem kind.

``build(cfg, seed, device, n=None)`` of module ``<kind>`` returns the
compressed symmetric operator of a configuration file whose ``problem`` is
``<kind>`` as a dict of tensors on ``device``: ``D`` (nb, b, b) dense
diagonal tiles, and ``U``, ``V`` (nt, b, r_max) and ``ranks`` (nt,) int32
of the strictly lower tiles (i, j), i > j, packed at ``i (i - 1) / 2 + j``,
tile ~= U V^T. ``n`` overrides the configuration's size (the warm-up
builds a small operator of the same kind). A new kind is a new module.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

DTYPES = {"float64": torch.float64}


def build(cfg: dict, seed: int, device, n: int | None = None) -> dict:
    mod = importlib.import_module(f"{__name__}.{cfg['problem']}")
    return mod.build(cfg, seed, torch.device(device), n)


def lower_pairs(nb: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row and column tile indices of the packed strictly lower tiles."""
    i, j = np.tril_indices(nb, -1)
    return (torch.as_tensor(i, device=device),
            torch.as_tensor(j, device=device))


def distances(P: torch.Tensor, I: torch.Tensor, J: torch.Tensor):
    """(T, b, b) distances between the points of tiles I[t] and J[t] of the
    tiled cloud P (nb, b, d), by differences, so that tile (j, i) is the
    exact transpose of tile (i, j)."""
    X, Y = P[I], P[J]
    d2 = None
    for c in range(P.shape[-1]):
        sq = (X[:, :, None, c] - Y[:, None, :, c]).square_()
        d2 = sq if d2 is None else d2.add_(sq)
    return d2.sqrt_()
