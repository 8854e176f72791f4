"""The 3-D fractional-diffusion collocation matrix of the paper's section
6.2 (the singular-integral form of (-Delta)^s) over a KD-tree-ordered
uniform grid with spacing ``h``:

    A_ij = -h^{2d} / r_ij^{d + 2s}                     (i != j)
    A_ii = sum_{j != i} h^{2d} / r_ij^{d + 2s} + mass h^d

SPD by diagonal dominance, with a condition number of about h^{-2s} /
mass. The row sums are taken a block of tile rows at a time against every
point; the off-diagonal tiles are compressed (``compress.py``) at an
absolute ``compress_eps``.

Configuration keys: ``n``, ``dim``, ``tile``, ``s``, ``mass``, ``dtype``,
``compress_eps``, ``r_max``, ``compress_bs``, ``compress_chunk``.
"""

from __future__ import annotations

import torch

from .. import compress, geometry, seeds
from . import DTYPES, distances, lower_pairs

ROW_TILES = 8   # tile rows per block of the row sums


def build(cfg: dict, seed: int, device: torch.device, n=None) -> dict:
    n = n or cfg["n"]
    b, d = cfg["tile"], cfg["dim"]
    dtype = DTYPES[cfg["dtype"]]
    nb = n // b
    h = 1.0 / max(n ** (1.0 / d) - 1.0, 1.0)
    alpha = d + 2 * cfg["s"]
    h2d = h ** (2 * d)
    P = torch.as_tensor(geometry.ordered_grid(n, d, b), dtype=dtype,
                        device=device).reshape(nb, b, d)

    def weights(I, J):
        r = distances(P, I, J)
        return torch.where(r > 0, h2d / r.pow(alpha), 0.0)

    rowsum = torch.empty((nb, b), dtype=dtype, device=device)
    every = torch.arange(nb, device=device)
    for i0 in range(0, nb, ROW_TILES):
        rows = torch.arange(i0, min(nb, i0 + ROW_TILES), device=device)
        I = rows.repeat_interleave(nb)
        J = every.repeat(rows.numel())
        rowsum[rows] = weights(I, J).reshape(rows.numel(), nb, b, b).sum(
            dim=(1, 3))
    D = -weights(every, every)
    torch.diagonal(D, dim1=1, dim2=2).copy_(rowsum + cfg["mass"] * h**d)
    I, J = lower_pairs(nb, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "compress"))
    U, V, ranks = compress.compress_tiles(
        lambda lo, hi: weights(I[lo:hi], J[lo:hi]).neg_(), I.numel(), b,
        eps=cfg["compress_eps"], r_max=cfg["r_max"], bs=cfg["compress_bs"],
        generator=gen, dtype=dtype, device=device,
        chunk=cfg["compress_chunk"])
    return {"D": D, "U": U, "V": V, "ranks": ranks}
