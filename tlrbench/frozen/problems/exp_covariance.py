"""The spatial-statistics covariance of the paper's section 6.1:
``K = exp(-r / ell) + nugget I`` over a KD-tree-ordered uniform grid,
compressed tile by tile (``compress.py``) at an absolute ``compress_eps``.

Configuration keys: ``n``, ``dim``, ``tile``, ``ell``, ``nugget``,
``dtype``, ``compress_eps``, ``r_max``, ``compress_bs``,
``compress_chunk``.
"""

from __future__ import annotations

import torch

from .. import compress, geometry, seeds
from . import DTYPES, distances, lower_pairs


def build(cfg: dict, seed: int, device: torch.device, n=None) -> dict:
    n = n or cfg["n"]
    b, d, ell = cfg["tile"], cfg["dim"], cfg["ell"]
    dtype = DTYPES[cfg["dtype"]]
    nb = n // b
    P = torch.as_tensor(geometry.ordered_grid(n, d, b), dtype=dtype,
                        device=device).reshape(nb, b, d)

    def kernel(I, J):
        return distances(P, I, J).div_(-ell).exp_()

    diag = torch.arange(nb, device=device)
    D = kernel(diag, diag)
    torch.diagonal(D, dim1=1, dim2=2).add_(cfg["nugget"])
    I, J = lower_pairs(nb, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "compress"))
    U, V, ranks = compress.compress_tiles(
        lambda lo, hi: kernel(I[lo:hi], J[lo:hi]), I.numel(), b,
        eps=cfg["compress_eps"], r_max=cfg["r_max"], bs=cfg["compress_bs"],
        generator=gen, dtype=dtype, device=device,
        chunk=cfg["compress_chunk"])
    return {"D": D, "U": U, "V": V, "ranks": ranks}
