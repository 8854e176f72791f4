"""Problem generators matching the paper's experiments (section 6).

Own copy of the numpy generators of ``repro/core/generators.py`` (the port
imports nothing of ``repro``), plus a torch evaluation of the covariance
kernels with the same formula, so a large covariance matrix is built on the
device: at N = 32768 the numpy path needs about 30 GB of host memory.

* Spatial-statistics covariance matrices: isotropic exponential kernel
  ``exp(-r / ell)`` with correlation lengths 0.1 (2D) and 0.2 (3D), points on
  a uniform grid or random in a ball.
* The 3D fractional-diffusion collocation matrix of section 6.2 (SPD,
  ill-conditioned), in numpy (:func:`fractional_diffusion`, equal to the
  JAX package's bit for bit) and built on the device
  (:func:`fractional_diffusion_matrix`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from .ordering import kd_tree_ordering


# -- point clouds ------------------------------------------------------------


def grid_points(n: int, d: int) -> np.ndarray:
    """~n points on a uniform grid in [0,1]^d (exactly m^d for m=ceil(n^(1/d)))."""
    m = int(round(n ** (1.0 / d)))
    while m**d < n:
        m += 1
    axes = [np.linspace(0.0, 1.0, m) for _ in range(d)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, d)
    return pts[:n]


def ball_points(n: int, d: int, seed: int = 0) -> np.ndarray:
    """n points uniformly distributed in the unit d-ball."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = rng.random(n) ** (1.0 / d)
    return x * r[:, None]


# -- kernels (numpy) -----------------------------------------------------------


def pairwise_dist(points: np.ndarray) -> np.ndarray:
    g = points @ points.T
    sq = np.diag(g)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2 * g, 0.0)
    return np.sqrt(d2)


def exp_covariance(
    points: np.ndarray, ell: float, nugget: float = 1e-8
) -> np.ndarray:
    """Isotropic exponential covariance  K = exp(-r/ell) + nugget*I  (SPD)."""
    r = pairwise_dist(points)
    K = np.exp(-r / ell)
    K[np.diag_indices_from(K)] += nugget
    return K


def matern32_covariance(
    points: np.ndarray, ell: float, nugget: float = 1e-8
) -> np.ndarray:
    """Matern nu=3/2 covariance (smoother spectrum than exponential)."""
    r = pairwise_dist(points) * (np.sqrt(3.0) / ell)
    K = (1.0 + r) * np.exp(-r)
    K[np.diag_indices_from(K)] += nugget
    return K


def fractional_diffusion(
    points: np.ndarray, s: float = 0.75, mass: float = 1e-3
) -> np.ndarray:
    """SPD, ill-conditioned fractional-Laplacian collocation matrix.

    Singular-integral form of (-Delta)^s (the paper's [12] integral
    formulation):  (-Delta)^s u(x) = c \\int (u(x)-u(y)) / |x-y|^{d+2s} dy.
    Collocation with double quadrature weight h^{2d} gives the symmetric
    diagonally-dominant matrix

        A_ij = -h^{2d} / r_ij^{d+2s}   (i != j),
        A_ii =  sum_{j!=i} h^{2d}/r_ij^{d+2s} + mass * h^d,

    which is SPD (Gershgorin) with condition number ~ h^{-2s} / mass --
    severely ill-conditioned as n grows, matching the paper's kappa ~ 1e7
    regime for N = 2^17. Off-diagonal *tiles* inherit the low-rank structure
    of the smooth far-field kernel.
    """
    n, d = points.shape
    if not 0.0 < s < 1.0:
        raise ValueError(f"need 0 < s < 1, got s={s}")
    r = pairwise_dist(points)
    h = 1.0 / max(n ** (1.0 / d) - 1.0, 1.0)
    alpha = d + 2 * s
    with np.errstate(divide="ignore"):
        W = (h ** (2 * d)) / np.maximum(r, 1e-300) ** alpha
    np.fill_diagonal(W, 0.0)
    A = -W
    np.fill_diagonal(A, W.sum(axis=1) + mass * h**d)
    return 0.5 * (A + A.T)


# -- kernels (torch, on the device) ----------------------------------------------


def pairwise_dist_torch(points: torch.Tensor,
                        rows_per_chunk: int = 4096) -> torch.Tensor:
    """Same formula, in the same order of operations, as
    :func:`pairwise_dist`, computed in place on one (n, n) buffer; the
    temporaries are ``rows_per_chunk`` rows tall."""
    g = points @ points.T
    sq = torch.diagonal(g).clone()
    for i0 in range(0, g.shape[0], rows_per_chunk):
        blk = g[i0:i0 + rows_per_chunk]
        blk.copy_((sq[i0:i0 + rows_per_chunk, None] + sq[None, :]) - 2 * blk)
    return g.clamp_(min=0.0).sqrt_()


def exp_covariance_torch(points: torch.Tensor, ell: float,
                         nugget: float = 1e-8) -> torch.Tensor:
    K = pairwise_dist_torch(points)
    K.neg_().div_(ell).exp_()
    torch.diagonal(K).add_(nugget)
    return K


def matern32_covariance_torch(points: torch.Tensor, ell: float,
                              nugget: float = 1e-8) -> torch.Tensor:
    r = pairwise_dist_torch(points).mul_(math.sqrt(3.0) / ell)
    K = torch.exp(-r)
    K.mul_(r.add_(1.0))
    del r
    torch.diagonal(K).add_(nugget)
    return K


def covariance_matrix(points, kernel: str = "exp", ell=None,
                      nugget: float = 1e-8, *, device=None,
                      dtype=torch.float64) -> torch.Tensor:
    """Dense covariance of ``points`` evaluated on ``device``."""
    pts = torch.as_tensor(np.asarray(points), dtype=dtype,
                          device=resolve_device(device))
    if ell is None:
        ell = 0.1 if pts.shape[1] == 2 else 0.2
    if kernel == "exp":
        return exp_covariance_torch(pts, ell, nugget)
    if kernel == "matern32":
        return matern32_covariance_torch(pts, ell, nugget)
    raise ValueError(f"unknown kernel {kernel!r}")


def fractional_diffusion_matrix(points, s: float = 0.75, mass: float = 1e-3,
                                *, device=None, dtype=torch.float64,
                                rows_per_chunk: int = 4096) -> torch.Tensor:
    """:func:`fractional_diffusion` of ``points`` built on ``device``, the
    same formula in the same order of operations: ``W = h^{2d} /
    max(r, 1e-300)^{d+2s}`` in place over the distances, row chunks of
    ``rows_per_chunk`` at a time, the row sums taken with W's diagonal
    zeroed, then ``A = -W`` with those sums (plus the mass term) on its
    diagonal and ``0.5 (A + A^T)`` in place by square blocks. Peak memory
    is one (n, n) matrix plus a few chunk-sized temporaries."""
    pts = torch.as_tensor(np.asarray(points), dtype=dtype,
                          device=resolve_device(device))
    n, d = pts.shape
    if not 0.0 < s < 1.0:
        raise ValueError(f"need 0 < s < 1, got s={s}")
    h = 1.0 / max(n ** (1.0 / d) - 1.0, 1.0)
    alpha = d + 2 * s
    h2d = h ** (2 * d)
    A = pairwise_dist_torch(pts, rows_per_chunk)
    for i0 in range(0, n, rows_per_chunk):
        blk = A[i0:i0 + rows_per_chunk]
        blk.copy_(h2d / blk.clamp(min=1e-300).pow_(alpha))
    torch.diagonal(A).zero_()
    rowsum = A.sum(dim=1)
    A.neg_()
    torch.diagonal(A).copy_(rowsum + mass * h**d)
    del rowsum
    for i0 in range(0, n, rows_per_chunk):
        for j0 in range(i0, n, rows_per_chunk):
            upper = A[i0:i0 + rows_per_chunk, j0:j0 + rows_per_chunk]
            lower = A[j0:j0 + rows_per_chunk, i0:i0 + rows_per_chunk]
            sym = 0.5 * (upper + lower.T)
            upper.copy_(sym)
            lower.copy_(sym.T)
    return A


# -- assembled problems ------------------------------------------------------


def covariance_problem(
    n: int,
    d: int,
    tile_size: int,
    *,
    geometry: str = "grid",
    seed: int = 0,
    kernel: str = "exp",
    device=None,
    dtype=torch.float64,
):
    """Points (KD-tree ordered, numpy) + covariance matrix (torch, built on
    ``device``), the paper's section 6.1 setup."""
    ell = 0.1 if d == 2 else 0.2
    pts = grid_points(n, d) if geometry == "grid" else ball_points(n, d, seed)
    pts = pts[:n]
    perm = kd_tree_ordering(pts, tile_size)
    pts = pts[perm]
    return pts, covariance_matrix(pts, kernel, ell, device=device,
                                  dtype=dtype)


def fractional_diffusion_points(n: int, tile_size: int) -> np.ndarray:
    """The 3D grid points of section 6.2, KD-tree ordered."""
    pts = grid_points(n, 3)[:n]
    return pts[kd_tree_ordering(pts, tile_size)]


def fractional_diffusion_problem(
    n: int, tile_size: int, *, s: float = 0.75, seed: int = 0
):
    """3D fractional-diffusion-type matrix, KD-tree ordered (section 6.2),
    in numpy; :func:`fractional_diffusion_matrix` of the same points builds
    it on the device."""
    pts = fractional_diffusion_points(n, tile_size)
    return pts, fractional_diffusion(pts, s=s)
