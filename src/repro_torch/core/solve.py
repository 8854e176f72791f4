"""TLR matrix-vector products and triangular solves (section 4.4, Alg. 7),
log-determinant and MVN sampling.

Port of the flat (``batching="flat"``) read paths of ``repro/core/solve.py``
(:47-59, :184-227, :245-478). The matvec marshals the off-diagonal tiles
into one batched two-product chain ``U (V^T x)`` plus a segment reduction
(``index_add_``). The triangular solve is the blocked TRSM of the JAX
package: each column step solves the diagonal block and updates the
remaining blocks through a batched low-rank chain whose row batch is
zero-padded up to the power-of-two bucket ladder, so only ~log2(nb) step
shapes occur. Right-hand sides may be single vectors ``(n,)`` or batched
``(n, m)``.

Only ``batching="flat"`` exists in this port so far; other values raise
(the JAX default is ``"auto"``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .buckets import _bucket_ladder, _bucket_up
from .tlr import TLRMatrix, tril_index, tril_pairs


def _check_batching(batching) -> None:
    if batching not in (None, "flat"):
        raise ValueError(f"batching={batching!r}: only 'flat' is ported "
                         "(ranked/auto need the rank-bucketed TilePlan)")


@lru_cache(maxsize=32)
def _pair_index(nb: int, device: torch.device):
    pairs = torch.as_tensor(tril_pairs(nb), device=device)
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()


def _chain(U, V, x):
    """``U (V^T x)`` per tile; x is (t, b) or (t, b, m)."""
    if x.dim() == 2:
        return (U @ (V.transpose(1, 2) @ x[..., None]))[..., 0]
    return U @ (V.transpose(1, 2) @ x)


def _diag_apply(D, xb, trans: bool = False):
    Dt = D.transpose(1, 2) if trans else D
    if xb.dim() == 2:
        return (Dt @ xb[..., None])[..., 0]
    return Dt @ xb


# -- symmetric TLR matvec ------------------------------------------------------


def tlr_matvec(A: TLRMatrix, x: torch.Tensor, *,
               batching: str | None = "flat") -> torch.Tensor:
    """y = A @ x for symmetric TLR A; x is (n,) or (n, m)."""
    _check_batching(batching)
    nb, b = A.nb, A.b
    xb = x.reshape(nb, b, *x.shape[1:])
    yb = _diag_apply(A.D, xb)
    if nb > 1:
        rows, cols = _pair_index(nb, xb.device)
        # lower tiles: y_i += U (V^T x_j);   mirrored upper: y_j += V (U^T x_i)
        yb.index_add_(0, rows, _chain(A.U, A.V, xb[cols]))
        yb.index_add_(0, cols, _chain(A.V, A.U, xb[rows]))
    return yb.reshape(x.shape)


# -- lower-triangular TLR products / solves -------------------------------------


def tlr_tri_matvec(L: TLRMatrix, x: torch.Tensor, *, trans: bool = False,
                   batching: str | None = "flat") -> torch.Tensor:
    """y = L @ x (or L^T @ x) for lower-triangular TLR L."""
    _check_batching(batching)
    nb, b = L.nb, L.b
    xb = x.reshape(nb, b, *x.shape[1:])
    yb = _diag_apply(L.D, xb, trans)
    if nb > 1:
        rows, cols = _pair_index(nb, xb.device)
        if not trans:
            yb.index_add_(0, rows, _chain(L.U, L.V, xb[cols]))
        else:
            yb.index_add_(0, cols, _chain(L.V, L.U, xb[rows]))
    return yb.reshape(x.shape)


def _trsv_column_tiles(nb: int, k: int, trans: bool):
    """Packed tile indices and target block rows of solve column ``k``."""
    if not trans:
        tgt = np.arange(k + 1, nb)
        tiles = tgt * (tgt - 1) // 2 + k              # tril_index(i, k)
    else:
        tgt = np.arange(k)
        tiles = k * (k - 1) // 2 + tgt                # tril_index(k, j)
    return tiles, tgt


@lru_cache(maxsize=64)
def _trsv_column_steps(nb: int, trans: bool, device: torch.device):
    """Bucket-padded index operands ``(k, tidx, ridx, valid)`` of every
    column step in sweep order, uploaded once per (nb, direction, device)."""
    ladder = _bucket_ladder(nb - 1)
    order = range(nb) if not trans else range(nb - 1, -1, -1)
    steps = []
    for k in order:
        tiles, tgt = _trsv_column_tiles(nb, k, trans)
        T = len(tgt)
        Tb = _bucket_up(max(T, 1), ladder)
        tidx = np.zeros(Tb, np.int64)
        ridx = np.zeros(Tb, np.int64)
        tidx[:T], ridx[:T] = tiles, tgt
        valid = np.zeros(Tb, bool)
        valid[:T] = True
        steps.append((k, torch.as_tensor(tidx, device=device),
                      torch.as_tensor(ridx, device=device),
                      torch.as_tensor(valid, device=device)))
    return tuple(steps)


def _trsm_step(L: TLRMatrix, xb, k, tidx, ridx, valid, trans: bool):
    """One blocked-TRSM column (in place on ``xb``, shape (nb, b, m)):
    solve the diagonal block, then subtract the low-rank update from the
    remaining blocks. Padded slots carry a zero update into block 0."""
    Dk = L.D[k]
    Ut, Vt = L.U[tidx], L.V[tidx]
    if trans:
        # (L^T)(j,k) = L(k,j)^T = V U^T: the U/V roles swap in the update.
        Dk = Dk.T
        Ut, Vt = Vt, Ut
    xk = torch.linalg.solve_triangular(Dk, xb[k], upper=trans)
    upd = Ut @ (Vt.transpose(1, 2) @ xk)
    upd = torch.where(valid[:, None, None], upd, torch.zeros_like(upd))
    xb[k] = xk
    xb.index_add_(0, ridx, -upd)


def tlr_trsv(L: TLRMatrix, y: torch.Tensor, *, trans: bool = False,
             batching: str | None = "flat") -> torch.Tensor:
    """Solve L x = y (trans=False) or L^T x = y (trans=True). Algorithm 7.
    ``y`` is a single right-hand side ``(n,)`` or a batch ``(n, m)``."""
    _check_batching(batching)
    nb, b = L.nb, L.b
    xb = y.reshape(nb, b, -1).clone()
    if nb == 1:
        xb[0] = torch.linalg.solve_triangular(
            L.D[0].T if trans else L.D[0], xb[0], upper=trans)
        return xb.reshape(y.shape)
    for k, tidx, ridx, valid in _trsv_column_steps(nb, trans, xb.device):
        _trsm_step(L, xb, k, tidx, ridx, valid, trans)
    return xb.reshape(y.shape)


def tlr_trsv_reference(L: TLRMatrix, y: torch.Tensor, *,
                       trans: bool = False) -> torch.Tensor:
    """Host-loop TRSV over per-block lists, the parity oracle of
    :func:`tlr_trsv` (the JAX package keeps the same oracle)."""
    nb, b = L.nb, L.b
    yb = y.reshape(nb, b, -1)
    xb = [yb[i].clone() for i in range(nb)]
    order = range(nb) if not trans else range(nb - 1, -1, -1)
    for k in order:
        Dk = L.D[k] if not trans else L.D[k].T
        xk = torch.linalg.solve_triangular(Dk, xb[k], upper=trans)
        xb[k] = xk
        targets = range(k + 1, nb) if not trans else range(k)
        for i in targets:
            t = tril_index(i, k) if not trans else tril_index(k, i)
            U, V = (L.U[t], L.V[t]) if not trans else (L.V[t], L.U[t])
            xb[i] = xb[i] - U @ (V.T @ xk)
    return torch.stack(xb).reshape(y.shape)


def tile_perm_to_element_perm(perm: np.ndarray, b: int) -> np.ndarray:
    return (np.asarray(perm)[:, None] * b + np.arange(b)[None, :]).reshape(-1)


# -- factorization application (implementations behind the handle methods) ----


def _permute_rows(x: torch.Tensor, eperm: np.ndarray) -> torch.Tensor:
    return x[torch.as_tensor(eperm, device=x.device)]


def _unpermute_rows(x: torch.Tensor, eperm: np.ndarray) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[torch.as_tensor(eperm, device=x.device)] = x
    return out


def _factor_solve_impl(fact, y: torch.Tensor) -> torch.Tensor:
    """Solve A x = y given a TLRFactorization (handles perm and LDL)."""
    eperm = tile_perm_to_element_perm(fact.perm, fact.L.b)
    z = tlr_trsv(fact.L, _permute_rows(y, eperm), trans=False)
    if fact.d is not None:
        dflat = fact.d.reshape(-1)
        z = z / dflat.reshape((-1,) + (1,) * (z.dim() - 1))
    z = tlr_trsv(fact.L, z, trans=True)
    return _unpermute_rows(z, eperm)


def _logdet_impl(fact) -> torch.Tensor:
    """log |det A| from the factorization diagonals."""
    if fact.d is not None:
        return torch.log(torch.abs(fact.d)).sum()
    diags = torch.diagonal(fact.L.D, dim1=1, dim2=2)
    return 2.0 * torch.log(torch.abs(diags)).sum()


def _mvn_sample_impl(fact, num: int = 1, *, generator=None,
                     z: torch.Tensor | None = None) -> torch.Tensor:
    """Sample x ~ N(0, A) via x = P^T L z (Cholesky factorizations only).
    ``z`` (n, num) may be given; otherwise it is drawn from ``generator``
    (a ``torch.Generator`` on the factor's device, or the default one)."""
    if fact.d is not None:
        raise ValueError("MVN sampling requires a Cholesky factorization")
    n = fact.L.n
    if z is None:
        z = torch.randn((n, num), generator=generator, dtype=fact.L.dtype,
                        device=fact.L.device)
    x = tlr_tri_matvec(fact.L, z)
    eperm = tile_perm_to_element_perm(fact.perm, fact.L.b)
    out = _unpermute_rows(x, eperm)
    return out[:, 0] if out.shape[1] == 1 else out
