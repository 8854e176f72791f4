"""Plain reference: judges a TLR factor and a solution against the operator
the benchmark built, and, in float32, stands in for the program as the
control that the judgement must reject.

An operator or a factor is a dict of tensors: ``D`` (nb, b, b) dense
diagonal tiles and ``U``, ``V`` (nt, b, r), ``ranks`` (nt,) of the strictly
lower tiles (i, j), i > j, packed at ``i (i - 1) / 2 + j``; a tile is
``U[:, :rank] V[:, :rank]^T`` (columns past the rank are not read). An
operator is symmetric; a factor is block lower triangular with its
diagonal blocks in ``D``.

The factor is judged tile by tile. With ``Ld`` the factor made dense, each
block row ``i`` of ``L L^T`` is one product ``Ld[rows_i, :w] Ld[:w, :w]^T``
(w = (i + 1) b) against block row ``i`` of the operator (with a diagonal
shift where the factorization was of ``A + shift I``, and permuted by the
factorization's tile permutation). The numbers are the largest Frobenius
norm of the residual in a diagonal tile and in an off-diagonal tile.
"""

from __future__ import annotations

import numpy as np
import torch


def _pair_index(I: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    return I * (I - 1) // 2 + J


def row_tiles(M: dict, i: int, cols: torch.Tensor) -> torch.Tensor:
    """Tiles (i, j) of the symmetric operator M for j in ``cols`` (none
    equal to i): (len(cols), b, b)."""
    I = torch.full_like(cols, i)
    lo = cols < i
    hi_i, hi_j = torch.where(lo, I, cols), torch.where(lo, cols, I)
    idx = _pair_index(hi_i, hi_j)
    r = M["U"].shape[-1]
    live = (torch.arange(r, device=cols.device)[None, :]
            < M["ranks"][idx].to(cols.device)[:, None])
    U = M["U"][idx].to(M["D"].dtype) * live[:, None, :]
    V = M["V"][idx].to(M["D"].dtype)
    tiles = U @ V.transpose(1, 2)
    return torch.where(lo[:, None, None], tiles, tiles.transpose(1, 2))


def operator_row(A: dict, i: int, perm: np.ndarray, shift: float
                 ) -> torch.Tensor:
    """Block row i, tiles 0..i, of P (A + shift I) P^T for the tile
    permutation ``perm`` (logical -> original): (i + 1, b, b)."""
    p = torch.as_tensor(perm[:i + 1], device=A["D"].device)
    pi = int(perm[i])
    out = torch.empty((i + 1,) + tuple(A["D"].shape[1:]), dtype=A["D"].dtype,
                      device=A["D"].device)
    if i:
        out[:i] = row_tiles(A, pi, p[:i])
    out[i] = A["D"][pi]
    if shift:
        torch.diagonal(out[i]).add_(shift)
    return out


def lower_dense(L: dict) -> torch.Tensor:
    """The block lower triangular factor L as a dense (n, n) matrix."""
    D = L["D"]
    nb, b = D.shape[0], D.shape[1]
    Ld = D.new_zeros((nb * b, nb * b))
    for i in range(nb):
        rows = slice(i * b, (i + 1) * b)
        Ld[rows, i * b:(i + 1) * b] = D[i]
        if i:
            idx = _pair_index(torch.full((i,), i, device=D.device),
                              torch.arange(i, device=D.device))
            r = L["U"].shape[-1]
            live = (torch.arange(r, device=D.device)[None, :]
                    < L["ranks"][idx][:, None])
            tiles = (L["U"][idx].to(D.dtype) * live[:, None, :]) @ \
                L["V"][idx].to(D.dtype).transpose(1, 2)
            Ld[rows, :i * b] = tiles.permute(1, 0, 2).reshape(b, i * b)
    return Ld


def factor_residuals(A: dict, Ld: torch.Tensor, *, perm=None,
                     shift: float = 0.0) -> dict:
    """``diag_abs`` and ``offdiag_abs``: the largest Frobenius norm of a
    diagonal and of an off-diagonal tile of E = P (A + shift I) P^T - L L^T,
    ``Ld`` the dense factor (any float dtype; judged in A's)."""
    nb, b = A["D"].shape[0], A["D"].shape[1]
    perm = np.arange(nb) if perm is None else np.asarray(perm)
    Ld = Ld.to(A["D"].dtype)
    diag, off = 0.0, 0.0
    for i in range(nb):
        w = (i + 1) * b
        P = Ld[i * b:w, :w] @ Ld[:w, :w].T                   # (b, w)
        Arow = operator_row(A, i, perm, shift)               # (i+1, b, b)
        E = Arow - P.reshape(b, i + 1, b).transpose(0, 1)
        norms = torch.nan_to_num(torch.linalg.vector_norm(E, dim=(1, 2)),
                                 nan=float("inf"))
        diag = max(diag, float(norms[i]))
        if i:
            off = max(off, float(norms[:i].max()))
    return {"diag_abs": diag, "offdiag_abs": off}


def matvec(A: dict, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the symmetric operator A, x of shape (n,)."""
    D = A["D"]
    nb, b = D.shape[0], D.shape[1]
    xb = x.reshape(nb, b).to(D.dtype)
    y = torch.einsum("kab,kb->ka", D, xb)
    if nb > 1:
        i, j = np.tril_indices(nb, -1)
        I = torch.as_tensor(i, device=D.device)
        J = torch.as_tensor(j, device=D.device)
        r = A["U"].shape[-1]
        live = (torch.arange(r, device=D.device)[None, :]
                < A["ranks"][:, None]).to(D.dtype)
        U, V = A["U"].to(D.dtype), A["V"].to(D.dtype)
        t = torch.einsum("tbr,tb->tr", V, xb[J]) * live
        y.index_add_(0, I, torch.einsum("tbr,tr->tb", U, t))
        t = torch.einsum("tbr,tb->tr", U, xb[I]) * live
        y.index_add_(0, J, torch.einsum("tbr,tr->tb", V, t))
    return y.reshape(-1)


def relative_residual(A: dict, x: torch.Tensor, rhs: torch.Tensor) -> float:
    """||A x - rhs|| / ||rhs|| in A's precision."""
    rhs = rhs.to(A["D"].dtype)
    r = torch.linalg.vector_norm(matvec(A, x) - rhs) / \
        torch.linalg.vector_norm(rhs)
    return float(torch.nan_to_num(r, nan=float("inf")))


# -- the control: the reference in the program's place, one precision down ---


def dense(A: dict, dtype: torch.dtype, shift: float = 0.0) -> torch.Tensor:
    """A + shift I as a dense (n, n) matrix of ``dtype``, built a block row
    at a time (lower triangle and diagonal blocks only)."""
    nb, b = A["D"].shape[0], A["D"].shape[1]
    M = torch.zeros((nb * b, nb * b), dtype=dtype, device=A["D"].device)
    ident = np.arange(nb)
    for i in range(nb):
        row = operator_row(A, i, ident, shift)
        M[i * b:(i + 1) * b, :(i + 1) * b] = \
            row.transpose(0, 1).reshape(b, (i + 1) * b).to(dtype)
    return M


def blocked_cholesky_(M: torch.Tensor, block: int) -> torch.Tensor:
    """Right-looking blocked Cholesky of the lower triangle of M, in place
    in M's precision; returns the lower triangular factor (M itself, its
    strict upper triangle zeroed)."""
    n = M.shape[0]
    for k0 in range(0, n, block):
        k1 = min(n, k0 + block)
        M[k0:k1, k0:k1] = torch.linalg.cholesky(M[k0:k1, k0:k1])
        if k1 < n:
            L11 = M[k0:k1, k0:k1]
            M[k1:, k0:k1] = torch.linalg.solve_triangular(
                L11, M[k1:, k0:k1].T, upper=False).T
            L21 = M[k1:, k0:k1]
            M[k1:, k1:].addmm_(L21, L21.T, alpha=-1.0)
    return M.tril_()


def control_factor(A: dict, dtype: torch.dtype, shift: float = 0.0,
                   block: int = 4096) -> torch.Tensor:
    """The dense Cholesky factor of A + shift I computed in ``dtype``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return blocked_cholesky_(dense(A, dtype, shift), block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def control_pcg(A: dict, L: torch.Tensor, rhs: torch.Tensor, *, tol: float,
                maxiter: int):
    """PCG on A x = rhs in L's precision, preconditioned by the dense
    factor L (two triangular solves), stopping at a recurrence residual
    below ``tol``: (x, iterations, the last recurrence residual over
    ||rhs||)."""
    dt = L.dtype
    Ac = {"D": A["D"].to(dt), "U": A["U"].to(dt), "V": A["V"].to(dt),
          "ranks": A["ranks"]}

    def precond(r):
        y = torch.linalg.solve_triangular(L, r[:, None], upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]

    b = rhs.to(dt)
    bnorm = torch.linalg.vector_norm(b)
    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z.clone()
    rz = torch.dot(r, z)
    it, rel = 0, 1.0
    while it < maxiter:
        Ap = matvec(Ac, p)
        alpha = rz / torch.dot(p, Ap)
        x += alpha * p
        r -= alpha * Ap
        it += 1
        rel = float(torch.linalg.vector_norm(r) / bnorm)
        if rel < tol:
            break
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, it, rel
