"""Dense reference oracles for validating the TLR algorithms.

Own copy of ``repro/core/dense_ref.py`` (numpy; the port imports nothing
of ``repro``), except that :func:`spectral_norm_est_op` applies a torch
matvec: its start vector is still drawn with numpy from ``seed``, as the
JAX package draws it, so both packages run the same power iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def dense_cholesky(A: np.ndarray) -> np.ndarray:
    return np.linalg.cholesky(np.asarray(A))


def dense_ldlt(A: np.ndarray):
    """Unpivoted LDL^T (textbook column algorithm), for modest n."""
    A = np.asarray(A, dtype=np.float64)
    n = A.shape[0]
    L = np.eye(n)
    d = np.zeros(n)
    for j in range(n):
        d[j] = A[j, j] - (L[j, :j] ** 2) @ d[:j]
        if j + 1 < n:
            L[j + 1:, j] = (A[j + 1:, j]
                            - L[j + 1:, :j] @ (d[:j] * L[j, :j])) / d[j]
    return L, d


def blocked_cholesky_left(A: np.ndarray, b: int) -> np.ndarray:
    """Dense left-looking tiled Cholesky (Algorithm 3), no compression:
    a step-for-step mirror of the paper's Algorithm 3."""
    A = np.array(A, dtype=np.float64, copy=True)
    n = A.shape[0]
    assert n % b == 0
    nb = n // b

    def blk(M, i, j):
        return M[i * b:(i + 1) * b, j * b:(j + 1) * b]

    L = np.zeros_like(A)
    for k in range(nb):
        acc = blk(A, k, k).copy()
        for j in range(k):
            acc -= blk(L, k, j) @ blk(L, k, j).T
        Lkk = np.linalg.cholesky(acc)
        L[k * b:(k + 1) * b, k * b:(k + 1) * b] = Lkk
        for i in range(k + 1, nb):
            upd = blk(A, i, k).copy()
            for j in range(k):
                upd -= blk(L, i, j) @ blk(L, k, j).T
            # solve X Lkk^T = upd  =>  X = (Lkk^{-1} upd^T)^T
            L[i * b:(i + 1) * b, k * b:(k + 1) * b] = np.linalg.solve(
                Lkk, upd.T).T
    return L


def spectral_norm_est(A, n_iter: int = 30, seed: int = 0) -> float:
    """2-norm estimate of a dense ndarray by power iteration on A^T A
    (the paper verifies ||A - LL^T|| this way); for an operator use
    :func:`spectral_norm_est_op`."""
    if callable(A):
        raise TypeError("pass (matvec, n) via spectral_norm_est_op for "
                        "callables")
    A = np.asarray(A)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[1])
    x /= np.linalg.norm(x)
    sigma = 0.0
    for _ in range(n_iter):
        y = A @ x
        y = A.T @ y
        nrm = np.linalg.norm(y)
        if nrm == 0:
            return 0.0
        x = y / nrm
        sigma = np.sqrt(nrm)
    return float(sigma)


def spectral_norm_est_op(matvec, n: int, n_iter: int = 30, seed: int = 0,
                         *, device=None, dtype=torch.float64) -> float:
    """Power-iteration 2-norm estimate for a symmetric operator: ``matvec``
    maps an (n,) tensor on ``device`` (the card by default) to one. One
    host read per iteration (the norm)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x /= np.linalg.norm(x)
    x = torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
    lam = 0.0
    for _ in range(n_iter):
        y = matvec(x)
        nrm = float(torch.linalg.norm(y))
        if nrm == 0:
            return 0.0
        lam = nrm
        x = y / nrm
    return float(lam)
