"""Operation and byte counts behind the utilization and roofline metrics.

Work counts of the algorithm (``cholesky_flops``, ``pcg_flops``) take
only the tile ranks of the operator and of the returned factor, so they
count the same work whatever implements it. Kernel counts
(``sampling_call``) take a call's shape and the live rank of every factor
it reads: each input word is counted once, each output word once, and
columns past a factor's live rank, which carry zeros, are not counted.

Ranks are numpy arrays of the packed strictly lower tiles (i, j), i > j,
at ``i (i - 1) / 2 + j``.
"""

from __future__ import annotations

import numpy as np


def tile_grid(ranks: np.ndarray, nb: int) -> np.ndarray:
    """(nb, nb) array R with R[i, j] the rank of tile (i, j), i > j, and
    zero on and above the diagonal."""
    R = np.zeros((nb, nb), dtype=np.float64)
    i, j = np.tril_indices(nb, -1)
    R[i, j] = np.asarray(ranks, dtype=np.float64)
    return R


def ara_samples(r: np.ndarray, bs: int) -> np.ndarray:
    """Samples the adaptive randomized approximation draws to find rank r
    in blocks of bs: the blocks that hold the basis and one more whose
    residual shows convergence."""
    return bs * (np.ceil(r / bs) + 1)


def cholesky_flops(a_ranks, l_ranks, nb: int, b: int, bs: int) -> float:
    """FLOPs of the left-looking ARA Cholesky (Algorithm 5) that end at the
    factor ranks ``l_ranks`` from the operator ranks ``a_ranks``.

    Column k: the diagonal block ``A_kk - sum_j L_kj L_kj^T`` (4 b r^2 + 2
    b^2 r a term) and its Cholesky (b^3 / 3); for each tile i > k, the
    samples ``s`` of its Schur complement ``A_ik - sum_j L_ij L_kj^T`` at
    rank r (``ara_samples``), drawn with one probe block per step shared by
    the column, so ``L_kj^T Omega`` is formed once per column (4 b r_kj s
    for the column's largest s) and each tile applies ``A_ik`` and its own
    ``L_ij`` (4 b s (r_A + sum_j r_ij)); the two Gram-Schmidt passes and
    the QR of each block of bs samples against a basis of q columns (8 b q
    bs + 2 b bs^2); the projection ``S_ik^T Q`` (4 b r (r_A + sum_j (r_ij
    + r_kj))); and the triangular solve with L_kk (b^2 r)."""
    RA, RL = tile_grid(a_ranks, nb), tile_grid(l_ranks, nb)
    rowsum = np.cumsum(RL, axis=1) - RL       # sum_{j < col} RL[i, j]
    total = nb * b**3 / 3.0
    for k in range(nb):
        pre = RL[k, :k]
        total += np.sum(4.0 * b * pre**2 + 2.0 * b * b * pre)
        if k == nb - 1:
            continue
        r = RL[k + 1:, k]
        ra = RA[k + 1:, k]
        own = rowsum[k + 1:, k]
        s = ara_samples(r, bs)
        blocks = s / bs
        total += 4.0 * b * s.max() * pre.sum()
        total += np.sum(4.0 * b * s * (ra + own))
        total += np.sum(8.0 * b * bs * bs * blocks * (blocks - 1) / 2
                        + 2.0 * b * bs * bs * blocks)
        total += np.sum(4.0 * b * r * (ra + own + pre.sum()))
        total += np.sum(b * b * r)
    return float(total)


def matvec_flops(ranks, nb: int, b: int) -> float:
    """y = A x with a symmetric TLR A: the dense diagonal tiles and each
    lower tile applied both ways."""
    return 2.0 * nb * b * b + 8.0 * b * float(np.sum(ranks))


def trsv_flops(ranks, nb: int, b: int) -> float:
    """One triangular solve with a TLR factor: the diagonal blocks and one
    application of each lower tile."""
    return nb * b * b + 4.0 * b * float(np.sum(ranks))


def pcg_flops(a_ranks, l_ranks, nb: int, b: int, iterations: int) -> float:
    """Preconditioned CG: the initial residual and preconditioning, then per
    iteration one matvec with A, two triangular solves with L and the
    vector updates (two dots, a norm, three axpys)."""
    n = nb * b
    per = (matvec_flops(a_ranks, nb, b) + 2 * trsv_flops(l_ranks, nb, b)
           + 12.0 * n)
    return (iterations + 1) * per


# -- the sampling kernels, per call -------------------------------------------


def sampling_call(kind: str, shape: tuple, live) -> tuple[float, float]:
    """(words, flops) a call needs at the live ranks ``live``.

    ``tile_chain`` (T, b, r, s): out[t] = U[t] (V[t]^T X[t]), live (T,);
    ``lr_sample`` (T, J, b, r, s): Y[t] = sum_j U[t, j] (V[t, j]^T W[j]),
    live (T, J); ``batched_gemm`` (T, m, k, n): C[t] = A[t][:, :r_t]
    B[t][:r_t], live (T,) clamped to [0, k]."""
    live = np.asarray(live, dtype=np.float64)
    if kind == "tile_chain":
        T, b, _, s = shape
        R = live.sum()
        return 2 * b * R + 2 * T * b * s, 4.0 * b * s * R
    if kind == "lr_sample":
        T, J, b, _, s = shape
        R = live.sum()
        return 2 * b * R + J * b * s + T * b * s, 4.0 * b * s * R
    if kind == "batched_gemm":
        T, m, k, n = shape
        R = np.clip(live, 0, k).sum()
        return m * R + n * R + T * m * n, 2.0 * m * n * R
    raise ValueError(f"unknown sampling kernel {kind!r}")


def bound_seconds(words: float, flops: float, itemsize: int,
                  peak_flops: float, peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory bandwidth and the operations over the peak rate."""
    return max(words * itemsize / peak_bytes, flops / peak_flops)

