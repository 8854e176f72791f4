"""Batched SVD of small cores by one-sided Jacobi rotations.

Port of the Pallas TPU kernel ``small_svd_pallas`` (``_jacobi_svd_kernel``,
src/repro/kernels/small_svd.py:33-100). ``M (T, m, n), n <= m -> U (T, m,
n), s (T, n), V (T, n, n)`` with ``M = U diag(s) V^T`` -- V, not V^H -- and
the values *unsorted*; ``ops.small_svd`` sorts them descending. 8 sweeps;
the angle is ``atan2(2 gamma, alpha - beta) / 2``, a rotation is skipped
when ``|gamma| <= tiny``, and U columns with ``s <= tiny`` are zeroed.

The rotations are those of the TPU kernel, in its row-cyclic order
(``(0,1), (0,2), ..., (0,n-1), (1,2), ...`` each sweep), regrouped into
*wavefront stages*: stage ``t`` holds the pairs with ``2p + q = t``. Two
pairs of one stage share no column, and every pair that shares a column
with (p, q) and comes before it in row-cyclic order sits in an earlier
stage, so running the stages in order does exactly the row-cyclic
rotations; only the summation order of the three dot products differs. The
CUDA kernel (``csrc/small_svd.cu``) rotates a stage's pairs at once, one
warp per pair; the plain version runs the same stages vectorised over the
pairs. (A round-robin tournament order, with n / 2 pairs in each of n - 1
rounds, needed about 16 sweeps to converge on the graded R factors of the
rounding pass where row-cyclic needs 8, and so changed ranks.) What bounds
the kernel on the H100 and what its design does about it is noted in the
source.

:func:`small_svd` launches the kernel for CUDA tensors and runs
:func:`small_svd_plain` for CPU tensors; there is no fallback between the
two.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import build

LAUNCHES = 0  # kernel launches since the last reset (ops.reset_launch_counts)

SWEEPS = 8


def wavefront_stages(n: int) -> list[tuple[list[int], list[int]]]:
    """The stages of one sweep: per stage ``t = 1 .. 3n - 5``, the pairs
    (p, q), p < q, with ``2p + q = t``, as (p list, q list). The CUDA kernel
    enumerates the same pairs."""
    stages = []
    for t in range(1, 3 * n - 4):
        lo, hi = max(0, -(-(t - (n - 1)) // 2)), (t - 1) // 3
        ps = list(range(lo, hi + 1))
        stages.append((ps, [t - 2 * p for p in ps]))
    return stages


@lru_cache(maxsize=None)
def _stage_index(n: int, device: torch.device):
    return [(torch.tensor(p, dtype=torch.long, device=device),
             torch.tensor(q, dtype=torch.long, device=device))
            for p, q in wavefront_stages(n) if p]


def _check(M: torch.Tensor) -> None:
    if M.dim() != 3:
        raise ValueError(f"small_svd: M must be (T, m, n), got "
                         f"{tuple(M.shape)}")
    m, n = M.shape[1], M.shape[2]
    if n > m:
        raise ValueError(f"small_svd needs n <= m, got m={m}, n={n}; "
                         "transpose the core first")
    if M.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"small_svd: dtype {M.dtype} not supported "
                        "(float64, float32)")


def small_svd_plain(M: torch.Tensor, sweeps: int = SWEEPS):
    """Plain PyTorch version: the kernel's Jacobi sweeps, each wavefront
    stage's rotations applied at once. Returns unsorted (U, s, V)."""
    _check(M)
    T, m, n = M.shape
    tiny = torch.finfo(M.dtype).tiny
    A = M.clone()
    V = torch.eye(n, dtype=M.dtype, device=M.device).expand(T, n, n).clone()
    for _ in range(sweeps):
        for pi, qi in _stage_index(n, M.device):
            ap, aq = A[:, :, pi], A[:, :, qi]                   # (T, m, P)
            alpha = (ap * ap).sum(dim=1)
            beta = (aq * aq).sum(dim=1)
            gamma = (ap * aq).sum(dim=1)                        # (T, P)
            theta = 0.5 * torch.atan2(2.0 * gamma, alpha - beta)
            live = gamma.abs() > tiny
            c = torch.where(live, torch.cos(theta), 1.0)[:, None, :]
            s = torch.where(live, torch.sin(theta), 0.0)[:, None, :]
            A[:, :, pi], A[:, :, qi] = c * ap + s * aq, -s * ap + c * aq
            vp, vq = V[:, :, pi], V[:, :, qi]
            V[:, :, pi], V[:, :, qi] = c * vp + s * vq, -s * vp + c * vq
    s = A.square().sum(dim=1).sqrt()
    U = A / s.clamp(min=tiny)[:, None, :]
    U = torch.where(s[:, None, :] > tiny, U, torch.zeros_like(U))
    return U, s, V


def small_svd_cuda(M: torch.Tensor, sweeps: int = SWEEPS):
    """Launch ``csrc/small_svd.cu`` on the current stream; unsorted."""
    global LAUNCHES
    _check(M)
    if not M.is_cuda:
        raise ValueError("small_svd_cuda needs a CUDA tensor")
    if not M.is_contiguous():
        raise ValueError("small_svd: M must be contiguous")
    T, m, n = M.shape
    U = torch.empty_like(M)
    s = M.new_empty((T, n))
    V = M.new_empty((T, n, n))
    if U.numel() == 0:
        return U, s, V
    # The kernel's source decides whether the working matrix fits in shared
    # memory.
    words = build.scratch_words("small_svd", M.dtype, m, n)
    work = M.new_empty((T, words)) if words else None
    fn = build.entry("small_svd", M.dtype)
    err = fn(M.data_ptr(), U.data_ptr(), s.data_ptr(), V.data_ptr(),
             0 if work is None else work.data_ptr(), T, m, n, sweeps,
             build.stream_handle(M))
    build.check("small_svd", err)
    LAUNCHES += 1
    return U, s, V


def small_svd_unsorted(M: torch.Tensor):
    """M: (T, m, n), n <= m -> (U, s, V), values unsorted."""
    if M.is_cuda:
        return small_svd_cuda(M)
    if M.device.type == "cpu":
        return small_svd_plain(M)
    raise ValueError(f"small_svd: unsupported device {M.device}")
