"""Batched SVD of small cores by one-sided Jacobi rotations.

Port of the Pallas TPU kernel ``small_svd_pallas`` (``_jacobi_svd_kernel``,
src/repro/kernels/small_svd.py:33-100). ``M (T, m, n), n <= m -> U (T, m,
n), s (T, n), V (T, n, n)`` with ``M = U diag(s) V^T`` -- V, not V^H -- and
the values *unsorted*; ``ops.small_svd`` sorts them descending. 8 sweeps;
the angle is ``theta = atan2(2 gamma, alpha - beta) / 2``, whose cosine and
sine :func:`rotation` computes without trigonometry; a rotation is skipped
when ``|gamma| <= tiny``, and U columns with ``s <= tiny`` are zeroed.

The rotations are those of the TPU kernel, in its row-cyclic order
(``(0,1), (0,2), ..., (0,n-1), (1,2), ...`` each sweep), regrouped into
*wavefront stages* (:func:`stages`): pair (p, q) of sweep k runs at stage
``k (2n - 1) + 2p + q``. Two pairs of one stage share no column, and every
pair that shares a column with (p, q) and comes before it in row-cyclic
order sits in an earlier stage, so running the stages in order does exactly
the row-cyclic rotations; only the summation order of the three dot
products differs. The CUDA kernel (``csrc/small_svd.cu``) rotates a stage's
pairs at once; the plain version runs the same stages vectorised over the
pairs, with the same angle formula. (A round-robin tournament order, with
n / 2 pairs in each of n - 1 rounds, needed about 16 sweeps to converge on
the graded R factors of the rounding pass where row-cyclic needs 8, and so
changed ranks.) What bounds the kernel on the H100 and what its design does
about it is noted in the source.

:func:`small_svd` launches the kernel for CUDA tensors and runs
:func:`small_svd_plain` for CPU tensors; there is no fallback between the
two.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import build

LAUNCHES = 0  # kernel launches since the last reset (ops.reset_launch_counts)
# launches per (T, m, n) shape since the last reset
SHAPES: dict[tuple[int, int, int], int] = {}

SWEEPS = 8


def stages(n: int, sweeps: int = 1) -> list[tuple[list[int], list[int]]]:
    """The wavefront stages of ``sweeps`` sweeps: pair (p, q), p < q, of
    sweep k at stage ``k (2n - 1) + 2p + q``, as (p list, q list) per stage
    1 .. ``(sweeps - 1)(2n - 1) + 3n - 5``. With the offset ``2n - 1``
    sweep k + 1 reaches each column at least two stages after sweep k's
    last use of it, as pairs (p - 1, q) and (p, q) of one sweep are; only a
    row's own consecutive pairs (p, q), (p, q + 1) are one stage apart. The
    CUDA kernel runs the same stages."""
    if n < 2 or sweeps < 1:
        return []
    offset = 2 * n - 1
    out = []
    for t in range(1, (sweeps - 1) * offset + 3 * n - 4):
        ps, qs = [], []
        for k in range(max(0, (t - 3 * n + 5 + offset - 1) // offset),
                       min(sweeps - 1, (t - 1) // offset) + 1):
            tk = t - k * offset
            for p in range(max(0, -(-(tk - (n - 1)) // 2)), (tk - 1) // 3 + 1):
                ps.append(p)
                qs.append(tk - 2 * p)
        out.append((ps, qs))
    return out


@lru_cache(maxsize=None)
def _stage_index(n: int, sweeps: int, device: torch.device):
    return [(torch.tensor(p, dtype=torch.long, device=device),
             torch.tensor(q, dtype=torch.long, device=device))
            for p, q in stages(n, sweeps) if p]


def rotation(alpha: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor):
    """``(c, s) = (cos theta, sin theta)`` of ``theta = atan2(2 gamma, alpha
    - beta) / 2`` in (-pi/2, pi/2], without trigonometry, and ``(1, 0)``
    where ``|gamma| <= tiny`` (the rotation is skipped). With ``x = alpha -
    beta``, ``y = 2 gamma``, ``rho = hypot(x, y)``, ``u = x / rho``, ``v = y
    / rho``: ``c = sqrt((1 + u) / 2)``, ``s = (v / 2) / c`` for x >= 0, else
    ``s = copysign(sqrt((1 - u) / 2), v)``, ``c = (v / 2) / s``. Each
    branch adds or subtracts two numbers of one sign, so neither cancels;
    c >= 0. The CUDA kernel evaluates the same expressions.

    ``rho`` is ``max(|x|, |y|) sqrt(1 + q^2)``, ``q = min / max``, from
    correctly rounded operations only (the CUDA kernel has no hypot
    either): ``torch.hypot``'s vectorised and scalar loops on the CPU
    round differently in the last place, so a tile's rotations would
    depend on its position in the batch, and the sharded right driver,
    whose ranks each round their own block of tiles, would not reproduce
    the single-device factor bit for bit."""
    tiny = torch.finfo(alpha.dtype).tiny
    x, y = alpha - beta, 2.0 * gamma
    ax, ay = x.abs(), y.abs()
    big = torch.maximum(ax, ay)
    q = torch.minimum(ax, ay) / big
    rho = big * torch.sqrt(q * q + 1.0)
    u, v = x / rho, y / rho
    c_pos = torch.sqrt(0.5 + 0.5 * u)
    s_neg = torch.copysign(torch.sqrt(0.5 - 0.5 * u), v)
    pos = x >= 0
    c = torch.where(pos, c_pos, 0.5 * v / s_neg)
    s = torch.where(pos, 0.5 * v / c_pos, s_neg)
    live = gamma.abs() > tiny
    return torch.where(live, c, 1.0), torch.where(live, s, 0.0)


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
    for pi, qi in _stage_index(n, sweeps, M.device):
        ap, aq = A[:, :, pi], A[:, :, qi]                       # (T, m, P)
        c, s = rotation((ap * ap).sum(dim=1), (aq * aq).sum(dim=1),
                        (ap * aq).sum(dim=1))                   # (T, P)
        c, s = c[:, None, :], s[:, None, :]
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
    # The kernel's source decides the path and its device workspace: the
    # persistent blocks' rotation logs (m <= 128), or the working matrices
    # of cores too large for shared memory.
    words = build.query("small_svd", "workspace", M.dtype, T, m, n, sweeps)
    work = M.new_empty(words) if words else None
    fn = build.entry("small_svd", M.dtype)
    err = fn(M.data_ptr(), U.data_ptr(), s.data_ptr(), V.data_ptr(),
             0 if work is None else work.data_ptr(), T, m, n, sweeps,
             build.stream_handle(M))
    build.check("small_svd", err)
    LAUNCHES += 1
    SHAPES[(T, m, n)] = SHAPES.get((T, m, n), 0) + 1
    return U, s, V


def small_svd_unsorted(M: torch.Tensor):
    """M: (T, m, n), n <= m -> (U, s, V), values unsorted."""
    if M.is_cuda:
        return small_svd_cuda(M)
    if M.device.type == "cpu":
        return small_svd_plain(M)
    raise ValueError(f"small_svd: unsupported device {M.device}")
