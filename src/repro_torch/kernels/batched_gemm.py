"""Rank-masked batched GEMM  ``C[t] = A[t][:, :rank_t] @ B[t][:rank_t, :]``.

Port of the Pallas TPU kernel ``batched_gemm_pallas`` (``_bgemm_kernel``,
src/repro/kernels/batched_gemm.py:26-63). The CUDA kernel is
``csrc/batched_gemm.cu``: one block per (t, m-tile, n-tile) whose K loop
stops at ``min(rank_t, k)``, so the zero padding past each tile's rank costs
nothing. What bounds it on the H100 (bytes at n = 16, FP64 FLOPs near
n = 128) and what the design does about it is noted in the source.

:func:`batched_gemm` launches the kernel for CUDA tensors and runs
:func:`batched_gemm_plain` for CPU tensors; there is no fallback between
the two.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0  # kernel launches since the last reset (ops.reset_launch_counts)


def batched_gemm_plain(A: torch.Tensor, B: torch.Tensor,
                       ranks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the masked einsum of ``repro.kernels.ref``.
    bf16 inputs accumulate in float32, as the kernels do."""
    k = A.shape[-1]
    work = torch.float32 if A.dtype == torch.bfloat16 else A.dtype
    mask = (torch.arange(k, device=A.device)[None, :]
            < ranks.to(A.device)[:, None]).to(work)
    C = torch.einsum("tmk,tk,tkn->tmn", A.to(work), mask, B.to(work))
    return C.to(A.dtype)


def batched_gemm_cuda(A: torch.Tensor, B: torch.Tensor,
                      ranks: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/batched_gemm.cu`` on the current stream."""
    global LAUNCHES
    T, m, k = A.shape
    n = B.shape[-1]
    if not (A.is_cuda and B.is_cuda and ranks.is_cuda):
        raise ValueError("batched_gemm_cuda needs CUDA tensors")
    if B.shape != (T, k, n) or ranks.shape != (T,):
        raise ValueError(f"batched_gemm: shapes A{tuple(A.shape)} "
                         f"B{tuple(B.shape)} ranks{tuple(ranks.shape)}")
    if B.dtype != A.dtype or ranks.dtype != torch.int32:
        raise TypeError("batched_gemm: A and B share a dtype, ranks is int32")
    if not (A.is_contiguous() and B.is_contiguous()
            and ranks.is_contiguous()):
        raise ValueError("batched_gemm: operands must be contiguous")
    C = torch.empty((T, m, n), dtype=A.dtype, device=A.device)
    if C.numel() == 0:
        return C
    fn = build.entry("batched_gemm", A.dtype)
    err = fn(A.data_ptr(), B.data_ptr(), ranks.data_ptr(), C.data_ptr(),
             T, m, k, n, build.stream_handle(A))
    build.check("batched_gemm", err)
    LAUNCHES += 1
    return C


def batched_gemm(A: torch.Tensor, B: torch.Tensor,
                 ranks: torch.Tensor) -> torch.Tensor:
    """A: (T, m, k), B: (T, k, n), ranks: (T,) int32 -> C: (T, m, n)."""
    if A.is_cuda:
        return batched_gemm_cuda(A, B, ranks)
    if A.device.type == "cpu":
        return batched_gemm_plain(A, B, ranks)
    raise ValueError(f"batched_gemm: unsupported device {A.device}")
