"""Batched tile chain  ``out[t] = U[t] @ (V[t]^T @ X[t])``.

Port of the Pallas TPU kernel ``tile_chain_pallas`` (``_tile_chain_kernel``,
src/repro/kernels/tlr_matvec.py:23-61). The CUDA kernel is
``csrc/tile_chain.cu``: grid (T, column chunks); each block forms
``W = V[t]^T X[t][:, chunk]`` in shared memory and writes ``U[t] @ W``, so
the intermediate stays on chip. What bounds it on the H100 and what the
design does about it is noted in the source.

:func:`tile_chain` launches the kernel for CUDA tensors and runs
:func:`tile_chain_plain` for CPU tensors; there is no fallback between the
two. ``width=`` uses only the first ``width`` factor columns (exact: factor
columns past each tile's rank are zero); the kernel reads them in place.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0  # kernel launches since the last reset (ops.reset_launch_counts)

# The 64-column chunk keeps r * 64 accumulator words in shared memory.
_WIDE_SMEM_LIMIT = 160 * 1024


def tile_chain_plain(U: torch.Tensor, V: torch.Tensor, X: torch.Tensor,
                     width: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: the two einsums of ``repro.kernels.ref``.
    bf16 inputs accumulate in float32, as the kernels do."""
    if width is not None and width < U.shape[-1]:
        U, V = U[..., :width], V[..., :width]
    work = torch.float32 if U.dtype == torch.bfloat16 else U.dtype
    out = torch.einsum("tbr,trs->tbs", U.to(work),
                       torch.einsum("tbr,tbs->trs", V.to(work), X.to(work)))
    return out.to(X.dtype)


def tile_chain_cuda(U: torch.Tensor, V: torch.Tensor, X: torch.Tensor,
                    width: int | None = None) -> torch.Tensor:
    """Launch ``csrc/tile_chain.cu`` on the current stream."""
    global LAUNCHES
    T, b, ldr = U.shape
    s = X.shape[-1]
    r = ldr if width is None else min(width, ldr)
    if not (U.is_cuda and V.is_cuda and X.is_cuda):
        raise ValueError("tile_chain_cuda needs CUDA tensors")
    if V.shape != U.shape or X.shape != (T, b, s):
        raise ValueError(f"tile_chain: shapes U{tuple(U.shape)} "
                         f"V{tuple(V.shape)} X{tuple(X.shape)}")
    if V.dtype != U.dtype or X.dtype != U.dtype:
        raise TypeError("tile_chain: U, V and X share a dtype")
    if not (U.is_contiguous() and V.is_contiguous() and X.is_contiguous()):
        raise ValueError("tile_chain: operands must be contiguous")
    out = torch.empty((T, b, s), dtype=U.dtype, device=U.device)
    if out.numel() == 0:
        return out
    acc_bytes = 8 if U.dtype == torch.float64 else 4
    wide = int(s > 16 and r * 64 * acc_bytes <= _WIDE_SMEM_LIMIT)
    if r * 16 * acc_bytes > _WIDE_SMEM_LIMIT:
        raise ValueError(f"tile_chain: width {r} too large for the "
                         f"shared-memory intermediate")
    fn = build.entry("tile_chain", U.dtype)
    err = fn(U.data_ptr(), V.data_ptr(), X.data_ptr(), out.data_ptr(),
             T, b, r, ldr, s, wide, build.stream_handle(U))
    build.check("tile_chain", err)
    LAUNCHES += 1
    return out


def tile_chain(U: torch.Tensor, V: torch.Tensor, X: torch.Tensor,
               width: int | None = None) -> torch.Tensor:
    """U, V: (T, b, r), X: (T, b, s) -> (T, b, s)."""
    if U.is_cuda:
        return tile_chain_cuda(U, V, X, width)
    if U.device.type == "cpu":
        return tile_chain_plain(U, V, X, width)
    raise ValueError(f"tile_chain: unsupported device {U.device}")
