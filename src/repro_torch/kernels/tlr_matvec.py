"""Batched tile chain  ``out[t] = U[t] @ (V[t]^T @ X[t])``.

Port of the Pallas TPU kernel ``tile_chain_pallas`` (``_tile_chain_kernel``,
src/repro/kernels/tlr_matvec.py:23-61). The CUDA kernel is
``csrc/tile_chain.cu``: each block forms ``W = V[t]^T X[t][:, chunk]`` on
chip and writes ``U[t] @ W``, so the intermediate never touches device
memory. In f64 with s > 16 it runs on the FP64 tensor cores, one block per
tile and 128-column chunk with W in registers: for r <= 128 (the
projection chains of ``sample_t``) alone, for 128 < r <= 512 (the
fractional-diffusion preconditioner's factors) as a cluster of two or four
blocks that split the factor columns and add their partial outputs in a
fixed order. f32, bf16, s <= 16 (the W2 hoist) and f64 past r = 512 run
plain FMA loops with W in shared memory. The source chooses by
shape, and :func:`_config` asks it before the launch. What bounds it on the
H100 and what the design does about it is noted in the source.

:func:`tile_chain` launches the kernel for CUDA tensors and runs
:func:`tile_chain_plain` for CPU tensors; there is no fallback between the
two. ``width=`` uses only the first ``width`` factor columns (exact: factor
columns past each tile's rank are zero); the kernel reads them in place.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0  # kernel launches since the last reset (ops.reset_launch_counts)
# launches per (T, b, r, s) shape since the last reset, r the width read
SHAPES: dict[tuple[int, int, int, int], int] = {}

# Kernel configurations, as ``config`` in csrc/tile_chain.cu numbers them.
NARROW, WIDE, DMMA, DMMA_WIDE = 0, 1, 2, 3


def _config(dtype: torch.dtype, r: int, s: int) -> int:
    """The kernel configuration that csrc/tile_chain.cu chooses for factor
    width ``r`` and ``s`` columns: the f64 tensor-core kernels where they
    apply (s > 16; DMMA for r <= 128, DMMA_WIDE for 128 < r <= 512), else
    the FMA kernel with 64-column chunks (s > 16) or 16-column chunks (s <=
    16, or a wide r)."""
    cfg = build.query("tile_chain", "config", dtype, r, s)
    if cfg < 0:
        raise ValueError(f"tile_chain: width {r} too large for the "
                         f"shared-memory intermediate")
    return cfg


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
    cfg = _config(U.dtype, r, s)
    fn = build.entry("tile_chain", U.dtype)
    err = fn(U.data_ptr(), V.data_ptr(), X.data_ptr(), out.data_ptr(),
             T, b, r, ldr, s, cfg, build.stream_handle(U))
    build.check("tile_chain", err)
    LAUNCHES += 1
    SHAPES[(T, b, r, s)] = SHAPES.get((T, b, r, s), 0) + 1
    return out


def tile_chain(U: torch.Tensor, V: torch.Tensor, X: torch.Tensor,
               width: int | None = None) -> torch.Tensor:
    """U, V: (T, b, r), X: (T, b, s) -> (T, b, s)."""
    if U.is_cuda:
        return tile_chain_cuda(U, V, X, width)
    if U.device.type == "cpu":
        return tile_chain_plain(U, V, X, width)
    raise ValueError(f"tile_chain: unsupported device {U.device}")
