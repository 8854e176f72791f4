"""Fused low-rank update-chain sampling
``Y[t] = sum_j U[t, j] @ (V[t, j]^T @ W2[j])`` (the Eq. 2 hot spot).

Port of the Pallas TPU kernel ``lr_sample_pallas`` (``_lr_sample_kernel``,
src/repro/kernels/lr_sample.py:36-93). The CUDA kernel is
``csrc/lr_sample.cu``. In f64 with r <= 512 it runs on the FP64 tensor
cores (r <= 128 for every call of the main path; up to 512 for the
fractional-diffusion preconditioner's factors): a block takes one row tile
t and a group of j, forms each ``V[t, j]^T W2[j]`` once on chip and keeps
the group's sum in registers; the source splits j into groups so that the
grid fills the card, and a second pass adds the groups' partials in a
fixed order. f32, bf16 and f64 past r = 512 run plain FMA loops with the j
axis a loop inside each block. The source chooses by shape, and
:func:`_config` asks it before the launch; what bounds the kernel on the
H100 and what the design does about it is noted in the source.

:func:`lr_sample` launches the kernel for CUDA tensors and runs
:func:`lr_sample_plain` for CPU tensors; there is no fallback between the
two. ``k == 0`` (no prior columns) returns zeros, and ``width=`` uses only
the first ``width`` factor columns.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0  # kernel launches since the last reset (ops.reset_launch_counts)
# launches per (T, J, r) shape since the last reset: the column buckets of
# the left-looking factorization at the width the kernel reads
SHAPES: dict[tuple[int, int, int], int] = {}

# Kernel configurations, as ``config`` in csrc/lr_sample.cu numbers them.
FMA, DMMA, DMMA_WIDE = 0, 1, 2


def _config(dtype: torch.dtype, r: int, s: int) -> int:
    """The kernel configuration that csrc/lr_sample.cu chooses for factor
    width ``r`` and ``s`` columns: the f64 tensor-core kernels for r <= 128
    (DMMA) and 128 < r <= 512 (DMMA_WIDE), else the FMA kernel while its
    shared-memory intermediate fits."""
    cfg = build.query("lr_sample", "config", dtype, r, s)
    if cfg < 0:
        raise ValueError(f"lr_sample: width {r} too large for the "
                         f"shared-memory intermediate")
    return cfg


def lr_sample_plain(Ui: torch.Tensor, Vi: torch.Tensor, W2: torch.Tensor,
                    width: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: the two einsums of ``repro.kernels.ref``.
    bf16 inputs accumulate in float32, as the kernels do."""
    if width is not None and width < Ui.shape[-1]:
        Ui, Vi = Ui[..., :width], Vi[..., :width]
    T, k, b, _ = Ui.shape
    s = W2.shape[-1]
    if k == 0:
        return torch.zeros((T, b, s), dtype=Ui.dtype, device=Ui.device)
    work = torch.float32 if Ui.dtype == torch.bfloat16 else Ui.dtype
    T3 = torch.einsum("tjbr,jbs->tjrs", Vi.to(work), W2.to(work))
    return torch.einsum("tjbr,tjrs->tbs", Ui.to(work), T3).to(Ui.dtype)


def lr_sample_cuda(Ui: torch.Tensor, Vi: torch.Tensor, W2: torch.Tensor,
                   width: int | None = None) -> torch.Tensor:
    """Launch ``csrc/lr_sample.cu`` on the current stream."""
    global LAUNCHES
    T, k, b, ldr = Ui.shape
    s = W2.shape[-1]
    r = ldr if width is None else min(width, ldr)
    if not (Ui.is_cuda and Vi.is_cuda and W2.is_cuda):
        raise ValueError("lr_sample_cuda needs CUDA tensors")
    if Vi.shape != Ui.shape or W2.shape != (k, b, s):
        raise ValueError(f"lr_sample: shapes Ui{tuple(Ui.shape)} "
                         f"Vi{tuple(Vi.shape)} W2{tuple(W2.shape)}")
    if Vi.dtype != Ui.dtype or W2.dtype != Ui.dtype:
        raise TypeError("lr_sample: Ui, Vi and W2 share a dtype")
    if not (Ui.is_contiguous() and Vi.is_contiguous()
            and W2.is_contiguous()):
        raise ValueError("lr_sample: operands must be contiguous")
    if k == 0:
        return torch.zeros((T, b, s), dtype=Ui.dtype, device=Ui.device)
    Y = torch.empty((T, b, s), dtype=Ui.dtype, device=Ui.device)
    if Y.numel() == 0:
        return Y
    cfg = _config(Ui.dtype, r, s)
    words = build.query("lr_sample", "workspace", Ui.dtype, T, k, b, r, s)
    work = (torch.empty(words, dtype=Ui.dtype, device=Ui.device)
            if words else None)
    fn = build.entry("lr_sample", Ui.dtype)
    err = fn(Ui.data_ptr(), Vi.data_ptr(), W2.data_ptr(), Y.data_ptr(),
             None if work is None else work.data_ptr(),
             T, k, b, r, ldr, s, cfg, build.stream_handle(Ui))
    build.check("lr_sample", err)
    LAUNCHES += 1
    SHAPES[(T, k, r)] = SHAPES.get((T, k, r), 0) + 1
    return Y


def lr_sample(Ui: torch.Tensor, Vi: torch.Tensor, W2: torch.Tensor,
              width: int | None = None) -> torch.Tensor:
    """Ui, Vi: (T, k, b, r), W2: (k, b, s) -> Y: (T, b, s)."""
    if Ui.is_cuda:
        return lr_sample_cuda(Ui, Vi, W2, width)
    if Ui.device.type == "cpu":
        return lr_sample_plain(Ui, Vi, W2, width)
    raise ValueError(f"lr_sample: unsupported device {Ui.device}")
