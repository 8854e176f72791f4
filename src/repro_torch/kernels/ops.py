"""Dispatch layer of the port's kernels (counterpart of
``repro/kernels/ops.py:81-139``).

Dispatch is by tensor device: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs the kernel's plain PyTorch version, and anything
else raises. There is no ``impl`` knob and no fallback: a CUDA tensor whose
kernel cannot build or launch raises.
"""

from __future__ import annotations

import torch

from . import batched_gemm as _bg
from . import batched_qr as _qr
from . import lr_sample as _lr
from . import small_svd as _svd
from . import tlr_matvec as _tc
from .batched_gemm import batched_gemm
from .batched_qr import batched_qr
from .lr_sample import lr_sample
from .tlr_matvec import tile_chain

__all__ = ["batched_gemm", "batched_qr", "launch_counts", "lr_sample",
           "reset_launch_counts", "small_svd", "tile_chain"]

KERNELS = {"batched_gemm": _bg, "tile_chain": _tc, "lr_sample": _lr,
           "batched_qr": _qr, "small_svd": _svd}


def small_svd(M: torch.Tensor):
    """Batched small-core SVD (T, m, n) -> (U, s, V), M ~= U diag(s) V^T,
    singular values sorted descending (the rounding pass truncates on that
    order); the Jacobi kernel leaves them unsorted."""
    U, s, V = _svd.small_svd_unsorted(M)
    order = torch.argsort(s, dim=-1, descending=True, stable=True)
    s = torch.take_along_dim(s, order, dim=-1)
    U = torch.take_along_dim(U, order[:, None, :], dim=-1)
    V = torch.take_along_dim(V, order[:, None, :], dim=-1)
    return U, s, V


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
    _bg.SHAPES.clear()
    _lr.SHAPES.clear()
    _qr.SHAPES.clear()
    _svd.SHAPES.clear()
