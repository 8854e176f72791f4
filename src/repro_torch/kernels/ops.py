"""Dispatch layer of the port's kernels (counterpart of
``repro/kernels/ops.py:81-115``).

Dispatch is by tensor device: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs the kernel's plain PyTorch version, and anything
else raises. There is no ``impl`` knob and no fallback: a CUDA tensor whose
kernel cannot build or launch raises.
"""

from __future__ import annotations

from . import batched_gemm as _bg
from . import lr_sample as _lr
from . import tlr_matvec as _tc
from .batched_gemm import batched_gemm
from .lr_sample import lr_sample
from .tlr_matvec import tile_chain

__all__ = ["batched_gemm", "launch_counts", "lr_sample",
           "reset_launch_counts", "tile_chain"]

KERNELS = {"batched_gemm": _bg, "tile_chain": _tc, "lr_sample": _lr}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
