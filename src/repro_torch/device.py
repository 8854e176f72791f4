"""Device selection and numeric settings of the port.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` when a card is present and raises
otherwise. It never falls back to the CPU silently.

Float32 matrix products are pinned to full float32: TF32 is off for both
cuBLAS and cuDNN and the float32 matmul precision is "highest" (TF32 keeps
about three decimal digits, which the f32 parity tolerances of 1e-5 would
not survive).
"""

from __future__ import annotations

import numpy as np
import torch


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (host-side packing of tensors of
    that dtype), e.g. ``torch.float64`` -> ``float64``."""
    return torch.empty((), dtype=dtype).numpy().dtype


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name
    (``np.float32``, ``"float32"``, ``torch.float32`` -> ``torch.float32``;
    ``"bfloat16"`` -> ``torch.bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name == "bfloat16":       # numpy has none (ml_dtypes' is foreign)
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def pin_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); otherwise the device
    asked for, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "present; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA card is "
                           "present")
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a sharded model's tensor), without
    importing ``torch.distributed.tensor`` for plain ones."""
    return type(x).__name__ == "DTensor"
