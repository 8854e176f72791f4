"""Batched economy QR by two-sweep modified Gram-Schmidt (MGS2).

Port of the Pallas TPU kernel ``batched_qr_pallas`` (``_mgs_qr_kernel`` /
``_mgs_body``, src/repro/kernels/batched_qr.py:33-97). ``Y (T, b, r) ->
Q (T, b, r), R = Q^T Y (T, r, r)``, r <= b. Each sweep takes its drop
tolerance ``max(rel * max column norm, tiny)`` from the *current* column
norms (rel 1e-8 in f64, 1e-4 in f32); a column whose residual norm is not
above it is zeroed, so rank-deficient columns come out exactly zero and
inert downstream. The CUDA kernel is ``csrc/batched_qr.cu``; what bounds it
on the H100 and what the design does about it is noted in the source. For
b <= 512 and r <= 128 it runs MGS2 in panels of 16 columns, each panel's
trailing update in the blocked (inverse compact-WY) form of MGS on the
tensor cores; the source's ``config`` query says which kernel a shape
takes.

The plain version runs the same MGS2 (not ``torch.linalg.qr``, whose
Householder Q differs on dead columns), so the kernel is held against it
elementwise on the card. :func:`batched_qr` launches the kernel for CUDA
tensors and runs :func:`batched_qr_plain` for CPU tensors; there is no
fallback between the two.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0  # kernel launches since the last reset (ops.reset_launch_counts)
# launches per (T, b, r) shape since the last reset
SHAPES: dict[tuple[int, int, int], int] = {}
# the source's kernel configurations (``config``): the first design, the
# working matrix in shared memory (b <= 128), panels and chunks streamed
# through shared memory (128 < b <= 512, r <= 128)
FIRST, SMEM, STREAM = 0, 1, 2

REL = {torch.float64: 1e-8, torch.float32: 1e-4}
_MAX_B = 1024  # one register column per warp: 32 words a lane


def _check(Y: torch.Tensor) -> None:
    if Y.dim() != 3:
        raise ValueError(f"batched_qr: Y must be (T, b, r), got "
                         f"{tuple(Y.shape)}")
    b, r = Y.shape[1], Y.shape[2]
    if r > b:
        raise ValueError(
            f"batched_qr needs tall panels (r <= b), got b={b}, r={r}; "
            "densify the factor sum first (core/algebra.py does)")
    if Y.dtype not in REL:
        raise TypeError(f"batched_qr: dtype {Y.dtype} not supported "
                        "(float64, float32)")


def batched_qr_plain(Y: torch.Tensor, sweeps: int = 2):
    """Plain PyTorch version: the MGS2 of ``_mgs_qr_kernel``, batched."""
    _check(Y)
    T, b, r = Y.shape
    rel, tiny = REL[Y.dtype], torch.finfo(Y.dtype).tiny
    Q = Y.clone()
    if Q.numel() == 0:
        return Q, Y.new_zeros((T, r, r))
    for _ in range(sweeps):
        # The tolerance tracks the current column scale: after sweep 1 the
        # live columns are unit vectors.
        col = Q.square().sum(dim=1).sqrt()
        tol = (rel * col.amax(dim=1, keepdim=True)).clamp(min=tiny)  # (T, 1)
        for k in range(r):
            qk = Q[:, :, k]
            nrm = qk.square().sum(dim=1, keepdim=True).sqrt()
            qk = torch.where(nrm > tol, qk / torch.maximum(nrm, tol),
                             torch.zeros_like(qk))
            if k + 1 < r:
                later = Q[:, :, k + 1:]
                proj = torch.einsum("tb,tbj->tj", qk, later)
                later -= qk[:, :, None] * proj[:, None, :]
            Q[:, :, k] = qk
    return Q, Q.transpose(1, 2) @ Y


def batched_qr_cuda(Y: torch.Tensor, sweeps: int = 2):
    """Launch ``csrc/batched_qr.cu`` on the current stream."""
    global LAUNCHES
    _check(Y)
    if not Y.is_cuda:
        raise ValueError("batched_qr_cuda needs a CUDA tensor")
    if not Y.is_contiguous():
        raise ValueError("batched_qr: Y must be contiguous")
    T, b, r = Y.shape
    if b > _MAX_B:
        raise ValueError(f"batched_qr: b={b} exceeds the kernel's {_MAX_B}")
    Q = torch.empty_like(Y)
    R = Y.new_empty((T, r, r))
    if Q.numel() == 0:
        return Q, R.zero_()
    # The kernel's source decides the kernel and whether the first design's
    # panel fits in shared memory.
    words = build.query("batched_qr", "scratch", Y.dtype, b, r)
    work = Y.new_empty((T, words)) if words else None
    fn = build.entry("batched_qr", Y.dtype)
    err = fn(Y.data_ptr(), Q.data_ptr(), R.data_ptr(),
             0 if work is None else work.data_ptr(), T, b, r, sweeps,
             build.stream_handle(Y))
    build.check("batched_qr", err)
    LAUNCHES += 1
    SHAPES[(T, b, r)] = SHAPES.get((T, b, r), 0) + 1
    return Q, R


def batched_qr(Y: torch.Tensor):
    """Y: (T, b, r), r <= b -> Q (T, b, r), R (T, r, r); dead columns zero."""
    if Y.is_cuda:
        return batched_qr_cuda(Y)
    if Y.device.type == "cpu":
        return batched_qr_plain(Y)
    raise ValueError(f"batched_qr: unsupported device {Y.device}")
