"""Newton-Schulz TLR approximate inverse, used as a PCG preconditioner.

Port of ``repro/core/precond.py:37-164``. The classical iteration
``X_{k+1} = X_k (2I - A X_k)`` converges quadratically to ``A^{-1}``
whenever ``||I - A X_0|| < 1``; for SPD ``A`` the scaling
``X_0 = I / tr(A)`` guarantees that, and each iterate stays a polynomial in
``A`` -- hence symmetric positive definite, which is what lets ``X_k``
serve as a PCG preconditioner at any iteration count.

In TLR arithmetic (``core/algebra.py``) each iteration is two ``tlr_gemm``
(``M = A X``, ``S = X M``), one ``symmetrize`` and one ``tlr_axpy``
(``2 X - sym(S)``), each rounded at ``eps``: ranks stay bounded by
``r_max_out``, and every tile operation runs in the port's kernels
(``batched_gemm``, ``batched_qr``, ``small_svd``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .algebra import symmetrize, tlr_axpy, tlr_gemm, tlr_scale
from .dense_ref import spectral_norm_est_op
from .operator import TLROperator
from .solve import tlr_matvec
from .tlr import TLRMatrix, num_tiles


@dataclasses.dataclass(frozen=True)
class NewtonSchulzInfo:
    """Host-side record of a ``tlr_newton_schulz`` run."""

    alpha: float                  # initial scaling X_0 = alpha I
    iters: int                    # iterations actually run
    residual_history: list       # ||I - A X_k||_2 estimates (if tracked)
    avg_rank: float               # mean off-diagonal rank of the final X
    max_rank: int
    eps_history: list = dataclasses.field(default_factory=list)
                                  # per-iteration rounding eps (adaptive mode)
    converged: bool = False       # residual stopping rule fired (tol > 0)


def _identity_tlr(nb: int, b: int, r_max: int, dtype, alpha,
                  device) -> TLRMatrix:
    nt = num_tiles(nb)
    eye = alpha * torch.eye(b, dtype=dtype, device=device)
    return TLRMatrix(
        D=eye.expand(nb, b, b).clone(),
        U=torch.zeros((nt, b, r_max), dtype=dtype, device=device),
        V=torch.zeros((nt, b, r_max), dtype=dtype, device=device),
        ranks=torch.zeros((nt,), dtype=torch.int32, device=device),
    )


def tlr_newton_schulz(
    A,
    iters: int = 8,
    eps: float = 1e-6,
    r_max_out: Optional[int] = None,
    *,
    scale: str = "trace",
    track_residual: bool = False,
    adaptive: bool = False,
    tol: float = 0.0,
    loose_eps: float = 1e-2,
    batching: str = "flat",
) -> tuple[TLROperator, NewtonSchulzInfo]:
    """Approximate ``A^{-1}`` in TLR form by Newton-Schulz iteration.

    ``A`` is a ``TLROperator`` or ``TLRMatrix`` (SPD), on its own device.
    ``scale`` picks the initial ``X_0 = alpha I``: ``"trace"`` (alpha =
    1/tr(A), always safe) or ``"norm"`` (alpha = 1/||A||_2 estimate, a
    faster start). Returns the approximate inverse as a ``TLROperator``
    (its ``.matvec`` is the preconditioner action, so it plugs into
    ``pcg(precond=...)``) and a :class:`NewtonSchulzInfo`.

    ``track_residual`` estimates ``||I - A X_k||_2`` each iteration by
    power iteration (30 extra matvecs per step).

    * ``adaptive=True``: per-iteration rounding threshold, loose early and
      tight late -- ``eps_k = clip(loose_eps * r_{k-1}, eps, loose_eps)``
      with ``r_k`` the residual-norm estimate (the clip bounds are ordered,
      so an ``eps`` coarser than ``loose_eps`` is honored).
    * ``tol > 0``: the loop ends as soon as ``||I - A X_k||_2 < tol``
      (``iters`` becomes a cap, and ``info.converged`` reports whether the
      rule fired).

    ``batching="ranked"`` routes every product and rounding through the
    rank-bucketed dispatch layer (``core/batching.py``).
    """
    op = A if isinstance(A, TLROperator) else TLROperator(A)
    nb, b = op.nb, op.b
    r_out = r_max_out or op.r_max
    dev = {"device": op.device, "dtype": op.dtype}
    if scale == "trace":
        alpha = 1.0 / float(op.trace())
    elif scale == "norm":
        alpha = 1.0 / spectral_norm_est_op(op.matvec, op.n, **dev)
    else:
        raise ValueError(f"scale must be 'trace' or 'norm', got {scale!r}")

    X = _identity_tlr(nb, b, r_out, op.dtype, alpha, op.device)
    history = []
    eps_history = []
    converged = False
    it_done = 0

    def residual(Xc):
        return spectral_norm_est_op(
            lambda v: v - op.matvec(tlr_matvec(Xc, v)), op.n, **dev)

    need_residual = adaptive or tol > 0
    r_est = residual(X) if need_residual else None

    for _ in range(iters):
        eps_i = eps
        if adaptive:
            eps_i = float(np.clip(loose_eps * r_est, eps,
                                  max(eps, loose_eps)))
        M = tlr_gemm(op.A, X, eps_i, r_max_out=r_out,
                     batching=batching)                           # A X
        S = tlr_gemm(X, M, eps_i, r_max_out=r_out,
                     batching=batching)                           # X A X
        Ssym = symmetrize(S, eps=eps_i, r_max_out=r_out, batching=batching)
        X = tlr_axpy(-1.0, Ssym, tlr_scale(2.0, X), eps=eps_i,
                     r_max_out=r_out, batching=batching)          # 2X - XAX
        it_done += 1
        eps_history.append(eps_i)
        if need_residual or track_residual:
            r_est = residual(X)
            if track_residual:
                history.append(r_est)
            if tol > 0 and r_est < tol:
                converged = True
                break

    ranks = X.ranks.cpu().numpy()
    info = NewtonSchulzInfo(
        alpha=alpha,
        iters=it_done,
        residual_history=history,
        avg_rank=float(ranks.mean()) if ranks.size else 0.0,
        max_rank=int(ranks.max()) if ranks.size else 0,
        eps_history=eps_history,
        converged=converged,
    )
    return TLROperator(X), info
