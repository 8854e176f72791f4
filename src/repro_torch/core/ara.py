"""Batched Adaptive Randomized Approximation (ARA), Algorithm 1 / [14].

Port of ``repro/core/ara.py``. The operator being compressed is only
touched through black-box sampling closures, which is what lets the TLR
factorization compress the *matrix expression*
``A(i,k) - sum_j L(i,j) L(k,j)^T`` without ever forming it:

  sample_fn(data, Omega) -> Y = Op @ Omega      (T, b, s)
  samplet_fn(data, Q)    -> B = Op^T @ Q        (T, m, R)

The batch is uniform: every tile owns a zero-padded rank-``r_max`` basis
buffer ``Q`` and a rank counter; zero padding makes the padded columns
inert in every projection. Convergence is tracked per tile.

Probes. The JAX package draws the probe of block iteration ``it`` as
``normal(fold_in(key, it), shape)``. Here a *probe source*
``draw(it, shape, dtype, device) -> Tensor`` supplies it, so a test can
hand both packages the same Omega. :func:`torch_probes` is the default
source: a CPU ``torch.Generator`` seeded from ``(seed, k, it)``, moved to
the device, so a run draws the same probes on every device.

Both loops (the fused driver and the dynamic driver of the factorization)
run on the host in PyTorch, which has no device-side while loop: the
all-converged test reads one boolean per block iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

Draw = Callable[[int, tuple, torch.dtype, torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ARAParams:
    bs: int = 16          # number of sample vectors per block iteration
    r_max: int = 128      # basis buffer width (static rank bound)
    eps: float = 1e-6     # absolute threshold on the 2-norm residual estimate
    calib: float = 1.0    # estimator calibration constant
    gs_passes: int = 2    # block Gram-Schmidt passes against Q
    max_iters: int = 0    # 0 => r_max // bs
    qr: str = "householder"  # "householder" (robust) | "cholqr"

    @property
    def iters(self) -> int:
        return self.max_iters or max(1, self.r_max // self.bs)


@dataclasses.dataclass
class ARAState:
    Q: torch.Tensor          # (T, b, r_max) zero-padded orthonormal bases
    rank: torch.Tensor       # (T,) int32
    converged: torch.Tensor  # (T,) bool
    err: torch.Tensor        # (T,) last residual-norm estimate
    it: int                  # block iterations taken (host counter)


def torch_probes(seed: int) -> Callable[..., torch.Tensor]:
    """Default probe source ``probes(k, it, shape, dtype, device,
    stream=())``: a standard normal draw from a CPU ``torch.Generator``
    seeded from ``(seed, k, stream, it)``, moved to ``device``. Keyed rather
    than sequential, so the draws do not depend on how many other draws
    came before, and identical on every device.

    ``stream`` names a draw sequence other than the panel ARA's (the JAX
    package's ``fold_in`` path between the column and the iteration: the
    factorization's rank-overflow re-pass draws with ``(7000 + attempt,)``);
    ``it`` is None for a single draw per column (the start vectors of power
    pivoting)."""

    def probes(k: int, it, shape, dtype, device,
               stream: tuple = ()) -> torch.Tensor:
        h = int(seed) * 1_000_003 + (int(k) + 1)
        for s in stream:
            h = h * 1_000_003 + int(s) + 1
        h = h * 1_000_003 + (-1 if it is None else int(it))
        g = torch.Generator()
        g.manual_seed(h % 2**64)
        return torch.randn(shape, generator=g, dtype=torch.float64).to(
            device=device, dtype=dtype)

    return probes


def init_state(T: int, b: int, p: ARAParams, dtype, device,
               valid: torch.Tensor | None = None) -> ARAState:
    """Fresh ARA state for a batch of T slots; invalid (padding) slots start
    converged at rank 0 with zero error, so they never sample, never append
    and never hold back the all-converged test."""
    if valid is None:
        converged = torch.zeros((T,), dtype=torch.bool, device=device)
        err = torch.full((T,), float("inf"), dtype=dtype, device=device)
    else:
        converged = ~valid
        err = torch.where(valid, float("inf"), 0.0).to(dtype)
    return ARAState(
        Q=torch.zeros((T, b, p.r_max), dtype=dtype, device=device),
        rank=torch.zeros((T,), dtype=torch.int32, device=device),
        converged=converged, err=err, it=0)


def rank_overflow(ranks, err, p: ARAParams) -> np.ndarray:
    """Host-side mask of tiles that exhausted the rank budget unconverged
    (at the cap with a residual estimate above ``p.eps``), or whose error
    estimate is non-finite."""
    ranks = np.asarray(ranks)
    err = np.asarray(err)
    with np.errstate(invalid="ignore"):
        unconverged = ~(err <= p.eps)          # NaN err counts as overflow
    return ((ranks >= p.r_max) & unconverged) | ~np.isfinite(err)


def _orthonormalize(Y: torch.Tensor, method: str,
                    drop_tol: float) -> torch.Tensor:
    """Orthonormalize the (T, b, s) panel; zero out numerically-dead columns.

    Columns whose norm (or orthogonalized residual, via the R diagonal) falls
    below ``drop_tol``, or below a relative cut of the panel's largest, carry
    no information at the target accuracy and are zeroed.
    """
    col_norm = torch.linalg.vector_norm(Y, dim=1)                # (T, s)
    keep = col_norm > drop_tol
    rel = 1e-8 if Y.dtype == torch.float64 else 1e-4
    if method == "householder":
        Q, R = torch.linalg.qr(Y)
        rdiag = torch.diagonal(R, dim1=-2, dim2=-1).abs()        # (T, s)
        rmax = rdiag.amax(dim=-1, keepdim=True)
        keep = keep & (rdiag > drop_tol) & (rdiag > rel * rmax)
        return Q * keep[:, None, :]
    if method != "cholqr":
        raise ValueError(f"qr must be 'householder' or 'cholqr', got {method!r}")

    # CholeskyQR2 on norm-equilibrated columns with trace-scaled jitter.
    cmax = col_norm.amax(dim=-1, keepdim=True)
    keep = keep & (col_norm > rel * cmax)
    Yn = Y / col_norm.clamp(min=drop_tol)[:, None, :]
    Yn = Yn * keep[:, None, :]
    s = Y.shape[-1]
    eye = torch.eye(s, dtype=Y.dtype, device=Y.device)
    jit0 = 1e-12 if Y.dtype == torch.float64 else 1e-5

    def one_pass(Yp):
        G = Yp.transpose(1, 2) @ Yp
        scale = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1).clamp(min=1.0)
        R = torch.linalg.cholesky(G + jit0 * scale[:, None, None] * eye)
        # Yq = Yp R^{-1}:  solve R^T Yq^T = Yp^T
        Yq = torch.linalg.solve_triangular(R.transpose(1, 2),
                                           Yp.transpose(1, 2), upper=True)
        return Yq.transpose(1, 2)

    Q = one_pass(one_pass(Yn))
    return Q * keep[:, None, :]


def ara_iteration(sample_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  data: Any, state: ARAState, draw: Draw, p: ARAParams, *,
                  share_omega: bool, T: int, b: int) -> ARAState:
    """One block iteration: sample, orthogonalize, estimate, append.
    Returns a new state; the input state's tensors are not modified."""
    Q = state.Q
    shape = (b, p.bs) if share_omega else (T, b, p.bs)
    Omega = draw(state.it, shape, Q.dtype, Q.device)

    Y = sample_fn(data, Omega)  # (T, b, bs)
    # Block Gram-Schmidt against the accumulated basis; zero columns of Q
    # contribute nothing.
    Qt = Q.transpose(1, 2)
    for _ in range(p.gs_passes):
        Y = Y - Q @ (Qt @ Y)

    # Residual 2-norm estimate from the projected-out samples.
    col_norms = torch.linalg.vector_norm(Y, dim=1)         # (T, bs)
    err = p.calib * col_norms.amax(dim=1)                  # (T,)

    newly = err <= p.eps
    room = state.rank + p.bs <= p.r_max
    active = ~state.converged & ~newly & room              # tiles that append

    Qy = _orthonormalize(Y, p.qr, drop_tol=p.eps * 1e-3)
    Qy = torch.where(active[:, None, None], Qy, torch.zeros_like(Qy))

    # Append Qy at each tile's own rank offset, for active tiles only: an
    # inactive tile may sit at rank + bs > r_max, where the clamped column
    # index below would overwrite its last appended block.
    cols = (state.rank.long()[:, None]
            + torch.arange(p.bs, device=Q.device)).clamp(max=p.r_max - 1)
    Q_cand = Q.scatter(2, cols[:, None, :].expand(T, b, p.bs), Qy)
    Q = torch.where(active[:, None, None], Q_cand, Q)
    rank = state.rank + torch.where(active, p.bs, 0).to(torch.int32)
    converged = state.converged | newly | (~room & ~state.converged)
    err = torch.where(state.converged, state.err, err)
    return ARAState(Q=Q, rank=rank, converged=converged, err=err,
                    it=state.it + 1)


def run_ara_fused(sample_fn, samplet_fn, data, draw: Draw, *, T: int, b: int,
                  p: ARAParams, dtype, device, share_omega: bool = True,
                  valid=None, project: bool = True):
    """ARA for a whole batch until every tile converges or the iteration
    cap is reached, then the projection ``B = Op^T Q``.
    Returns ``(Q, B, ranks, state)``.

    ``project=False`` skips the projection and returns ``B = None``: the
    ranked factorization reads the detected ranks first, then projects
    against ``Q`` sliced to the rank-ladder width that covers them (exact:
    columns of ``Q`` past each tile's rank are zero)."""
    state = init_state(T, b, p, dtype, device, valid=valid)
    while state.it < p.iters and not bool(state.converged.all()):
        state = ara_iteration(sample_fn, data, state, draw, p,
                              share_omega=share_omega, T=T, b=b)
    if not project:
        return state.Q, None, state.rank, state
    B = samplet_fn(data, state.Q)  # (T, m, r_max); cols past rank are zero
    return state.Q, B, state.rank, state


def run_ara_host(step_fn, sample_fn, samplet_fn, data, draw: Draw, *,
                 T: int, b: int, p: ARAParams, dtype, device,
                 share_omega: bool = True):
    """Host-driven ARA: a python loop over block iterations, convergence
    read on the host after each one, then the projection ``B = Op^T Q``.
    Returns ``(Q, B, ranks, state)``.

    ``step_fn(data, state, draw)`` runs one iteration: :func:`ara_iteration`
    bound to ``sample_fn``, ``p``, ``share_omega``, ``T`` and ``b`` (e.g.
    with ``functools.partial``), or a wrapper of it. ``sample_fn`` is
    accepted for the signature of the JAX package's ``run_ara_host`` and
    not called here."""
    state = init_state(T, b, p, dtype, device)
    for _ in range(p.iters):
        state = step_fn(data, state, draw)
        if bool(state.converged.all()):
            break
    B = samplet_fn(data, state.Q)
    return state.Q, B, state.rank, state


def dense_batch_sampler(A: torch.Tensor):
    """Samplers for a batch of dense operators A: (T, b, m)."""

    def sample(data, Omega):
        return data @ Omega          # (b, s) broadcasts, (T, m, s) batches

    def sample_t(data, Q):
        return data.transpose(1, 2) @ Q

    return sample, sample_t, A


def ara_compress_dense(A: torch.Tensor, draw: Draw, p: ARAParams, *,
                       share_omega: bool = True):
    """Compress a batch of dense matrices (T, b, m) -> (Q, B, ranks, state)."""
    T, b, _ = A.shape
    sample, sample_t, data = dense_batch_sampler(A)
    return run_ara_fused(sample, sample_t, data, draw, T=T, b=b, p=p,
                         dtype=A.dtype, device=A.device,
                         share_omega=share_omega)
