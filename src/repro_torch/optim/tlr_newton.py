"""TLR-KFAC: Kronecker-factored natural-gradient preconditioning where the
curvature factors are Cholesky-factored in TILE LOW RANK form (the port's
``repro/optim/tlr_newton.py``).

For a weight W (m x n) with layer input a and output-gradient g, K-FAC
preconditions with the Kronecker factors

    A = E[a a^T] (n x n, activation covariance)
    S = E[g g^T] (m x m, output-gradient covariance)
    P = S^{-1} G A^{-1}

Every ``refresh_every`` steps the damped factors are compressed to TLR and
factored with the left-looking ARA Cholesky; on the card that factorization
launches the port's ``lr_sample``, ``tile_chain`` and ``batched_gemm``
kernels at tile ``cfg.tile``. Sides smaller than ``max(min_dim, 2 tile)``
or not a multiple of the tile are factored densely.

The curvature statistics, their EMA and the damping stay on the tensors'
device (the JAX package keeps them in host numpy, which on the card would
make every refresh a host GEMM). The TLR factorization draws its ARA
probes from torch's generator (``CholOptions.seed``), not ``jax.random``.

The trainer streams curvature observations via the ``curvature`` argument
({leaf-name: (a_batch, g_batch)} or precomputed (A, S) matrices, numpy
arrays or tensors); leaves without curvature fall back to AdamW. Step size
is grafted from AdamW (direction from K-FAC, norm from Adam).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core import CholOptions, TLROperator
from ..tree import flatten_with_path, leaves, path_str, unflatten
from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TLRNewtonConfig:
    beta: float = 0.95
    damping: float = 1e-3
    min_dim: int = 64           # sides smaller than this solve densely
    tile: int = 32              # TLR tile size for the curvature factors
    eps_tlr: float = 1e-6       # ARA compression threshold
    refresh_every: int = 10     # factorization refresh cadence
    grafting: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class TLRNewtonState(NamedTuple):
    step: int
    stats: dict                  # leaf-name -> {"A": .., "S": ..} EMA factors
    facts: dict                  # leaf-name -> {"A": solve, "S": solve}
    adam: AdamWState


def _leaf_names(tree) -> list[str]:
    """The JAX package's leaf names: the key path joined by ``/``."""
    return [path_str(path, "/") for path, _ in flatten_with_path(tree)]


def tlr_newton_init(params, cfg: TLRNewtonConfig) -> TLRNewtonState:
    return TLRNewtonState(step=0, stats={}, facts={},
                          adam=adamw_init(params, cfg.grafting))


def _as_cov(obs, dim: int, device) -> torch.Tensor:
    """Accept either a covariance matrix (dim x dim) or a batch of vectors
    (batch x dim) to be averaged into one, as float64 on ``device``."""
    obs = torch.as_tensor(obs).to(device=device, dtype=torch.float64)
    if tuple(obs.shape) == (dim, dim):
        return obs
    if obs.ndim == 2 and obs.shape[1] == dim:
        return obs.T @ obs / obs.shape[0]
    raise ValueError(f"curvature obs shape {tuple(obs.shape)} for dim {dim}")


def damped(S: torch.Tensor, cfg: TLRNewtonConfig) -> torch.Tensor:
    """``S + lam I`` with ``lam = damping (trace(S) / n + 1)``."""
    n = S.shape[0]
    lam = cfg.damping * (torch.trace(S) / n + 1.0)
    return S + lam * torch.eye(n, dtype=S.dtype, device=S.device)


def _make_solver(S: torch.Tensor, cfg: TLRNewtonConfig):
    """Damped factorization of one curvature factor; returns solve(x)."""
    n = S.shape[0]
    Sd = damped(S, cfg)
    if n < max(cfg.min_dim, 2 * cfg.tile) or n % cfg.tile:
        chol = torch.linalg.cholesky(Sd)

        def solve_dense(x):
            y = torch.linalg.solve_triangular(chol, x, upper=False)
            return torch.linalg.solve_triangular(chol.T, y, upper=True)

        return solve_dense
    # r_max = tile size: rank-adaptive ARA keeps actual ranks low where the
    # factor is data-sparse, but generic K-FAC covariances may have
    # full-rank tiles and must not be force-truncated.
    op = TLROperator.compress(Sd, cfg.tile, eps=cfg.eps_tlr * 1e-2)
    fact = op.cholesky(CholOptions(eps=cfg.eps_tlr, bs=8, schur="diag"))
    return fact.solve


@torch.no_grad()
def tlr_newton_update(grads, state: TLRNewtonState, params,
                      cfg: TLRNewtonConfig,
                      curvature: Optional[dict] = None):
    """Returns (new_params, new_state).

    ``curvature``: {leaf-name: (A_obs, S_obs)}; each obs is a covariance
    matrix or a (batch, dim) array of observations. A_obs is the
    activation-side (n) factor, S_obs the output-gradient-side (m) factor;
    either may be None to precondition one side only. Host-driven: the
    factorization refresh runs between steps, as in the paper.
    """
    names = _leaf_names(params)
    gleaves = leaves(grads)
    pleaves = leaves(params)
    curvature = curvature or {}

    # 1) EMA curvature statistics
    new_stats = dict(state.stats)
    for n, g in zip(names, gleaves):
        if n not in curvature or g.ndim != 2:
            continue
        m, k = g.shape
        A_obs, S_obs = curvature[n]
        ent = dict(new_stats.get(n, {}))
        for side, obs, dim in (("A", A_obs, k), ("S", S_obs, m)):
            if obs is None:
                continue
            C = _as_cov(obs, dim, g.device)
            prev = ent.get(side)
            ent[side] = (1 - cfg.beta) * C if prev is None else \
                cfg.beta * prev + (1 - cfg.beta) * C
        new_stats[n] = ent

    # 2) refresh TLR factorizations on cadence
    facts = dict(state.facts)
    if state.step % cfg.refresh_every == 0:
        for n, ent in new_stats.items():
            facts[n] = {side: _make_solver(S, cfg) for side, S in ent.items()}

    # 3) AdamW grafting pass (fallback direction + step norm)
    adam_params, adam_state = adamw_update(grads, state.adam, params,
                                           cfg.grafting)

    # 4) preconditioned update for leaves with curvature
    out = []
    for n, g, p, ap in zip(names, gleaves, pleaves, leaves(adam_params)):
        f = facts.get(n)
        if not f:
            out.append(ap)
            continue
        Pg = g.double()
        if "S" in f:                      # left: S^{-1} G
            Pg = f["S"](Pg)
        if "A" in f:                      # right: G A^{-1}
            Pg = f["A"](Pg.T).T
        a_step = (ap - p).double()
        denom = torch.clamp(torch.linalg.norm(Pg), min=1e-30)
        upd = Pg * (torch.linalg.norm(a_step) / denom)
        out.append((p.double() - upd).to(p.dtype))
    return unflatten(params, out), TLRNewtonState(
        step=state.step + 1, stats=new_stats, facts=facts, adam=adam_state)
