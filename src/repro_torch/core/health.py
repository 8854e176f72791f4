"""Breakdown detection + bounded recovery for the TLR drivers.

Port of ``repro/core/health.py``. The adaptive factorization is numerically
live -- ranks, tolerances and diagonal conditioning interact at run time --
so an indefinite diagonal tile, a NaN produced mid-panel or a rank
overflow must surface as a *policy decision* (retry, degrade or raise),
never as silent NaN factors. ``CholOptions(check=True)`` turns it on; off
(the default), the drivers construct no monitor and run no check.

* :func:`column_flags` -- one device reduction per checked stage collapses
  "non-finite entries in the scanned arrays", "non-finite pivots", "the
  minimum pivot and its index" and "tiles at the rank cap with err > eps"
  into a five-number vector, read on the host in one copy.
* :class:`RetryPolicy` (``CholOptions.retry``) -- the bounded remedy
  schedule: diagonal jitter ``shift0 * growth**attempt`` on SPD breakdown,
  eps-loosening ``eps * eps_growth**attempt`` on rank overflow, per-tile
  densify as the last resort. The policy only *sizes* remedies; the drivers
  apply them.
* :class:`HealthMonitor` -- every remedy lands as a :class:`HealthEvent`
  in ``fact.stats["health"]``; exhausted retries raise
  :class:`FactorizationBreakdown` carrying a :class:`BreakdownReport`
  (column, stage, pivot index, every remedy attempted) instead of returning
  non-finite factors; when telemetry records, each event also lands as a
  cumulative ``obs.counter("health", ...)`` sample.
"""

from __future__ import annotations

import dataclasses
from typing import List, NoReturn, Optional

import numpy as np
import torch

from .. import obs

__all__ = [
    "RetryPolicy", "HealthEvent", "BreakdownReport",
    "FactorizationBreakdown", "HealthMonitor", "column_flags",
]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded remedy schedule (frozen so ``CholOptions`` stays hashable).

    ``max_retries`` bounds *each* remedy ladder independently: up to
    ``max_retries`` jitter re-factors of a failing diagonal tile and up to
    ``max_retries`` eps-loosened ARA re-passes of an overflowing panel
    (then the densify fallback, if enabled). A tile whose truncation
    error still exceeds ``eps * eps_growth**max_retries`` after every
    remedy is a breakdown, not a silent degradation.
    """

    max_retries: int = 2
    shift0: float = 1e-8       # first jitter shift, relative to diag scale
    growth: float = 16.0       # jitter escalation per attempt
    eps_growth: float = 4.0    # eps loosening per rank-overflow retry
    densify: bool = True       # exact-sample + SVD fallback at the cap

    def shift(self, attempt: int) -> float:
        return self.shift0 * self.growth ** attempt

    def eps_at(self, eps: float, attempt: int) -> float:
        return eps * self.eps_growth ** attempt

    def eps_floor(self, eps: float) -> float:
        """The loosest tolerance any remedy is allowed to accept."""
        return eps * self.eps_growth ** self.max_retries


@dataclasses.dataclass
class HealthEvent:
    """One detection or remedy, as recorded in ``stats["health"]``."""

    kind: str                  # "spd_breakdown" | "nonfinite_panel" |
                               # "nonfinite_update" | "rank_overflow" | ...
    column: int
    stage: str                 # "diag" | "panel" | "update" | "final"
    remedy: str                # "jitter" | "eps_loosen" | "densify" |
                               # "clamp" | "accept" | "raise"
    attempt: int = 0
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BreakdownReport:
    """What :class:`FactorizationBreakdown` carries instead of NaNs."""

    column: int
    stage: str
    reason: str
    pivot_index: Optional[int] = None
    remedies: List[str] = dataclasses.field(default_factory=list)
    events: List[HealthEvent] = dataclasses.field(default_factory=list)
    detail: dict = dataclasses.field(default_factory=dict)


class FactorizationBreakdown(RuntimeError):
    """Raised when every remedy in the :class:`RetryPolicy` is exhausted
    (or the failure is unrecoverable, e.g. non-finite panel output with
    healthy pivots). The factorization never returns partial or
    non-finite factors -- the report says what failed and what was tried.
    """

    def __init__(self, report: BreakdownReport):
        self.report = report
        where = f"column {report.column}" if report.column >= 0 \
            else "final scan"
        tried = ", ".join(report.remedies) if report.remedies else "none"
        super().__init__(
            f"factorization breakdown at {where} ({report.stage}): "
            f"{report.reason}; remedies attempted: {tried}")


# -- the flag reduction ----------------------------------------------------------

# Flag vector layout (one host copy):
#   [0] non-finite entries across the scanned arrays (panel bases/factors)
#   [1] non-finite pivots
#   [2] min finite pivot (+inf when all pivots are non-finite)
#   [3] argmin of [2]
#   [4] tiles at the rank cap with err > eps (0 when no ranks are given)


def column_flags(pivots: torch.Tensor, arrays=(), *, ranks=None, err=None,
                 r_cap: int = 0, eps: float = 0.0) -> np.ndarray:
    """One health reduction on the pivots' device, read on the host as a
    single (5,) float64 array.

    ``pivots`` is the diagonal of the column's dense factor (Cholesky) or
    its LDL d-vector; ``arrays`` is a sequence of panel outputs to scan for
    non-finite entries. ``ranks`` / ``err`` (optional) enable the
    rank-overflow count against ``r_cap`` / ``eps``; a NaN ``err`` counts
    as overflow (``~(err <= eps)``).
    """
    zero = torch.zeros((), dtype=torch.int64, device=pivots.device)
    n_nonfinite = sum(((~torch.isfinite(x)).sum() for x in arrays), zero)
    pf = torch.isfinite(pivots)
    piv = torch.where(pf, pivots, torch.full_like(pivots, float("inf")))
    if ranks is None:
        n_over = zero
    else:
        n_over = ((ranks >= r_cap) & ~(err <= eps)).sum()
    flags = torch.stack([
        n_nonfinite.to(torch.float64), (~pf).sum().to(torch.float64),
        piv.min().to(torch.float64), piv.argmin().to(torch.float64),
        n_over.to(torch.float64)])
    return flags.cpu().numpy()


# -- the monitor -------------------------------------------------------------------


class HealthMonitor:
    """Per-factorization event log + report builder.

    The drivers own the decisions (they hold the pipelines); the monitor
    records what happened, keeps cumulative counters (mirrored into
    ``obs.counter("health", ...)`` when telemetry records) and builds the
    :class:`BreakdownReport` when a driver gives up.
    """

    def __init__(self, policy: RetryPolicy, algo: str, nb: int):
        self.policy = policy
        self.algo = algo
        self.nb = nb
        self.events: List[HealthEvent] = []
        self.counters: dict[str, int] = {}
        self.columns_checked = 0

    def record(self, kind: str, column: int, stage: str, *, remedy: str,
               attempt: int = 0, **detail) -> HealthEvent:
        ev = HealthEvent(kind=kind, column=column, stage=stage,
                         remedy=remedy, attempt=attempt, detail=detail)
        self.events.append(ev)
        self.counters[kind] = self.counters.get(kind, 0) + 1
        if obs.enabled():
            # Cumulative samples: the last sample of the series is the
            # factorization's total (metrics_snapshot "counters" contract).
            obs.counter("health",
                        {k: float(v) for k, v in self.counters.items()})
        return ev

    def fail(self, column: int, stage: str, reason: str, *,
             pivot_index: Optional[int] = None, **detail) -> NoReturn:
        self.record(reason, column, stage, remedy="raise", **detail)
        col_events = [e for e in self.events if e.column == column]
        report = BreakdownReport(
            column=column, stage=stage, reason=reason,
            pivot_index=pivot_index,
            remedies=[e.remedy for e in col_events
                      if e.remedy not in ("raise", "accept")],
            events=col_events, detail=detail)
        raise FactorizationBreakdown(report)

    def summary(self) -> dict:
        """The ``stats["health"]`` record."""
        return {
            "events": [dataclasses.asdict(e) for e in self.events],
            "counters": dict(self.counters),
            "columns_checked": self.columns_checked,
            "policy": dataclasses.asdict(self.policy),
        }
