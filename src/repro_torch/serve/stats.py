"""Server instrumentation: per-request latency, per-tick occupancy.

Every tick records how many slots carried live work, every completion its
end-to-end latency, and ``summary()`` collapses the record into p50/p99
and occupancy numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class ServerStats:
    """Occupancy / latency record of one server lifetime."""

    slots: int
    ticks: int = 0
    admitted: int = 0
    completed: int = 0
    # Degradation counters: submit-time rejections, deadline evictions,
    # degraded (error) completions and breakdown-retry re-admissions.
    rejected: int = 0
    timeouts: int = 0
    errors: int = 0
    pcg_retries: int = 0
    tick_active: List[int] = dataclasses.field(default_factory=list)
    tick_seconds: List[float] = dataclasses.field(default_factory=list)
    latencies: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    request_ticks: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)

    def record_tick(self, active: int, seconds: float) -> None:
        self.ticks += 1
        self.tick_active.append(int(active))
        self.tick_seconds.append(float(seconds))

    def record_completion(self, kind: str, latency_s: float,
                          ticks: int) -> None:
        self.completed += 1
        self.latencies.setdefault(kind, []).append(float(latency_s))
        self.request_ticks.setdefault(kind, []).append(int(ticks))

    def occupancy(self) -> float:
        """Mean fraction of slots carrying live work per tick (idle slots
        are padding). 0.0 before the first tick."""
        if not self.tick_active:
            return 0.0
        return float(np.mean(self.tick_active)) / float(self.slots)

    def latency_percentiles(self, kind: str | None = None) -> dict:
        """p50/p99 (plus mean/max) latency in seconds, overall or for one
        request kind; ``None`` fields with ``count`` 0 when nothing of
        that kind completed."""
        if kind is None:
            vals = [v for lat in self.latencies.values() for v in lat]
        else:
            vals = list(self.latencies.get(kind, []))
        if not vals:
            return {"p50_s": None, "p99_s": None, "mean_s": None,
                    "max_s": None, "count": 0}
        a = np.asarray(vals)
        return {"p50_s": float(np.percentile(a, 50)),
                "p99_s": float(np.percentile(a, 99)),
                "mean_s": float(a.mean()), "max_s": float(a.max()),
                "count": int(a.size)}

    def summary(self) -> dict:
        """The machine-readable record: occupancy, throughput, per-kind and
        overall p50/p99, the health counters and, while telemetry records,
        the ``serve`` spans' metrics snapshot."""
        wall = float(np.sum(self.tick_seconds))
        out = {
            "slots": self.slots,
            "ticks": self.ticks,
            "admitted": self.admitted,
            "completed": self.completed,
            "occupancy": self.occupancy(),
            "wall_s": wall,
            "requests_per_s": (self.completed / wall) if wall > 0 else 0.0,
            "latency": self.latency_percentiles(),
            "health": {
                "rejected": self.rejected,
                "timeouts": self.timeouts,
                "errors": self.errors,
                "pcg_retries": self.pcg_retries,
            },
        }
        for kind in sorted(self.latencies):
            out[f"latency_{kind}"] = self.latency_percentiles(kind)
        from .. import obs

        if obs.enabled():
            # The server's slice of the active telemetry recording:
            # per-tick-stage seconds (pack/dispatch/sync/evict) next to the
            # occupancy/latency record they explain.
            out["telemetry"] = obs.metrics_snapshot(cats=("serve",))
        return out
