"""``repro_torch.obs`` -- telemetry across factorize / plan / serve.

Port of ``repro/obs``. One process-wide recording context collects nested
spans (wall time + FLOP attribution + rank histograms) at every layer's
natural boundaries and exports them as Perfetto-loadable Chrome-trace
JSON, a flat metrics snapshot, or counter timelines of the dispatch-shape
registry. Every enabled span is also a ``torch.profiler`` user range and,
on a CUDA card, an NVTX range, so a device profile taken under telemetry
names the phase that launched each kernel.

Typical use::

    from repro_torch import obs

    obs.enable()
    fact = op.cholesky(CholOptions(eps=1e-6))  # spans recorded as a side effect
    obs.export_chrome_trace("trace.json")     # -> load in ui.perfetto.dev
    print(fact.stats["telemetry"])            # per-phase FLOP/s snapshot
    obs.disable()

Everything is a no-op while disabled: ``obs.span(...)`` returns a shared
inert handle without touching the clock, and instrumentation sites gate
attribute computation behind ``obs.enabled()``, so production paths pay
one global check per site.
"""

from .telemetry import (NOOP_SPAN, Span, Telemetry, counter, current,
                        disable, enable, enabled, rank_hist,
                        record_retraces, span, traced)
from .chrome_trace import export_chrome_trace, to_chrome_trace
from .metrics import metrics_snapshot

__all__ = [
    "NOOP_SPAN", "Span", "Telemetry", "counter", "current", "disable",
    "enable", "enabled", "export_chrome_trace", "metrics_snapshot",
    "rank_hist", "record_retraces", "span", "to_chrome_trace", "traced",
]
