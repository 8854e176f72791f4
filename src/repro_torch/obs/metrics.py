"""Flat metrics snapshot of a telemetry recording.

Port of ``repro/obs/metrics.py``. ``metrics_snapshot()`` collapses the span
tree into the per-phase numbers the paper's profiling tables report
(arXiv:2108.11932 fig. 10: wall time and achieved FLOP/s attributed to
batched-GEMM vs. compression phases): for every span *name*, the call
count, total seconds, useful and padded FLOPs, achieved FLOP/s, and
padded-vs-useful ratio. The snapshot is plain JSON-able data; the drivers
merge it into ``fact.stats["telemetry"]`` and the server into
``ServerStats.summary()``.

FLOP attribution convention (matching ``TilePlan.bucket_flops``):
instrumentation sites attach ``flops`` (useful work, true ranks) and
``flops_padded`` (dispatched work, bucket-padded shapes) to *leaf* spans
only. Aggregation here sums attrs per span name without walking the tree,
so interior spans must not repeat their children's FLOPs -- their own row
then reports seconds but no FLOP/s, and the top-level totals stay
double-count free. The port's FLOPs are analytic (``_round_core_flops``,
``_chain_span_attrs``); the JAX package takes the rounding core's from
XLA's ``cost_analysis``.
"""

from __future__ import annotations

from typing import Optional

from . import telemetry as _tel


def _phase_row() -> dict:
    return {"count": 0, "seconds": 0.0, "flops": 0.0, "flops_padded": 0.0}


def metrics_snapshot(tel: Optional["_tel.Telemetry"] = None,
                     root=None, cats=None) -> dict:
    """Aggregate a recording (default: the active one) into a flat dict:

    ``phases``
        per span-name rows ``{count, seconds, flops, flops_padded,
        flops_per_s, padded_flop_ratio}`` (the FLOP-derived fields only
        where FLOPs were attached);
    ``wall_s`` / ``flops`` / ``flops_padded`` / ``padded_flop_ratio`` /
    ``flops_per_s``
        totals -- ``wall_s`` is the summed duration of *top-level* spans
        in the selection (nested spans overlap their parents and must
        not be double counted);
    ``retraces``
        the dispatch-shape registry snapshot at call time;
    ``spans``
        total span count in the selection.

    ``root`` restricts to one span's subtree (handle, Span, or id) --
    the drivers pass their run-root so concurrent recordings of other
    layers don't leak into ``fact.stats["telemetry"]``. ``cats``
    restricts to a set of span categories (e.g. ``("serve",)`` for the
    server's view of a shared recording); both filters compose.
    """
    tel = tel if tel is not None else _tel.current()
    if tel is None:
        return {}

    spans = tel.subtree(root)
    if cats is not None:
        want = {cats} if isinstance(cats, str) else set(cats)
        spans = [sp for sp in spans if sp.cat in want]
    ids = {sp.id for sp in spans}

    phases: dict[str, dict] = {}
    wall = 0.0
    for sp in spans:
        row = phases.setdefault(sp.name, _phase_row())
        row["count"] += 1
        row["seconds"] += sp.dur
        fl = sp.args.get("flops")
        if fl is not None:
            row["flops"] += float(fl)
            row["flops_padded"] += float(
                sp.args.get("flops_padded", fl))
        if sp.parent not in ids:
            wall += sp.dur

    tot_fl = tot_pad = 0.0
    for row in phases.values():
        if row["flops"] > 0.0:
            tot_fl += row["flops"]
            tot_pad += row["flops_padded"]
            if row["seconds"] > 0.0:
                row["flops_per_s"] = row["flops"] / row["seconds"]
            row["padded_flop_ratio"] = row["flops_padded"] / row["flops"]

    from ..core.buckets import trace_counts

    out = {
        "spans": len(spans),
        "wall_s": wall,
        "flops": tot_fl,
        "flops_padded": tot_pad,
        "phases": phases,
        "retraces": trace_counts(),
    }
    if tot_fl > 0.0:
        out["padded_flop_ratio"] = tot_pad / tot_fl
        if wall > 0.0:
            out["flops_per_s"] = tot_fl / wall
    # Last sample per counter series (counters are cumulative: the drivers
    # emit running totals, e.g. the "health" jitter/retry counts, so the
    # final sample IS the aggregate). Counters are recording-global --
    # root/cats filters don't apply.
    counters: dict[str, dict] = {}
    for name, _t, values in tel.counters:
        counters[name] = dict(values)
    if counters:
        out["counters"] = counters
    return out
