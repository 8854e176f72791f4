"""Chrome-trace / Perfetto export of a telemetry recording.

Port of ``repro/obs/chrome_trace.py``. ``export_chrome_trace(path)`` writes
the active (or a given) :class:`~repro_torch.obs.telemetry.Telemetry` as
Chrome Trace Event JSON -- the ``{"traceEvents": [...]}`` object format
that ``ui.perfetto.dev`` and ``chrome://tracing`` load directly. Each
telemetry category becomes its own named track (thread) so the layers read
as parallel swimlanes: factorization phase spans on one, plan-dispatch
bucket spans nested below them, server tick stages on another. Counter
samples (retrace registry, occupancy) become ``ph="C"`` counter tracks.

Format notes (the parts Perfetto actually validates):

* complete events: ``ph="X"`` with ``ts``/``dur`` in *microseconds*,
  plus ``pid``/``tid`` integers selecting the track;
* metadata events: ``ph="M"``, ``name="process_name"`` /
  ``"thread_name"`` with the label in ``args.name``;
* counters: ``ph="C"`` with the series in ``args``.

This is the host-side view. The device timeline of the same run comes
from ``torch.profiler`` (``prof.export_chrome_trace``), whose user ranges
carry these span names.
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from . import telemetry as _tel

_PID = 1

# Stable track order: known categories first, anything novel appended.
_TRACKS = {"factor": 1, "solve": 2, "algebra": 3, "serve": 4, "": 9}

_TRACK_NAMES = {
    "factor": "factorize (chol drivers)",
    "solve": "solve/matvec (TilePlan dispatch)",
    "algebra": "tile algebra (round/gemm/syrk)",
    "serve": "TLRServer ticks",
    "": "misc",
}

_COUNTER_TID = 90


def _json_safe(v):
    """Span attrs may hold numpy scalars or 0-d tensors; coerce to plain
    JSON types (anything else becomes its string)."""
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, (int, float, str)):
        return v
    if isinstance(v, torch.Tensor) and v.dim() != 0:
        return str(v)
    try:
        item = v.item()  # numpy scalar, 0-d tensor
    except (AttributeError, ValueError):
        return str(v)
    return item if isinstance(item, (int, float, bool, str)) else str(item)


def to_chrome_trace(tel: Optional["_tel.Telemetry"] = None) -> dict:
    """Build the Chrome-trace object for ``tel`` (default: the active
    recording). Raises if telemetry was never enabled."""
    tel = tel if tel is not None else _tel.current()
    if tel is None:
        raise RuntimeError(
            "no telemetry recording: call obs.enable() before the run, "
            "or pass the Telemetry returned by obs.disable()")

    tracks = dict(_TRACKS)
    events = [{"ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
               "args": {"name": "repro-tlr"}}]

    def track(cat: str) -> int:
        if cat not in tracks:
            tracks[cat] = 10 + len(tracks)
        return tracks[cat]

    for sp in sorted(tel.spans, key=lambda s: (s.ts, s.id)):
        ev = {"ph": "X", "pid": _PID, "tid": track(sp.cat),
              "name": sp.name, "cat": sp.cat or "span",
              "ts": sp.ts * 1e6, "dur": sp.dur * 1e6}
        if sp.args:
            ev["args"] = _json_safe(sp.args)
        events.append(ev)

    for name, ts, values in tel.counters:
        events.append({"ph": "C", "pid": _PID, "tid": _COUNTER_TID,
                       "name": name, "ts": ts * 1e6,
                       "args": _json_safe(values)})

    for cat, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": _TRACK_NAMES.get(cat, cat)}})
    if tel.counters:
        events.append({"ph": "M", "pid": _PID, "tid": _COUNTER_TID,
                       "name": "thread_name", "args": {"name": "counters"}})

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str,
                        tel: Optional["_tel.Telemetry"] = None) -> dict:
    """Write the Chrome-trace JSON for ``tel`` (default: active recording)
    to ``path``; returns the object written."""
    obj = to_chrome_trace(tel)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj
