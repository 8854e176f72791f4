"""Readings shared by the metric files in ``metrics/``.

A record holds the window's steps (``seconds``, ``traced`` and the step's
own numbers), ``window_s``, ``setup_s``, ``peak_bytes``, and in a traced
run ``trace`` (the reduced profile of the first step, ``devtrace.py``) and
``work`` (each step's FLOPs, ``frozen/counts.py``). A reading that the
record cannot give is None, and the harness leaves that metric out.
"""

from __future__ import annotations

from tlrbench.frozen import peaks


def per_step_seconds(record: dict):
    """The window's time over the whole steps in it."""
    return record["window_s"] / len(record["steps"])


def untraced(record: dict) -> list:
    """Indices of the steps the profiler did not record (all steps when
    the profiler recorded every one)."""
    idx = [i for i, s in enumerate(record["steps"]) if not s["traced"]]
    return idx or list(range(len(record["steps"])))


def step_mean(record: dict, key: str):
    idx = untraced(record)
    vals = [record["steps"][i][key] for i in idx]
    return sum(vals) / len(vals) if vals else None


def fp64_share(record: dict):
    """The steps' FLOPs over their seconds, as a percentage of the FP64
    peak (the profiled step left out where others ran)."""
    if not record.get("work"):
        return None
    idx = untraced(record)
    flops = sum(record["work"][i] for i in idx)
    secs = sum(record["steps"][i]["seconds"] for i in idx)
    return 100.0 * flops / secs / peaks.PEAK_FLOPS["float64"]


def sampling_roofline(record: dict):
    t = record.get("trace")
    if not t or t["sampling_device_s"] <= 0:
        return None
    return 100.0 * t["sampling_bound_s"] / t["sampling_device_s"]


def device_idle(record: dict):
    """The share of a step's time with no operation on the device: the
    busy seconds the profiler measured in the traced step, over the mean
    seconds of the steps it did not trace (the profiler's cost per launch
    lengthens the traced step itself 1.7 to 5 times)."""
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / step_mean(record, "seconds"))


def launches(record: dict):
    t = record.get("trace")
    return None if not t else float(t["launches"])
