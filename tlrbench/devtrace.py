"""What a traced run reads: the device's work from ``torch.profiler``, and
the live ranks that the sampling kernels were called with.

The profiler records the device's activity only (CUDA kernels, copies and
fills, and the runtime calls that launched them). Its cost per launch still
lengthens the profiled step (1.7x a factorization, 3-5x a solution), so
the idle share divides the busy seconds read here by an untraced step's
seconds (``readers.device_idle``).

``Recorder`` wraps the launching functions of the program's three sampling
kernels (``lr_sample``, ``tile_chain``, ``batched_gemm``) for the traced
step. For each call it keeps the shape and each factor's live rank, worked
out on the device without a host read: the count of columns that are not
zero in both factors at every 64th row (a column past a tile's rank is zero
in every row; a live column zero in all of those rows would be counted as
dead, which only lowers the bound). ``batched_gemm`` is passed its ranks,
and those are kept. The recorder works on a stream of its own, which it
marks with a sleep kernel at the start, in turn with the program's stream
(neither runs while the other's queued work does, so no kernel of the
program shares the card with it); the reduction leaves its operations out
of the device's busy time, its launches and its top operations, and counts
them as busy only where it looks for idle gaps. The ranks are read after
the window.

``reduce_events`` turns the events into the traced step's busy seconds,
kernel launches, the sampling kernels' device seconds, the device
operations that took the most time, and the idle gaps, each named by the
device operation the host launched at its end (what the host was working
towards while the device waited).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import tempfile
from pathlib import Path

import torch

from .frozen import counts, peaks

ROW_STEP = 64
# The sampling kernels' device functions, by name prefix.
SAMPLING_PREFIXES = {"bgemm": "batched_gemm", "tile_chain": "tile_chain",
                     "lr_sample": "lr_sample"}
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_family(name: str) -> str | None:
    key = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    for prefix, family in SAMPLING_PREFIXES.items():
        if key.startswith(prefix):
            return family
    return None


MARK_CYCLES = 1000


def _live_columns(U: torch.Tensor, V: torch.Tensor, r: int) -> torch.Tensor:
    """Per factor pair (leading dims), columns < r nonzero in both U and V
    at every ROW_STEP-th row."""
    u = U[..., ::ROW_STEP, :r].ne(0).any(dim=-2)
    v = V[..., ::ROW_STEP, :r].ne(0).any(dim=-2)
    return (u & v).sum(dim=-1, dtype=torch.int32)


class Recorder:
    """Records every sampling-kernel call made while :meth:`active` (see the
    module's docstring)."""

    def __init__(self):
        self.calls: list[tuple[str, tuple, torch.Tensor, int]] = []

    @contextlib.contextmanager
    def active(self):
        from repro_torch.kernels import batched_gemm as bg
        from repro_torch.kernels import lr_sample as lr
        from repro_torch.kernels import tlr_matvec as tc
        saved = (lr.lr_sample_cuda, tc.tile_chain_cuda, bg.batched_gemm_cuda)
        calls = self.calls
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            torch.cuda._sleep(MARK_CYCLES)

        def keep(kind, shape, itemsize, fn, *operands):
            """fn(*operands) on the recorder's stream, between the work
            queued so far and the work queued next."""
            main = torch.cuda.current_stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = fn(*operands)
            main.wait_stream(side)
            calls.append((kind, shape, out, itemsize))

        def lr_sample_cuda(Ui, Vi, W2, width=None):
            T, k, b, ldr = Ui.shape
            r = ldr if width is None else min(width, ldr)
            if k:
                keep("lr_sample", (T, k, b, r, W2.shape[-1]),
                     Ui.element_size(), _live_columns, Ui, Vi, r)
            return saved[0](Ui, Vi, W2, width)

        def tile_chain_cuda(U, V, X, width=None):
            T, b, ldr = U.shape
            r = ldr if width is None else min(width, ldr)
            keep("tile_chain", (T, b, r, X.shape[-1]), U.element_size(),
                 _live_columns, U, V, r)
            return saved[1](U, V, X, width)

        def batched_gemm_cuda(A, B, ranks):
            keep("batched_gemm", (A.shape[0], A.shape[1], A.shape[2],
                                  B.shape[-1]), A.element_size(),
                 torch.clone, ranks)
            return saved[2](A, B, ranks)

        lr.lr_sample_cuda = lr_sample_cuda
        tc.tile_chain_cuda = tile_chain_cuda
        bg.batched_gemm_cuda = batched_gemm_cuda
        try:
            yield self
        finally:
            lr.lr_sample_cuda, tc.tile_chain_cuda, bg.batched_gemm_cuda = saved
            torch.cuda.current_stream().wait_stream(side)

    def bound_seconds(self, dtype_name: str) -> float:
        """The recorded calls' summed roofline seconds at their live
        ranks."""
        total = 0.0
        for kind, shape, live, itemsize in self.calls:
            words, flops = counts.sampling_call(kind, shape,
                                                live.cpu().numpy())
            total += counts.bound_seconds(words, flops, itemsize,
                                          peaks.PEAK_FLOPS[dtype_name],
                                          peaks.PEAK_BYTES_PER_S)
        return total


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block (the device's activity only); yields a
    dict that holds the profiler once the block has ended (read its events
    with :func:`events` after the measured window)."""
    from torch.profiler import ProfilerActivity, profile
    out: dict = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
    out["profiler"] = prof


def events(held: dict) -> list:
    """The device's work that the profiler recorded: (category, name,
    start ns, duration ns, stream) of every kernel, copy and fill, from the
    profiler's own events (:func:`chrome_events` reads the same from its
    Chrome trace, some minutes for a million kernels)."""
    from torch.autograd import DeviceType
    out = []
    for e in held["profiler"].profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        cat = ("gpu_memcpy" if name.startswith("Memcpy") else
               "gpu_memset" if name.startswith("Memset") else "kernel")
        out.append((cat, name, e.start_ns(), e.duration_ns(),
                    e.device_resource_id()))
    return out


def chrome_events(held: dict) -> list:
    """:func:`events` from the profiler's Chrome trace (written to a
    temporary file and read back); the tests hold the two to each other."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        held["profiler"].export_chrome_trace(str(path))
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    return [(e["cat"], e.get("name", ""), int(round(float(e["ts"]) * 1e3)),
             int(round(float(e.get("dur", 0)) * 1e3)),
             (e.get("args") or {}).get("stream", e.get("tid")))
            for e in raw if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK]


def _union(intervals: list) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def short_name(name: str) -> str:
    """A device operation's name without its return type and parameter
    list, at most 80 characters."""
    key, depth = name.removeprefix("void "), 0
    for i, ch in enumerate(key):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            key = key[:i]
            break
    return key.strip()[:80]


def reduce_events(events: list, window_s: float, top: int = 10) -> dict:
    """The traced step's numbers from its device events (category, name,
    start ns, duration ns, stream)."""
    marked = {st for cat, name, s, dur, st in events
              if cat == "kernel" and "sleep" in name.lower()
              or cat == "kernel" and "spin" in name.lower()}
    work = sorted((s, dur, name, cat) for cat, name, s, dur, st in events
                  if st not in marked)
    busy_s = sum(e - s for s, e in _union([(s, s + dur)
                                          for s, dur, _, _ in work])) / 1e9
    busy = _union([(s, s + dur) for _, _, s, dur, _ in events])
    by_name: dict = collections.defaultdict(float)
    sampling = 0.0
    for s, dur, name, cat in work:
        by_name[short_name(name)] += dur / 1e9
        if cat == "kernel" and kernel_family(name):
            sampling += dur / 1e9
    # each gap, named by the first operation to start at or after its end
    starts = [w[0] for w in work]
    by_gap: dict = collections.defaultdict(float)
    for i in range(len(busy) - 1):
        a, b = busy[i][1], busy[i + 1][0]
        k = bisect.bisect_left(starts, b)
        nxt = short_name(work[k][2]) if k < len(work) else "(recorder)"
        by_gap["before " + nxt] += (b - a) / 1e9
    return {
        "busy_s": busy_s, "window_s": window_s,
        "launches": sum(1 for w in work if w[3] == "kernel"),
        "recorder_streams": len(marked),
        "recorder_device_ops": len(events) - len(work),
        "sampling_device_s": sampling,
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in by_gap.items()),
                            key=lambda kv: -kv[1])[:top],
    }
