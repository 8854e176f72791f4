#!/usr/bin/env python3
"""Times the right-looking Cholesky under the sequential and the lookahead
schedule on one card, and measures how much of the lookahead's second
stream overlaps the first.

The operator is chip_smoke.py's right path (2-D exponential covariance,
N = 8192, tile 128, compressed at 1e-8, r_max 128; eps 1e-6). For each
``batching`` value it runs sequential, lookahead, lookahead, sequential
(host wall clock ending in a device synchronize), then one factorization of
each schedule under torch.profiler, and from the trace's kernel, copy and
set events reports, per schedule: the span of device activity, the device
busy time (the union of all events), each stream's busy time, and the time
two streams were busy at once (the sum over streams less the union).

Run from the root of a checkout:  python3 tools/lookahead_overlap.py
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _union(intervals) -> float:
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur else 0.0)


def stream_busy(trace: Path) -> dict:
    """Device activity of a chrome trace: span, busy (union), per-stream
    busy and their overlap, in ms."""
    events = json.loads(trace.read_text())["traceEvents"]
    streams: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            streams.setdefault(e["args"].get("stream"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    every = [iv for ivs in streams.values() for iv in ivs]
    busy = _union(every)
    per = {str(k): _union(v) / 1e3 for k, v in streams.items()}
    return {"span_ms": (max(e for _, e in every) - min(s for s, _ in every))
            / 1e3, "busy_ms": busy / 1e3, "streams_ms": per,
            "overlap_ms": sum(per.values()) - busy / 1e3}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lookahead_overlap: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import CholOptions, TLROperator, covariance_problem

    dev = cs.device_line()
    cs.build_kernels()
    n, tile = cs.N_RIGHT, cs.TILE_RIGHT
    _, K = covariance_problem(n, 2, tile, device="cuda")
    op = TLROperator.compress(K, tile, r_max=cs.R_MAX, eps=1e-8,
                              method="svd")
    del K
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for batching in ("flat", "ranked"):
            secs = {False: [], True: []}
            for la in (False, True, True, False):
                opts = CholOptions(eps=cs.EPS, algo="right",
                                   batching=batching, lookahead=la)
                _, sec = cs.sync_time(lambda: op.cholesky(opts))
                secs[la].append(sec)
            for la in (False, True):
                opts = CholOptions(eps=cs.EPS, algo="right",
                                   batching=batching, lookahead=la)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    cs.sync_time(lambda: op.cholesky(opts))
                path = Path(tmp) / f"{batching}_{la}.json"
                prof.export_chrome_trace(str(path))
                name = f"{batching}_{'lookahead' if la else 'sequential'}"
                out[name] = {"seconds": secs[la], **stream_busy(path)}
                cs.log(f"{name}: seconds {secs[la]}; profiled: "
                       + json.dumps({k: v for k, v in out[name].items()
                                     if k != "seconds"}))
    cs.log(dev["nvidia_smi"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
