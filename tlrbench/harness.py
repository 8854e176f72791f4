"""One run of one benchmark cell.

``run_cell`` reads the cell from ``BENCHMARK.json`` at the checkout's root,
and everything that belongs to one configuration, traffic mix or metric
from a file of its own, found by name:

* the configuration: the ``file`` its entry names, a JSON object whose
  ``problem`` names a generator ``frozen/problems/<problem>.py``;
* the traffic mix: ``tlrbench/traffic/<traffic>.json``, whose ``step``
  names a step kind ``tlrbench/steps/<step>.py`` and whose other keys are
  that step's parameters;
* the limits of the correctness numbers: ``tlrbench/limits/<cell>.json``;
* each metric: ``tlrbench/metrics/<name>.py``, whose ``read(record)``
  returns the metric's value or None when the record has nothing for it.

Set-up (imports, the kernel libraries, the inputs from the seed, a warm-up
step on a small operator of the same kind) is timed apart; then whole
steps run back to back, each ending in a device synchronisation, until
``seconds`` have passed. A traced run first profiles one step and records
the sampling kernels' calls in it, then runs the window's steps untraced. After the window the peak
memory is read, the program's state is released, and the reference judges
the answers.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BENCH_DIR = "tlrbench"


class Fatal(Exception):
    """A run that must print no result."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared as
    whole names (``repro_torch`` is not ``repro``)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entries and files: workload, config, traffic, limits and
    the metrics it reports at each trace setting."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Fatal(f"unknown workload {workload!r}; BENCHMARK.json has "
                    f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    base = root / BENCH_DIR
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits_file = base / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() \
        else {}

    def applies(m: dict) -> bool:
        return workload in m.get("workloads", [workload])

    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "metrics": {
                0: [m for m in bench["end_to_end"] if applies(m)],
                1: [m for m in bench["per_layer"] if applies(m)]},
            "metric_dir": base / "metrics"}


def read_metric(metric_dir: Path, name: str, record: dict):
    spec = importlib.util.spec_from_file_location(
        f"tlrbench_metric_{name.replace('.', '_').replace('-', '_')}",
        metric_dir / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


class Device:
    """Synchronisation and memory readings of the run's device."""

    def __init__(self, torch, name: str):
        self.torch, self.type = torch, name
        self.cuda = name == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self):
        return self.torch.cuda.max_memory_allocated() if self.cuda else None


def _seconds(t0: float) -> float:
    return time.perf_counter() - t0


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> dict:
    """One run; returns the result object (the last line the command
    prints). ``t_start`` is the process's start on the host clock. On
    ``"cuda"`` it first looks for the cards the cell asks for (never falling
    back to the CPU); the tests drive the rest of a run on ``"cpu"``."""
    spec = load_cell(root, workload)
    split = {"start_s": _seconds(t_start)}
    t0 = time.perf_counter()
    import torch
    split["torch_s"] = _seconds(t0)
    t0 = time.perf_counter()
    if device == "cuda":
        need = int(spec["cell"]["chips"])
        if not torch.cuda.is_available():
            raise Fatal("no CUDA card: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < need:
            raise Fatal(f"the cell needs {need} cards and this process "
                        f"sees {torch.cuda.device_count()}")
        torch.zeros(1, device="cuda")
    split["device_s"] = _seconds(t0)
    t0 = time.perf_counter()
    import repro_torch  # noqa: F401  (the program under test)
    from tlrbench.frozen import problems
    split["program_s"] = _seconds(t0)
    dev = Device(torch, device)

    t0 = time.perf_counter()
    built = []
    if dev.cuda:
        from repro_torch.kernels import build
        built = build.build_all().get("built", [])
        for name in build.SOURCES:
            build.library(name)
    split.update(kernels_s=_seconds(t0), built=built)

    cfg, traffic = spec["config"], spec["traffic"]
    step_mod = importlib.import_module(f"tlrbench.steps.{traffic['step']}")
    t0 = time.perf_counter()
    inputs = problems.build(cfg, seed, device)
    dev.sync()
    split["inputs_s"] = _seconds(t0)

    t0 = time.perf_counter()
    small = problems.build(cfg, seed, device, n=cfg["warm_n"])
    warm = step_mod.Step(small, cfg, traffic, seed)
    warm.run(0)
    dev.sync()
    del warm, small
    split["warmup_s"] = _seconds(t0)
    t0 = time.perf_counter()
    step = step_mod.Step(inputs, cfg, traffic, seed)
    description = step.describe()
    split["step_s"] = _seconds(t0)
    if trace:
        from tlrbench import devtrace as tr
    # garbage of the set-up collected, what survives it left out of every
    # later collection
    gc.collect()
    gc.freeze()
    setup_s = _seconds(t_start)
    split["setup_s"] = setup_s
    print(json.dumps({"setup": split, "inputs": description}), flush=True)

    dev.reset_peak()
    steps, traced = [], None
    t_win = time.perf_counter()
    while not steps or time.perf_counter() - t_win < seconds \
            or trace and len(steps) < 2:
        i = len(steps)
        t0 = time.perf_counter()
        if trace and i == 0 and dev.cuda:
            recorder = tr.Recorder()
            with tr.profiled() as prof, recorder.active():
                extra = step.run(i)
                dev.sync()
                s = _seconds(t0)
            traced = (prof, recorder, s)
            # the profiled step and the profiler's stop stand outside the
            # measured time: the window's untraced steps still fill it
            t_win = time.perf_counter()
        else:
            extra = step.run(i)
            dev.sync()
            s = _seconds(t0)
        steps.append({"seconds": s, "traced": traced is not None and i == 0,
                      **extra})
    window_s = _seconds(t_win)
    peak = dev.peak_bytes()
    found = forbidden_modules()
    if found:
        raise Fatal(f"modules of JAX or of the JAX package are loaded: "
                    f"{found}")

    record = {"steps": steps, "window_s": window_s, "setup_s": setup_s,
              "peak_bytes": peak, "trace": None, "work": None}
    if traced is not None:
        prof, recorder, s = traced
        t0 = time.perf_counter()
        red = tr.reduce_events(tr.events(prof), s)
        red["sampling_bound_s"] = recorder.bound_seconds(cfg["dtype"])
        red["read_s"] = _seconds(t0)
        record["trace"] = red
        log("trace: " + json.dumps({k: v for k, v in red.items()
                                    if k not in ("device_ops",
                                                 "idle_gaps")}))
        del prof, recorder, traced
    if trace:
        record["work"] = step.work()
    numbers, attempted, failed = step.judge()
    checks, readings = {}, {}
    correct = failed == 0 and attempted > 0
    for name, value in numbers.items():
        limit = spec["limits"].get(name)
        if limit is None:
            readings[name] = value
            log(f"reading {name}: {value!r} (not compared)")
            continue
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            correct = False
            failed = max(failed, 1)
    metrics = {}
    for m in spec["metrics"][int(trace)]:
        value = read_metric(spec["metric_dir"], m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info(torch, dev, peak)}
    if record["trace"] is not None:
        t = record["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["readings"] = readings
    result["checks"] = checks
    log("steps: " + json.dumps([round(s["seconds"], 4) for s in steps]))
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    return result


def device_info(torch, dev: Device, peak) -> dict:
    if not dev.cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak,
            "nvidia_smi": smi.splitlines()[0] if smi else ""}


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start)
    except Fatal as e:
        print(f"tlrbench: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0
