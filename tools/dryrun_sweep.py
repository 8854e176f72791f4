"""Runs dry-run cells at full depth, each in a process of its own
(``python -m repro_torch.launch.dryrun --arch A --shape S --mesh M``),
``--jobs`` at a time, each cut at ``--timeout`` seconds, then prints the
roofline tables of the records (``launch/report.py``):

    python3 tools/dryrun_sweep.py --out build/sweep \
        qwen1_5_0_5b:train_4k mistral_nemo_12b:decode_32k ...

A cell is ``arch:shape`` (``--mesh`` for all of them). Each cell's log and
record go to ``--out``; a line per cell gives its status and seconds.
Exits 1 if a cell failed or timed out.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+", metavar="ARCH:SHAPE")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (the dry run's default: "
                         "cuda)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    todo = [c.split(":") for c in args.cells]
    running: list = []
    failed = 0
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, shape = todo.pop(0)
            log = open(out / f"{arch}__{shape}.log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", args.mesh]
            if args.device:
                cmd += ["--device", args.device]
            running.append((arch, shape, log, time.perf_counter(),
                            subprocess.Popen(cmd, cwd=ROOT, env=env,
                                             stdout=log,
                                             stderr=subprocess.STDOUT)))
        time.sleep(1.0)
        for item in list(running):
            arch, shape, log, t0, proc = item
            sec = time.perf_counter() - t0
            if proc.poll() is None and sec < args.timeout:
                continue
            status = "ok" if proc.poll() == 0 else \
                "timeout" if proc.poll() is None else f"rc {proc.returncode}"
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            failed += status != "ok"
            print(f"{arch} {shape} {status} {sec:.1f}", flush=True)
            running.remove(item)
    results = ROOT / "results" / "dryrun_torch"
    for f in results.glob("*.json"):
        shutil.copy(f, out / f.name)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.report import build_tables
    print(build_tables(results))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
