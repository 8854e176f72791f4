"""Markdown tables of the port's dry-run records (the counterpart of
``repro/launch/report.py``): the roofline of each cell at an H100's
datasheet rates, single-pod (16 x 16 = 256 GPUs) and multi-pod
(2 x 16 x 16 = 512 GPUs); beside JAX's columns, the busiest rank's
compute term and a rank's peak with its ``rank_bounds`` bound. Printed,
or written to the path given.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--results DIR]
           [--out PATH]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .dryrun import rank_bounds
from .roofline import RESULTS, analyze


def fmt_row(r: dict, rec: dict) -> str:
    bound = rank_bounds(rec)["peak_bytes_est"] / 2**30
    return (f"| {r['arch']} | {r['shape']} | {r['t_compute_s']*1e3:.2f} | "
            f"{r['t_compute_rank_s']*1e3:.2f} | "
            f"{r['t_memory_s']*1e3:.2f} | {r['t_collective_s']*1e3:.2f} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{100*r['roofline_fraction']:.1f}% | {r['peak_gib']:.2f} | "
            f"{bound:.2f} |")


def build_tables(results: Path = RESULTS) -> str:
    rows_single, rows_multi = [], []
    for f in sorted(Path(results).glob("*.json")):
        rec = json.loads(f.read_text())
        (rows_single if rec["mesh"] == "single" else rows_multi).append(
            fmt_row(analyze(rec), rec))
    hdr = ("| arch | shape | compute ms | rank compute ms | memory ms | "
           "coll ms | dominant | useful | roofline | GiB/GPU | bound GiB |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|")
    out = ["### Roofline estimate -- single pod (16x16 = 256 H100s), per "
           "step\n", hdr]
    out += rows_single
    if rows_multi:
        out += ["", "### Multi-pod (2x16x16 = 512 H100s) -- collective "
                "figures include the pod axis\n", hdr]
        out += rows_multi
    out.append("\nSkipped cells: long_500k for the eight pure "
               "full-attention archs (whisper, qwen, mistral-nemo, stablelm, "
               "phi3, llama4, granite, llama-vision) -- see DESIGN.md "
               "section 5.")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    table = build_tables(Path(args.results))
    if args.out:
        Path(args.out).write_text(table + "\n")
    print(table)


if __name__ == "__main__":
    main()
