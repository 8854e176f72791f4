"""Roofline analysis over the port's dry-run records (the counterpart of
``repro/launch/roofline.py``), at an NVIDIA H100 SXM's datasheet rates.

Per (arch x shape x mesh) cell, the three roofline terms in seconds:

  compute    = FLOPs / (GPUs x 989.4e12 dense bf16 FLOP/s)
  memory     = HBM traffic / (GPUs x 3.35e12 B/s)
  collective = sum over link kinds of one GPU's collective bytes on them
               / that link's rate

FLOPs are the dry run's whole-module count of the unpartitioned step
(``step_cost``) split evenly over the GPUs, as JAX's ``analyze`` splits
it; ``t_compute_rank_s`` is the busiest rank's own FLOPs (work the rules
leave whole over the model axis repeats on each of its ranks). HBM traffic
is the analytic model (``analytic_traffic``), the collective bytes one
rank's, by op and by link. A collective whose group
lies inside one node of 8 GPUs runs over NVLink (450e9 B/s each way per
GPU); one whose group crosses nodes over the network, 50e9 B/s per GPU
(one NDR InfiniBand port, 400 Gb/s, per GPU). On the (16, 16) mesh both
axes cross nodes: the 16-wide model axis spans two nodes. These are
estimates at datasheet constants, not measurements. MODEL_FLOPS = 6*N*D
for training (2*N*D inference), N = active params, D = processed tokens;
MODEL_FLOPS / FLOPs exposes remat, causal-rectangle and dispatch waste.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--results DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

# NVIDIA H100 SXM5 datasheet: dense BF16 tensor-core rate, HBM3 rate
PEAK_FLOPS = 989.4e12      # FLOP/s per GPU
HBM_BW = 3.35e12           # B/s per GPU
# NVLink 4 (900 GB/s per GPU both ways), and one NDR 400 Gb/s port a GPU
LINK_BW = {"node": 450e9, "network": 50e9}   # B/s per GPU, each way

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,          # one token per sequence
    "long_500k": 1,
}
SHAPE_KIND = {
    "train_4k": "train", "prefill_32k": "prefill",
    "decode_32k": "decode", "long_500k": "decode",
}


def analyze(rec: dict) -> dict:
    from ..configs import get_config
    from ..models.config import SHAPES
    from .costmodel import analytic_traffic
    from .dryrun import default_microbatches

    chips = rec["devices"]
    flops_total = rec["cost"]["flops_total"]
    cfg = get_config(rec["arch"])
    if rec.get("num_layers", cfg.num_layers) != cfg.num_layers:
        # a cell run at cut depth: its traffic at that depth too
        cfg = dataclasses.replace(cfg, num_layers=rec["num_layers"])
    spec = SHAPES[rec["shape"]]
    traffic_total = analytic_traffic(
        cfg, spec, default_microbatches(cfg) if spec.kind == "train" else 1)

    t_compute = flops_total / (chips * PEAK_FLOPS)
    t_memory = traffic_total / (chips * HBM_BW)
    t_coll = sum(b / LINK_BW[link]
                 for links in rec["collectives"]["bytes_by_link"].values()
                 for link, b in links.items())

    shape = rec["shape"]
    tokens = SHAPE_TOKENS[shape]
    n_active = rec["model"]["active_params"]
    factor = 6 if SHAPE_KIND[shape] == "train" else 2
    model_flops = factor * n_active * tokens

    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = max(terms.values())
    return {
        "arch": rec["arch"], "shape": shape, "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_compute_rank_s": rec["cost"].get("flops_per_rank",
                                            flops_total / chips)
        / PEAK_FLOPS,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops": flops_total,
        "useful_ratio": model_flops / flops_total if flops_total else 0.0,
        # fraction of peak the step would achieve if it runs at the
        # bound implied by the dominant term:
        "roofline_fraction": (model_flops / (chips * PEAK_FLOPS)) / t_bound
        if t_bound > 0 else 0.0,
        "peak_gib": rec["memory"]["peak_bytes_est"] / 2**30,
        "trace_s": rec.get("trace_s"),
        "coll_by_op": rec["collectives"]["bytes_by_op"],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rows = []
    for f in sorted(Path(args.results).glob("*.json")):
        rec = json.loads(f.read_text())
        if args.mesh != "all" and rec["mesh"] != args.mesh:
            continue
        rows.append(analyze(rec))
    if not rows:
        print("no dry-run records found; run repro_torch.launch.dryrun first")
        return
    hdr = (f"{'arch':<28} {'shape':<12} {'compute':>10} {'memory':>10} "
           f"{'coll':>10} {'dom':>7} {'useful':>7} {'roofline%':>9} "
           f"{'GiB/GPU':>8}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['arch']:<28} {r['shape']:<12} "
              f"{r['t_compute_s']:>10.4f} {r['t_memory_s']:>10.4f} "
              f"{r['t_collective_s']:>10.4f} {r['dominant']:>7} "
              f"{r['useful_ratio']:>7.2f} {100*r['roofline_fraction']:>8.1f}% "
              f"{r['peak_gib']:>8.2f}")


if __name__ == "__main__":
    main()
