#!/usr/bin/env python3
"""Where a training step and a decode tick of an LM spend their time on the
card: an architecture at its published width (bf16, remat; qwen1.5-0.5b
unless ``--arch``), one ``Trainer`` step of ``--batch`` x 1024 tokens
(with the family's frames / patches, as ``chip_smoke.py``'s path 14 draws
them) and one ``DecodeServer`` step of 4 slots, each after two warm calls,
under ``torch.profiler`` (CPU and CUDA activities). Prints the wall
seconds, the device time summed over the kernels, the number of kernel
launches and the ops with the most device time. ``--steps-at LR ...``
first trains path 14's ``FAM_STEPS`` steps from the initial state at each
learning rate and prints the losses.

Run from the root of a checkout on a machine with a card:
    python3 tools/lm_profile.py [--arch mamba2-130m] [--batch 8]
        [--steps-at 3e-4 5e-5] [--rows 15]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profiled(fn, rows: int, label: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in events) / 1e3
    print(f"{label}: {wall:.3f} s wall under the profiler, {device_ms:.1f} "
          f"ms of kernel time in {len(events)} kernels", flush=True)
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=rows), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=15)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps-at", type=float, nargs="*", default=[],
                    metavar="LR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import DecodeServer, TrainConfig, Trainer

    chip_smoke.device_line()
    cfg = get_config(args.arch)
    for lr in args.steps_at:
        tr = Trainer(cfg, TrainConfig(batch=args.batch, seq_len=1024,
                                      optimizer=AdamWConfig(lr=lr)))
        losses, dts, peak, _ = chip_smoke.fam_steps(cfg, tr, "cuda")
        print(f"{cfg.name} at learning rate {lr:g}: losses {losses}, step "
              f"seconds {[round(x, 3) for x in dts]}, peak "
              f"{peak / 2**30:.2f} GiB", flush=True)
        del tr
        torch.cuda.empty_cache()
    tr = Trainer(cfg, TrainConfig(batch=args.batch, seq_len=1024))
    state = {"params": init_model(0, cfg)}
    state["ostate"] = adamw_init(state["params"], tr.tcfg.optimizer)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in tr.data.batch_at(0).items()}
    batch.update(chip_smoke.context_input(cfg, args.batch, 0, "cuda", 1024))

    def step():
        _, grads, _ = tr.fwd_bwd(state["params"], batch)
        state["params"], state["ostate"] = tr.apply(
            grads, state["ostate"], state["params"])

    profiled(step, args.rows, f"{cfg.name} train step ({args.batch} x 1024 "
             f"tokens)")
    del state["ostate"]
    torch.cuda.empty_cache()
    srv = DecodeServer(cfg, state["params"], slots=4, max_len=256)
    tok = torch.ones((4, 1), dtype=torch.int32, device="cuda")

    def tick():
        logits, srv.caches = srv._serve(srv.params, srv.caches, tok, 10)
        logits[:, 0].float().cpu()

    profiled(tick, args.rows, f"{cfg.name} decode tick (4 slots, position "
             f"10)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
