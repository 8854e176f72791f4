#!/usr/bin/env python3
"""Where a training step and a decode tick of the dense LM path spend their
time on the card: qwen1.5-0.5b at its published width (bf16, remat), one
``Trainer`` step of 8 x 1024 tokens and one ``DecodeServer`` step of 4
slots, each after two warm calls, under ``torch.profiler`` (CPU and CUDA
activities). Prints the wall seconds, the device time summed over the
kernels, the number of kernel launches and the ops with the most device
time.

Run from the root of a checkout on a machine with a card:
    python3 tools/lm_profile.py [--rows 15]
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
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import DecodeServer, TrainConfig, Trainer

    cfg = get_config("qwen1.5-0.5b")
    tr = Trainer(cfg, TrainConfig(batch=8, seq_len=1024))
    state = {"params": init_model(0, cfg)}
    state["ostate"] = adamw_init(state["params"], tr.tcfg.optimizer)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in tr.data.batch_at(0).items()}

    def step():
        _, grads, _ = tr.fwd_bwd(state["params"], batch)
        state["params"], state["ostate"] = tr.apply(
            grads, state["ostate"], state["params"])

    profiled(step, args.rows, "train step (8 x 1024 tokens)")
    del state["ostate"]
    torch.cuda.empty_cache()
    srv = DecodeServer(cfg, state["params"], slots=4, max_len=256)
    tok = torch.ones((4, 1), dtype=torch.int32, device="cuda")

    def tick():
        logits, srv.caches = srv._serve(srv.params, srv.caches, tok, 10)
        logits[:, 0].float().cpu()

    profiled(tick, args.rows, "decode tick (4 slots, position 10)")
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
