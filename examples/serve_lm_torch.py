"""Batched LM serving through the port (the counterpart of
examples/serve_lm.py): continuous batching over decode slots -- finished
requests leave the batch, queued ones enter, shapes stay fixed.

Everything runs on the card by default; ``--device cpu`` runs on the CPU.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --requests 8 \
          --slots 3 [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.train import DecodeServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    print(f"initializing {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")
    params = init_model(0, cfg, device=dev)
    srv = DecodeServer(cfg, params, slots=args.slots, max_len=128,
                       device=dev)

    reqs = [Request(prompt=[1 + i, 2 + i, 3 + i], max_new_tokens=args.max_new,
                    temperature=0.0 if i % 2 == 0 else 0.8, rid=i)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = srv.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(c.tokens) for c in done)
    print(f"served {len(done)} requests / {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s) with {args.slots} slots in "
          f"{srv.ticks} ticks")
    for c in sorted(done, key=lambda c: c.rid):
        print(f"  request {c.rid}: {c.tokens}")


if __name__ == "__main__":
    main()
