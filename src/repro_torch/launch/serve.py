"""Serving launcher CLI: continuous-batching decode server (the port's
``repro/launch/serve.py``).

``--arch`` takes any registered architecture, at smoke size; the audio and
VLM families decode against zero cross caches, as the JAX package's server
does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --requests 8 --slots 4 --max-new 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from ..configs import get_config
from ..models import init_model
from ..train import DecodeServer, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    params = init_model(0, cfg, device=args.device)
    srv = DecodeServer(cfg, params, slots=args.slots, max_len=args.max_len,
                       device=args.device)
    reqs = [Request(prompt=[1 + i, 2, 3], max_new_tokens=args.max_new,
                    temperature=args.temperature, rid=i)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = srv.run(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(c.tokens) for c in done)
    print(f"{len(done)} completions, {tok} tokens, {tok/dt:.1f} tok/s")


if __name__ == "__main__":
    main()
