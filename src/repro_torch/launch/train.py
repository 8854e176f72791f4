"""Training launcher CLI (the port's ``repro/launch/train.py``).

Single process: runs the Trainer on one device (the card unless
``--device cpu``). ``--arch`` takes any registered architecture whose
batches are tokens alone (dense, MoE, SSM, hybrid); the audio and VLM
families also need frames / patches, which the synthetic pipeline does not
carry, as in the JAX package: they train through ``build_loss_fn`` with
``materialize_inputs``' context.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 100 --batch 8 --seq 128 [--smoke] [--compress-rank 8] \
      [--device cpu]
"""

from __future__ import annotations

import argparse

from ..configs import get_config
from ..optim import AdamWConfig, CompressConfig
from ..train import TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/launch_train")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--compress-rank", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(
        steps=args.steps, batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        metrics_path=f"{args.ckpt_dir}/metrics.jsonl",
        optimizer=AdamWConfig(lr=args.lr),
        compress=CompressConfig(rank=args.compress_rank)
        if args.compress_rank else None,
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    try:
        out = trainer.run()
    finally:
        trainer.close()
    print(f"status={out['status']} final_step={out['step']}")
    if out["losses"]:
        print(f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
