"""End-to-end LM training through the port (the counterpart of
examples/train_lm.py): a dense registry architecture, the synthetic
corpus, checkpoint/restart, optional ARA gradient compression.

Presets:
  smoke -- reduced config, 200 steps (a minute or two on a CPU)
  100m  -- the architecture's published width trimmed to 12 layers in
           float32 (sized for the card)

Everything runs on the card by default; ``--device cpu`` runs on the CPU.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --arch qwen1.5-0.5b \
          --preset smoke --steps 200 [--device cpu]
Kill and re-run with the same --ckpt-dir to see auto-resume; SIGTERM
triggers a preemption checkpoint (fault-tolerance demo).
"""

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.optim import AdamWConfig, CompressConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--preset", choices=["smoke", "100m"], default="smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm_torch")
    ap.add_argument("--compress-rank", type=int, default=0,
                    help="enable ARA low-rank gradient compression")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.preset == "smoke":
        cfg = get_config(args.arch, smoke=True)
        batch, seq = args.batch or 8, args.seq or 128
    else:
        cfg = dataclasses.replace(get_config(args.arch), num_layers=12,
                                  dtype="float32", remat=False)
        batch, seq = args.batch or 8, args.seq or 512
        print(f"~{cfg.param_count()/1e6:.0f}M params")

    tcfg = TrainConfig(
        steps=args.steps, batch=batch, seq_len=seq,
        ckpt_dir=args.ckpt_dir, save_every=max(args.steps // 4, 10),
        log_every=10, metrics_path=f"{args.ckpt_dir}/metrics.jsonl",
        optimizer=AdamWConfig(lr=args.lr),
        compress=CompressConfig(rank=args.compress_rank)
        if args.compress_rank else None,
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    try:
        out = trainer.run()
    finally:
        trainer.close()
    losses = out["losses"]
    if losses:
        print(f"status={out['status']} step={out['step']} "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
