"""Gaussian-process workflow on a TLR-factored covariance, on the
PyTorch/CUDA port: log-likelihood evaluation and posterior sampling (the
paper's spatial-statistics use case), through the operator-first API --
the correlation-length sweep builds each candidate operator directly from
the point cloud with ``TLROperator.from_kernel``. The counterpart of
examples/gaussian_process.py.

Everything runs on the card by default; ``--device cpu`` runs the plain
versions of the kernels. ``--trace PATH`` records the port's telemetry
(``repro_torch.obs``) over the whole workflow and writes it as a
Chrome-trace / Perfetto JSON.

Run:  PYTHONPATH=src python examples/gaussian_process_torch.py [--n 2048]
      [--trace out.json] [--device cpu]
"""

import argparse
import math

import torch

from repro_torch import obs
from repro_torch.core import CholOptions, TLROperator, covariance_problem
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record telemetry and write a Chrome-trace / "
                         "Perfetto JSON (load at ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.trace:
        obs.enable()

    pts, K = covariance_problem(args.n, 2, args.tile, geometry="ball", seed=3,
                                device=dev)
    op = TLROperator.compress(K, args.tile, eps=1e-8)
    fact = op.cholesky(CholOptions(eps=1e-6, bs=16))

    # draw a "true" field and observe it
    g = torch.Generator(device=dev).manual_seed(1)
    y = fact.sample(generator=g)
    print(f"sampled GP field: n={args.n}, std={float(y.std()):.3f}")

    # log-likelihood:  -0.5 (y^T K^{-1} y + logdet K + n log 2pi)
    alpha = fact.solve(y)
    ll = -0.5 * (float(y @ alpha) + float(fact.logdet())
                 + args.n * math.log(2 * math.pi))
    # dense reference
    ll_ref = -0.5 * (float(y @ torch.linalg.solve(K, y))
                     + float(torch.linalg.slogdet(K)[1])
                     + args.n * math.log(2 * math.pi))
    print(f"TLR log-likelihood:   {ll:.3f}")
    print(f"dense log-likelihood: {ll_ref:.3f}")
    print(f"abs diff: {abs(ll - ll_ref):.2e}")

    # sweep the correlation length: model selection via TLR loglik, each
    # candidate operator built straight from the (KD-ordered) points
    print(f"{'ell':>6} {'loglik':>12}")
    for ell in (0.05, 0.1, 0.2, 0.4):
        oe = TLROperator.from_kernel(pts, "exp", tile=args.tile, eps=1e-8,
                                     ell=ell, device=dev)
        fe = oe.cholesky(CholOptions(eps=1e-6, bs=16))
        a = fe.solve(y)
        l = -0.5 * (float(y @ a) + float(fe.logdet())
                    + args.n * math.log(2 * math.pi))
        print(f"{ell:>6} {l:>12.2f}")

    if args.trace:
        obs.record_retraces()
        obs.export_chrome_trace(args.trace)
        snap = obs.metrics_snapshot()
        obs.disable()
        print(f"wrote {args.trace}: {snap['spans']} spans, "
              f"wall {snap['wall_s']:.2f}s"
              + (f", padded/useful {snap['padded_flop_ratio']:.2f}"
                 if "padded_flop_ratio" in snap else ""))


if __name__ == "__main__":
    main()
