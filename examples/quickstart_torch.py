"""Quickstart on the PyTorch/CUDA port: build a spatial-statistics
covariance matrix, factor it in TLR form with ARA, solve, and sample -- the
paper's core workflow, through the operator-first API (compress -> factor
-> solve/logdet/sample). The counterpart of examples/quickstart.py, with
the same prints.

Everything runs on the card by default; ``--device cpu`` runs the plain
versions of the kernels.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--n 2048]
      [--eps 1e-6] [--device cpu]
"""

import argparse

import torch

from repro_torch.core import CholOptions, TLROperator, covariance_problem
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"building {args.dim}D exponential covariance, N={args.n}, "
          f"tile={args.tile}")
    pts, K = covariance_problem(args.n, args.dim, args.tile, device=dev)
    op = TLROperator.compress(K, args.tile, eps=args.eps * 1e-2)
    mem = op.memory_stats()
    print(f"TLR memory: {mem['total_bytes_logical']/2**20:.1f} MiB "
          f"(dense {mem['full_dense_bytes']/2**20:.1f} MiB = "
          f"{mem['dense_equivalent_gb']:.3f} GiB, "
          f"compression {mem['compression_ratio']:.1f}x, "
          f"avg rank {mem['avg_rank']:.1f})")

    print(f"factoring with ARA Cholesky (eps={args.eps}, dynamic batching)")
    fact = op.cholesky(CholOptions(eps=args.eps, bs=16, mode="dynamic"))
    ranks = fact.L.ranks.cpu().numpy()
    print(f"factor ranks: avg {ranks.mean():.1f}, max {ranks.max()}")

    g = torch.Generator(device=dev).manual_seed(0)
    x_true = torch.randn(args.n, generator=g, device=dev, dtype=K.dtype)
    y = K @ x_true
    x = fact.solve(y)
    rel = float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true))
    print(f"solve relative error: {rel:.2e}")

    # batched right-hand sides go through the same bucketed TRSM
    Y = K @ torch.randn((args.n, 4), generator=g, device=dev, dtype=K.dtype)
    X = fact.solve(Y)
    print(f"batched solve: rhs {tuple(Y.shape)} -> {tuple(X.shape)}")

    ld = float(fact.logdet())
    _, ld_ref = torch.linalg.slogdet(K)
    print(f"logdet: {ld:.4f} (dense {float(ld_ref):.4f})")

    s = fact.sample(2, generator=g)
    print(f"MVN samples: shape {tuple(s.shape)}, std {float(s.std()):.3f}")

    r = op @ x - y
    print(f"matvec residual check: {float(torch.linalg.norm(r)):.2e}")


if __name__ == "__main__":
    main()
