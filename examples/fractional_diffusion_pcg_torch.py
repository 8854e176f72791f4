"""The paper's section 6.2 experiment on the PyTorch/CUDA port
(``repro_torch``), the counterpart of examples/fractional_diffusion_pcg.py:
factor an ill-conditioned 3D fractional-diffusion operator at low accuracy
and use it as a PCG preconditioner, then precondition with a Newton-Schulz
TLR approximate inverse (``core/precond.py``) instead. ``pcg`` consumes the
handles directly: the ``TLROperator`` is the matvec, the
``TLRFactorization`` or the inverse's ``TLROperator`` the preconditioner.

The matrix is built on the device (``fractional_diffusion_matrix``), and
everything runs there: the card by default, ``--device cpu`` for the plain
versions of the kernels.

Run:  PYTHONPATH=src python examples/fractional_diffusion_pcg_torch.py [--n 2048]
      ... --suite ns --check     # Newton-Schulz only, with the assertion
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (CholOptions, TLROperator,
                              fractional_diffusion_matrix,
                              fractional_diffusion_points, pcg,
                              tlr_newton_schulz)
from repro_torch.device import resolve_device


def _clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def run_cholesky(op, K, rhs, args, dev):
    print(f"{'eps':>8} {'factor_s':>9} {'cg_iters':>8} {'residual':>10}")
    for eps in (1e-1, 1e-2, 1e-4, 1e-6):
        # paper: factor A + eps*I to preserve definiteness at loose eps
        Keps = K.clone()
        torch.diagonal(Keps).add_(eps)
        op_eps = TLROperator.compress(Keps, args.tile,
                                      eps=min(eps * 1e-2, 1e-8))
        del Keps
        t0 = _clock(dev)
        fact = op_eps.cholesky(CholOptions(eps=eps, bs=16, schur="diag"))
        t_fact = _clock(dev) - t0
        x, iters, hist = pcg(op, rhs, precond=fact, tol=1e-6, maxiter=300)
        print(f"{eps:>8g} {t_fact:>9.2f} {iters:>8d} {hist[-1]:>10.2e}")


def run_newton_schulz(op, rhs, it_plain, args, dev):
    print(f"{'ns_iters':>8} {'build_s':>9} {'cg_iters':>8} {'residual':>10}"
          f" {'avg_rank':>8}")
    best = it_plain
    for ns_iters in sorted({4, args.ns_iters}):
        t0 = _clock(dev)
        # norm scaling (alpha = 1/||A||_2 est) compresses the condition
        # number by ~2^iters; trace scaling is the always-safe default
        Xop, info = tlr_newton_schulz(op, iters=ns_iters, eps=args.ns_eps,
                                      scale="norm")
        t_build = _clock(dev) - t0
        x, iters, hist = pcg(op, rhs, precond=Xop, tol=1e-6, maxiter=300)
        print(f"{ns_iters:>8d} {t_build:>9.2f} {iters:>8d} {hist[-1]:>10.2e}"
              f" {info.avg_rank:>8.1f}")
        best = min(best, iters)
    if args.check:
        assert best < it_plain, (
            f"Newton-Schulz PCG ({best} iters) did not beat "
            f"unpreconditioned PCG ({it_plain} iters)")
        print(f"check OK: {best} < {it_plain} unpreconditioned iters")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--suite", default="all",
                    choices=("all", "cholesky", "ns"))
    ap.add_argument("--ns-iters", type=int, default=8)
    ap.add_argument("--ns-eps", type=float, default=1e-8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--check", action="store_true",
                    help="assert the Newton-Schulz preconditioner reduces "
                         "PCG iterations")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"building 3D fractional-diffusion matrix, N={args.n}, on {dev}")
    pts = fractional_diffusion_points(args.n, args.tile)
    K = fractional_diffusion_matrix(pts, device=dev)
    cond = (np.linalg.cond(K.cpu().numpy()) if args.n <= 4096
            else float("nan"))
    print(f"condition number ~ {cond:.2e}")
    op = TLROperator.compress(K, args.tile, eps=1e-10)
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(args.n),
                          device=dev)

    if args.suite in ("all", "cholesky"):
        run_cholesky(op, K, rhs, args, dev)

    _, it_plain, hist = pcg(op, rhs, tol=1e-6, maxiter=300)
    print(f"unpreconditioned CG: {it_plain} iters, residual {hist[-1]:.2e}")

    if args.suite in ("all", "ns"):
        run_newton_schulz(op, rhs, it_plain, args, dev)


if __name__ == "__main__":
    main()
