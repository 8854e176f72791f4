"""GP posterior serving through the port's TLR inference server
(``repro_torch.serve``), the counterpart of examples/serve_gp.py: one
resident Cholesky factorization of a spatial covariance answers a mixed
stream of per-user requests -- posterior-mean solves, marginal-likelihood
logdets, prior samples, and iterative solves at per-request tolerance --
continuously batched through fixed ``(n, slots)`` RHS blocks, with no new
dispatch shape after warmup (the ``trace_counts`` registry).

Everything runs on the card by default; ``--device cpu`` runs the plain
versions of the kernels.

Run:  PYTHONPATH=src python examples/serve_gp_torch.py [--n 2048] [--slots 8]
      [--device cpu]
      [--trace out.json]   # Perfetto trace: per-tick pack/dispatch/sync
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import (CholOptions, TLROperator, covariance_problem,
                              trace_counts, trace_counts_diff)
from repro_torch.device import resolve_device
from repro_torch.serve import KINDS, ServeRequest


def _clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record telemetry and write a Chrome-trace / "
                         "Perfetto JSON (load at ui.perfetto.dev)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.trace:
        obs.enable()

    pts, K = covariance_problem(args.n, 2, args.tile, geometry="ball",
                                seed=3, device=dev)
    op = TLROperator.compress(K, args.tile, eps=1e-8)
    fact = op.cholesky(CholOptions(eps=1e-6, bs=16))

    t0 = _clock(dev)
    srv = fact.serve(operator=op, slots=args.slots, check_every=4)
    print(f"server up on {dev}: n={args.n}, slots={args.slots}, "
          f"warmup {_clock(dev) - t0:.2f}s")
    snap = trace_counts()

    # a mixed per-user request stream: each user brings observations y_u
    # and wants alpha_u = K^{-1} y_u (posterior mean weights), the model
    # evidence logdet, or a prior draw for their posterior sampler
    rng = np.random.default_rng(0)
    reqs = []
    for u in range(args.requests):
        kind = KINDS[u % len(KINDS)]
        y_u = (rng.standard_normal(args.n)
               if kind in ("solve", "pcg_solve") else None)
        reqs.append(ServeRequest(kind, rhs=y_u,
                                 tol=10.0 ** -rng.integers(4, 9),
                                 maxiter=100, seed=u))
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    results = srv.run()
    wall = time.perf_counter() - t0

    st = srv.stats
    print(f"drained {st.completed} requests in {st.ticks} ticks / "
          f"{wall:.3f}s ({st.completed / wall:.0f} req/s), "
          f"occupancy {st.occupancy():.2f}, new dispatch shapes "
          f"{trace_counts_diff(snap) or 'none'}")
    for kind in KINDS:
        p = st.latency_percentiles(kind)
        if not p["count"]:
            print(f"  {kind:>10}: (no completions)")
            continue
        print(f"  {kind:>10}: p50 {p['p50_s']*1e3:7.1f} ms   "
              f"p99 {p['p99_s']*1e3:7.1f} ms   ({p['count']} requests)")

    # spot-check one posterior-mean solve against the sequential path
    r0 = next(r for r in reqs if r.kind == "solve")
    ref = fact.solve(torch.as_tensor(r0.rhs, device=dev)).cpu().numpy()
    err = float(np.max(np.abs(results[r0.rid].value - ref)))
    print(f"batched-vs-sequential solve max abs diff: {err:.2e}")
    pcg = [results[r.rid] for r in reqs if r.kind == "pcg_solve"]
    if pcg:
        print(f"pcg_solve: {sum(r.converged for r in pcg)}/{len(pcg)} "
              f"converged, iterations "
              f"{sorted(r.iterations for r in pcg)}")

    if args.trace:
        obs.record_retraces()
        obs.export_chrome_trace(args.trace)
        snap = obs.metrics_snapshot(cats=("serve",))
        obs.disable()
        tick = snap["phases"].get("serve.tick", {})
        print(f"wrote {args.trace}: {snap['spans']} serve spans over "
              f"{tick.get('count', 0)} ticks")


if __name__ == "__main__":
    main()
