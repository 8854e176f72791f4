"""The control of a cell's correctness check: the plain reference put in the
program's place, one precision down (float32 for the float64 the
configurations state), which the check must reject.

``float32_in_place()`` replaces, for the block, the program's TLR Cholesky
(``TLROperator.cholesky``) by the reference's dense blocked Cholesky in
float32 (handed back as a factor whose off-diagonal tiles are full rank),
and ``repro_torch.pcg`` by the reference's PCG in float32 preconditioned by
that dense factor. Everything else of a run is as the benchmark runs it.

On the card, at a cell's own size, for each seed:

    python3 tlrbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints each seed's compared numbers (one line each) and exits non-zero if
the check passed a control run.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch


def as_factor(L: torch.Tensor, b: int, dtype: torch.dtype):
    """A dense lower triangular factor in the shape of the program's
    factorization handle: diagonal blocks in ``dtype``, each lower tile
    stored whole as ``U`` (in L's precision) with ``V`` the identity."""
    from repro_torch import TLRMatrix
    nb = L.shape[0] // b
    Lb = L.reshape(nb, b, nb, b).transpose(1, 2)
    ar = torch.arange(nb, device=L.device)
    i, j = (torch.as_tensor(v, device=L.device)
            for v in np.tril_indices(nb, -1))
    eye = torch.eye(b, dtype=L.dtype, device=L.device)
    handle = TLRMatrix(D=Lb[ar, ar].to(dtype), U=Lb[i, j],
                       V=eye.expand(i.numel(), b, b),
                       ranks=torch.full((i.numel(),), b, dtype=torch.int32,
                                        device=L.device))
    return types.SimpleNamespace(L=handle, perm=np.arange(nb), dense=L)


@contextlib.contextmanager
def float32_in_place(block: int = 4096):
    import repro_torch
    from repro_torch import TLROperator
    from repro_torch.core.solve import PCGHistory

    from tlrbench.frozen import reference

    def parts(M):
        return {"D": M.D, "U": M.U, "V": M.V, "ranks": M.ranks}

    def cholesky(self, opts=None):
        L = reference.control_factor(parts(self.A), torch.float32,
                                     block=block)
        return as_factor(L, self.A.b, self.A.dtype)

    def pcg(A, rhs, *, precond=None, tol=1e-6, maxiter=300, **_):
        x, it, rel = reference.control_pcg(parts(A.A), precond.dense, rhs,
                                           tol=tol, maxiter=maxiter)
        return x.to(rhs.dtype), it, PCGHistory([rel])

    saved = (TLROperator.cholesky, repro_torch.pcg)
    TLROperator.cholesky, repro_torch.pcg = cholesky, pcg
    try:
        yield
    finally:
        TLROperator.cholesky, repro_torch.pcg = saved


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="control runs of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from tlrbench import harness
    root = Path(__file__).resolve().parents[1]
    passed = 0
    for seed in args.seeds:
        with float32_in_place():
            res = harness.run_cell(root, args.workload, seed, 0.0, False,
                                   "cuda", time.perf_counter())
        passed += bool(res["correct"])
        torch.cuda.empty_cache()
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    root = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(root), str(root / "src")]
    sys.exit(main())
