"""Solutions of the section 6.2 workflow, back to back: each step factors
the shifted operator ``A + shift I`` by the left-looking TLR Cholesky at
``eps`` (``bs``) and solves ``A x = b`` for a new right-hand side by PCG
preconditioned with that factor, to a relative residual below ``tol``
within ``maxiter`` iterations.

Traffic keys: ``shift``, ``eps``, ``bs``, ``tol``, ``maxiter``. Probes and
right-hand sides come from seeds derived from the run's seed and the
step. The judge compares every step's solution (``x_resid``, the largest
``||A x - b|| / ||b||`` by the reference's own matvec; a solve that stopped
on a breakdown or at ``maxiter`` fails) and the last step's factor
against ``A + shift I`` (``diag_resid``, ``offdiag_resid``).
"""

from __future__ import annotations

import time

import torch

from tlrbench.frozen import counts, reference, seeds

from .cholesky import describe, factor_numbers


class Step:
    def __init__(self, inputs: dict, cfg: dict, traffic: dict, seed: int):
        from repro_torch import CholOptions, TLRMatrix, TLROperator, pcg
        from repro_torch.core import tlr_add_diag
        self.A, self.seed = inputs, seed
        self.op = TLROperator(TLRMatrix(**inputs))
        t = traffic
        self.shift, self.eps, self.bs = (float(t["shift"]), float(t["eps"]),
                                         int(t["bs"]))
        self.tol, self.maxiter = float(t["tol"]), int(t["maxiter"])
        self.options = lambda i: CholOptions(
            eps=self.eps, bs=self.bs, seed=seeds.derive(seed, "probe", i))
        self.shifted = lambda: TLROperator(tlr_add_diag(self.op.A,
                                                        self.shift))
        self.pcg = pcg
        self.fact = None
        self.solves: list[tuple] = []
        self.l_ranks: list[torch.Tensor] = []

    def describe(self) -> dict:
        return describe(self.A)

    def _rhs(self, i: int) -> torch.Tensor:
        D = self.A["D"]
        g = torch.Generator(device=D.device)
        g.manual_seed(seeds.derive(self.seed, "rhs", i))
        return torch.randn((D.shape[0] * D.shape[1],), generator=g,
                           dtype=D.dtype, device=D.device)

    def run(self, i: int) -> dict:
        self.fact = None
        t0 = time.perf_counter()
        fact = self.shifted().cholesky(self.options(i))
        if fact.L.D.is_cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        rhs = self._rhs(i)
        x, iters, hist = self.pcg(self.op, rhs, precond=fact, tol=self.tol,
                                  maxiter=self.maxiter)
        if x.is_cuda:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        self.fact = fact
        self.l_ranks.append(fact.L.ranks.clone())
        converged = hist.breakdown is None and bool(hist) and \
            hist[-1] < self.tol
        self.solves.append((x, rhs, iters, converged))
        return {"precond_s": t1 - t0, "pcg_s": t2 - t1, "pcg_iters": iters}

    def work(self) -> list[float]:
        nb, b = self.A["D"].shape[0], self.A["D"].shape[1]
        a = self.A["ranks"].cpu().numpy()
        out = []
        for r, (_, _, iters, _) in zip(self.l_ranks, self.solves):
            lr = r.cpu().numpy()
            out.append(counts.cholesky_flops(a, lr, nb, b, self.bs)
                       + counts.pcg_flops(a, lr, nb, b, iters))
        return out

    def judge(self):
        fact, self.fact, self.op = self.fact, None, None
        numbers = factor_numbers(self.A, fact, self.eps, self.shift)
        del fact
        worst, failed = 0.0, 0
        for x, rhs, _, converged in self.solves:
            res = reference.relative_residual(self.A, x, rhs)
            worst = max(worst, res)
            failed += int(not converged or not res <= self.tol)
        numbers["x_resid"] = worst
        return numbers, len(self.solves), failed
