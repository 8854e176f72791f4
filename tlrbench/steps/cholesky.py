"""Whole TLR Cholesky factorizations of one operator, back to back.

Traffic keys: ``eps`` and ``bs`` of ``CholOptions`` (the left-looking
driver, dynamic mode, batching "auto"); each step draws its probes from a
seed of its own, derived from the run's seed. The judge compares the last
step's factor, tile by tile, with the operator (``frozen/reference.py``):
``diag_resid`` and ``offdiag_resid``, the largest Frobenius norm of the
residual in a diagonal and in an off-diagonal tile, in units of ``eps``
(the factorization's accuracy is absolute, tile by tile).
"""

from __future__ import annotations

import torch

from tlrbench.frozen import counts, reference, seeds


def factor_numbers(A: dict, fact, eps: float, shift: float = 0.0) -> dict:
    """The reference's judgement of a TLR factorization of A + shift I."""
    L = {"D": fact.L.D, "U": fact.L.U, "V": fact.L.V,
         "ranks": fact.L.ranks}
    Ld = reference.lower_dense(L)
    del L
    r = reference.factor_residuals(A, Ld, perm=fact.perm, shift=shift)
    return {"diag_resid": r["diag_abs"] / eps,
            "offdiag_resid": r["offdiag_abs"] / eps}


def describe(A: dict) -> dict:
    ranks = A["ranks"].float()
    return {"n": A["D"].shape[0] * A["D"].shape[1], "nb": A["D"].shape[0],
            "r_max": A["U"].shape[-1], "rank_max": int(ranks.max()),
            "rank_mean": float(ranks.mean()),
            "at_r_max": int((A["ranks"] >= A["U"].shape[-1]).sum())}


class Step:
    def __init__(self, inputs: dict, cfg: dict, traffic: dict, seed: int):
        from repro_torch import CholOptions, TLRMatrix, TLROperator
        self.A = inputs
        self.op = TLROperator(TLRMatrix(**inputs))
        self.eps, self.bs = float(traffic["eps"]), int(traffic["bs"])
        self.options = lambda i: CholOptions(
            eps=self.eps, bs=self.bs, seed=seeds.derive(seed, "probe", i))
        self.fact = None
        self.l_ranks: list[torch.Tensor] = []

    def describe(self) -> dict:
        return describe(self.A)

    def run(self, i: int) -> dict:
        self.fact = None
        self.fact = self.op.cholesky(self.options(i))
        self.l_ranks.append(self.fact.L.ranks.clone())
        return {}

    def work(self) -> list[float]:
        nb, b = self.A["D"].shape[0], self.A["D"].shape[1]
        a = self.A["ranks"].cpu().numpy()
        return [counts.cholesky_flops(a, r.cpu().numpy(), nb, b, self.bs)
                for r in self.l_ranks]

    def judge(self):
        fact, self.fact, self.op = self.fact, None, None
        numbers = factor_numbers(self.A, fact, self.eps)
        return numbers, len(self.l_ranks), 0

