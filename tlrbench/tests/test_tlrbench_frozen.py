"""The frozen input generators and the reference, on the CPU at tiny sizes;
one test for the card, which skips without one."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from tlrbench import harness
from tlrbench.frozen import compress, geometry, problems, reference


def dense_tiles(cfg: dict, n: int) -> torch.Tensor:
    """The configuration's dense matrix, evaluated directly."""
    b = cfg["tile"]
    pts = torch.as_tensor(geometry.ordered_grid(n, cfg["dim"], b))
    r = torch.cdist(pts, pts, compute_mode="donot_use_mm_for_euclid_dist")
    if cfg["problem"] == "exp_covariance":
        return torch.exp(-r / cfg["ell"]) + cfg["nugget"] * torch.eye(n)
    h = 1.0 / max(n ** (1.0 / cfg["dim"]) - 1.0, 1.0)
    W = torch.where(r > 0, h ** (2 * cfg["dim"])
                    / r.pow(cfg["dim"] + 2 * cfg["s"]), 0.0)
    return torch.diag(W.sum(1) + cfg["mass"] * h ** cfg["dim"]) - W


@pytest.mark.parametrize("name", ["cov2d-64k", "frac3d-32k"])
def test_compression_reproduces_the_dense_matrix_within_eps(name, tiny_cfg):
    cfg = tiny_cfg(name)
    A = problems.build(cfg, 2**40 + 7, "cpu")
    K = dense_tiles(cfg, cfg["n"])
    nb, b = cfg["n"] // cfg["tile"], cfg["tile"]
    Kb = K.reshape(nb, b, nb, b).transpose(1, 2)
    assert torch.allclose(A["D"], Kb[torch.arange(nb), torch.arange(nb)],
                          rtol=1e-12, atol=1e-15)
    i, j = np.tril_indices(nb, -1)
    err = Kb[i, j] - A["U"] @ A["V"].transpose(1, 2)
    two_norm = torch.linalg.matrix_norm(err, ord=2)
    assert float(two_norm.max()) <= 10 * cfg["compress_eps"]
    ranks = A["ranks"]
    assert bool((ranks % cfg["compress_bs"] == 0).all())
    assert int(ranks.max()) <= cfg["r_max"]


def test_the_inputs_follow_the_ports_generators(tiny_cfg):
    """The frozen geometry and formulas give the port's matrices."""
    from repro_torch.core import generators, ordering
    for n, d in ((1024, 2), (4096, 3)):
        pts = geometry.grid_points(n, d)
        assert np.array_equal(pts, generators.grid_points(n, d))
        assert np.array_equal(geometry.kd_tree_ordering(pts, 128),
                              ordering.kd_tree_ordering(pts, 128))
    cfg = tiny_cfg("frac3d-32k")
    pts = geometry.ordered_grid(cfg["n"], 3, cfg["tile"])
    port = torch.as_tensor(generators.fractional_diffusion(pts, s=cfg["s"]))
    mine = dense_tiles(cfg, cfg["n"])
    assert float((port - mine).abs().max() / port.abs().max()) < 1e-12
    cfg = tiny_cfg("cov2d-64k")
    pts = geometry.ordered_grid(cfg["n"], 2, cfg["tile"])
    port = generators.covariance_matrix(pts, "exp", cfg["ell"], device="cpu")
    assert float((port - dense_tiles(cfg, cfg["n"])).abs().max()) < 1e-12


def symmetric_dense(A: dict) -> torch.Tensor:
    """The whole symmetric matrix of an operator dict."""
    low = torch.tril(reference.dense(A, torch.float64))
    return low + torch.tril(low, -1).T


def test_reference_judges_an_exact_factor_and_rejects_one_wrong_tile(tiny_cfg):
    cfg = tiny_cfg("cov2d-64k")
    A = problems.build(cfg, 5, "cpu")
    Ld = torch.linalg.cholesky(symmetric_dense(A))
    ok = reference.factor_residuals(A, Ld)
    assert ok["diag_abs"] < 1e-10 and ok["offdiag_abs"] < 1e-10
    b = cfg["tile"]
    bad = Ld.clone()
    bad[5 * b:6 * b, 2 * b:3 * b] += 1e-4 * torch.randn(b, b)
    r = reference.factor_residuals(A, bad)
    assert r["offdiag_abs"] > 1e-3
    bad = Ld.clone()
    bad[3 * b + 7, 3 * b + 2] += 1e-3
    r = reference.factor_residuals(A, bad)
    assert r["diag_abs"] > 1e-4


def test_reference_follows_the_factorizations_tile_permutation(tiny_cfg):
    """A pivoted factor is judged against P A P^T, not A."""
    from repro_torch import CholOptions, TLRMatrix, TLROperator
    cfg = tiny_cfg("cov2d-64k")
    A = problems.build(cfg, 9, "cpu")
    fact = TLROperator(TLRMatrix(**A)).cholesky(
        CholOptions(eps=1e-6, bs=16, pivot="frobenius"))
    assert not np.array_equal(fact.perm, np.arange(len(fact.perm)))
    Ld = reference.lower_dense({"D": fact.L.D, "U": fact.L.U,
                                "V": fact.L.V, "ranks": fact.L.ranks})
    good = reference.factor_residuals(A, Ld, perm=fact.perm)
    wrong = reference.factor_residuals(A, Ld)
    assert good["offdiag_abs"] < 5e-6 < wrong["offdiag_abs"]


def test_reference_matvec_is_the_dense_product(tiny_cfg):
    cfg = tiny_cfg("frac3d-32k")
    A = problems.build(cfg, 3, "cpu")
    K = symmetric_dense(A)
    x = torch.randn(cfg["n"], dtype=torch.float64)
    want = K @ x
    err = (reference.matvec(A, x) - want).abs().max()
    assert float(err) <= 1e-13 * float(want.abs().max())


def test_compression_stops_every_tile_within_the_rank_budget():
    gen = torch.Generator().manual_seed(0)
    A = torch.randn(3, 32, 32, dtype=torch.float64, generator=gen)
    A[1] = A[1, :, :4] @ A[1, :4, :]       # rank 4
    A[2] = 0.0                             # rank 0
    Q, ranks = compress.ara_tiles(A, eps=1e-9, r_max=16, bs=4,
                                  generator=gen)
    assert ranks.tolist() == [16, 4, 0]
    assert torch.allclose(Q[1].T @ Q[1], torch.diag(
        torch.tensor([1.0] * 4 + [0.0] * 12, dtype=torch.float64)),
        atol=1e-12)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the port's kernels")


@pytest.mark.gpu
def test_the_profilers_events_match_its_chrome_trace(card):
    """Both readings of a profiled step give the same device work."""
    from tlrbench import devtrace
    x = torch.randn(256, 256, device="cuda", dtype=torch.float64)
    with devtrace.profiled() as held:
        for _ in range(5):
            x = torch.linalg.qr(x @ x.T)[0]
        y = x.cpu()
        torch.cuda.synchronize()
    fast = sorted(devtrace.events(held))
    slow = sorted(devtrace.chrome_events(held))
    assert len(fast) == len(slow) > 5 and y.shape == (256, 256)
    assert [e[:2] for e in fast] == [e[:2] for e in slow]
    for a, b in zip(fast, slow):
        assert abs(a[3] - b[3]) <= 1000
    assert len({e[4] for e in fast}) == len({e[4] for e in slow})


@pytest.mark.gpu
def test_a_tiny_cell_is_correct_on_the_card(card, tiny_root):
    """The tiny cells through the port's CUDA kernels, traced."""
    for cell in ("tiny-cov.chol8", "tiny-frac.pcg"):
        res = harness.run_cell(tiny_root, cell, 2**41 + 1, 0.5, True,
                               "cuda", time.perf_counter())
        assert res["correct"], json.dumps(res)
        assert res["device"]["busy_s"] > 0
