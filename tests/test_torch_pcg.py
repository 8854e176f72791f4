"""Parity of the port's scalar ``pcg`` (``repro_torch/core/solve.py``), the
operator accessors it is used with, the fractional-diffusion generators
and the section 6.2 example against the JAX package. Mirrors the PCG
cases of tests/test_plans.py and tests/test_operator.py,
tests/test_tlr_core.py::test_fractional_diffusion_spd_illcond and
tests/test_factorization.py::test_pcg_preconditioned_by_tlr.

Tolerances: equal iteration counts and breakdown tags, histories within
1e-8 (absolute, on relative residuals) of the JAX package's;
``check_every`` histories bitwise equal to ``check_every=1``; the numpy
generator bit for bit, the on-device builder within 1e-13 relative.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TLROperator as JOperator
from repro.core import CholOptions as JCholOptions
from repro.core import covariance_problem as jax_covariance_problem
from repro.core import from_dense, tlr_cholesky as jax_cholesky
from repro.core import generators as jgen
from repro.core import pcg as jax_pcg
from repro.core import tlr_matvec as jax_matvec
from repro_torch.convert import operator_from_numpy, tlr_from_numpy
from repro_torch.core import (CholOptions, PCGHistory,
                              fractional_diffusion,
                              fractional_diffusion_matrix,
                              fractional_diffusion_problem, pcg,
                              tlr_cholesky, tlr_matvec)
from test_torch_factorization import jax_probes

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops a call: one intra-op thread beside the suite's
    other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spd_problem(n=128, seed=11):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return M @ M.T + n * np.eye(n), rng.standard_normal(n)


def _both(A, b, **kw):
    """pcg of the dense A on b in both packages: (port, JAX) results."""
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    return (pcg(lambda v: At @ v, bt, **kw), jax_pcg(lambda v: Aj @ v, bj,
                                                     **kw))


def _same_run(port, ref):
    (x, it, h), (xj, itj, hj) = port, ref
    assert it == itj and len(h) == len(hj)
    assert h.breakdown == hj.breakdown
    np.testing.assert_allclose(list(h), list(hj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8,
                               atol=1e-10)


# -- scalar pcg ----------------------------------------------------------------


@pytest.mark.parametrize("check_every", [1, 5])
def test_pcg_matches_jax(check_every):
    A, b = _spd_problem()
    run = _both(A, b, tol=1e-10, maxiter=60, check_every=check_every)
    _same_run(*run)
    assert run[0][2].breakdown is None and run[0][2][-1] < 1e-10


def test_pcg_check_every_identical_history():
    A, b = _spd_problem()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x1, it1, h1 = pcg(lambda v: At @ v, bt, tol=1e-10, maxiter=60)
    for ce in (2, 5, 16, 1000):
        xc, itc, hc = pcg(lambda v: At @ v, bt, tol=1e-10, maxiter=60,
                          check_every=ce)
        assert itc == it1 and list(hc) == list(h1)
        assert torch.equal(xc, x1) and hc.breakdown is None


def test_pcg_check_every_breakdown_parity():
    """A window that breaks down part-way replays to the exact stopping
    point, and both packages stop at the same iterate."""
    n = 64
    rng = np.random.default_rng(12)
    M = rng.standard_normal((n, n))
    A = -(M @ M.T) - n * np.eye(n)
    b = rng.standard_normal(n)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x1, it1, h1 = pcg(lambda v: At @ v, bt, tol=1e-12, maxiter=30)
    assert h1.breakdown == "indefinite_curvature"
    for ce in (3, 7, 30):
        xc, itc, hc = pcg(lambda v: At @ v, bt, tol=1e-12, maxiter=30,
                          check_every=ce)
        assert hc.breakdown == h1.breakdown
        assert itc == it1 and list(hc) == list(h1)
        assert torch.equal(xc, x1)
    _same_run(*_both(A, b, tol=1e-12, maxiter=30, check_every=7))


def test_pcg_check_every_converged_tail_not_overrun():
    A, b = _spd_problem(seed=13)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    _, it1, h1 = pcg(lambda v: At @ v, bt, tol=1e-8, maxiter=200)
    _, itc, hc = pcg(lambda v: At @ v, bt, tol=1e-8, maxiter=200,
                     check_every=64)
    assert itc == it1 and len(hc) == len(h1)
    assert hc[-1] < 1e-8 and all(v >= 1e-8 for v in list(hc)[1:-1])


def test_pcg_maxiter_not_multiple_of_window():
    A, b = _spd_problem(seed=15)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x1, it1, h1 = pcg(lambda v: At @ v, bt, tol=1e-30, maxiter=10)
    assert it1 == 10 and len(h1) == 11
    for ce in (3, 4, 7, 64):
        xc, itc, hc = pcg(lambda v: At @ v, bt, tol=1e-30, maxiter=10,
                          check_every=ce)
        assert itc == 10 and list(hc) == list(h1) and torch.equal(xc, x1)
    _same_run(*_both(A, b, tol=1e-30, maxiter=10, check_every=4))


def test_pcg_zero_rhs_and_2d_rhs():
    A, _ = _spd_problem(seed=14)
    At = torch.as_tensor(A)
    x, it, h = pcg(lambda v: At @ v, torch.zeros(128, dtype=torch.float64),
                   check_every=8)
    assert it == 0 and isinstance(h, PCGHistory) and h == []
    assert bool((x == 0).all())
    # a 2-D right-hand side runs per-column CG (tests/test_torch_batched_pcg.py
    # holds that route to the JAX package case by case)
    B = torch.ones((128, 2), dtype=torch.float64)
    B[:, 1] = 0.0
    X, iters, hists = pcg(lambda v: At @ v, B, check_every=8)
    x0, it0, h0 = pcg(lambda v: At @ v, B[:, 0], check_every=8)
    assert X.shape == (128, 2) and list(iters) == [it0, 0]
    assert len(hists[0]) == len(h0) and hists[1] == []
    assert bool((X[:, 1] == 0).all())
    np.testing.assert_allclose(X[:, 0].numpy(), x0.numpy(), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("case", ["preconditioner", "operator", "nonfinite"])
def test_pcg_breakdowns_match_jax(case):
    """A non-SPD preconditioner, a non-SPD operator and a NaN in the
    recurrence each stop PCG at the last finite iterate, with the same tag
    and count as the JAX package."""
    A, b = _spd_problem(n=64, seed=5)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    if case == "preconditioner":
        port = pcg(lambda v: At @ v, bt, precond=lambda r: -r, tol=1e-10,
                   maxiter=50)
        ref = jax_pcg(lambda v: Aj @ v, bj, precond=lambda r: -r,
                      tol=1e-10, maxiter=50)
        tag = "indefinite_preconditioner"
    elif case == "operator":
        port = pcg(lambda v: -v, bt, tol=1e-10, maxiter=50)
        ref = jax_pcg(lambda v: -v, bj, tol=1e-10, maxiter=50)
        tag = "indefinite_curvature"
    else:
        port = pcg(lambda v: At @ v, bt, precond=lambda r: r * torch.nan,
                   maxiter=50)
        ref = jax_pcg(lambda v: Aj @ v, bj, precond=lambda r: r * jnp.nan,
                      maxiter=50)
        tag = "nonfinite"
    x, it, h = port
    assert h.breakdown == ref[2].breakdown == tag
    assert it == ref[1] < 50 and list(h) == pytest.approx(list(ref[2]))
    assert bool(torch.isfinite(x).all()) and np.isfinite(h).all()


# -- operators and factorizations as pcg arguments --------------------------------


@pytest.fixture(scope="module")
def cov_ops():
    _, K = jax_covariance_problem(512, 3, 64)
    jop = JOperator.compress(jnp.asarray(K), 64, 64, 1e-8)
    top = operator_from_numpy(jop.A.D, jop.A.U, jop.A.V, jop.A.ranks,
                              device="cpu")
    return K, jop, top


def test_pcg_accepts_handles(cov_ops):
    _, _, op = cov_ops
    fact = op.cholesky(CholOptions(eps=1e-6, bs=8))
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal(op.n))
    x_op, it_op, hist = pcg(op, rhs, precond=fact, tol=1e-10, maxiter=100)
    x_fn, it_fn, _ = pcg(lambda v: op.matvec(v), rhs,
                         precond=lambda r: fact.solve(r), tol=1e-10,
                         maxiter=100)
    assert it_op == it_fn and torch.equal(x_op, x_fn)
    assert hist[-1] < 1e-10 and hist.breakdown is None
    with pytest.raises(TypeError, match="matvec"):
        pcg(object(), rhs)


def test_trace_diagonal_and_scalar_types(cov_ops):
    K, jop, op = cov_ops
    assert float(op.trace()) == pytest.approx(float(jop.trace()), rel=1e-15)
    assert float(op.trace()) == pytest.approx(float(np.trace(K)), rel=1e-12)
    np.testing.assert_array_equal(op.diagonal().numpy(),
                                  np.asarray(jop.diagonal()))
    np.testing.assert_array_equal(op.diagonal_tiles().numpy(),
                                  np.asarray(jop.diagonal_tiles()))
    want = float((2.0 * op).trace())
    assert want == pytest.approx(2.0 * float(op.trace()), rel=1e-12)
    for alpha in (np.float32(2.0), np.float64(2.0), np.int64(2),
                  torch.tensor(2.0, dtype=torch.float64), np.asarray(2.0)):
        assert float((alpha * op).trace()) == pytest.approx(want, rel=1e-6)
        assert float((op * alpha).trace()) == pytest.approx(want, rel=1e-6)


# -- the fractional-diffusion problem (section 6.2) ------------------------------


def test_fractional_diffusion_generators_match_jax():
    pts, K = jgen.fractional_diffusion_problem(512, 64)
    ptsp, Kp = fractional_diffusion_problem(512, 64)
    np.testing.assert_array_equal(ptsp, pts)
    np.testing.assert_array_equal(Kp, K)
    grid = jgen.grid_points(512, 3)
    np.testing.assert_array_equal(fractional_diffusion(grid, s=0.5),
                                  jgen.fractional_diffusion(grid, s=0.5))
    # the on-device builder, at a chunk size that splits the blocks
    Kt = fractional_diffusion_matrix(pts, device="cpu", rows_per_chunk=100)
    assert torch.equal(Kt, Kt.T)
    assert float((Kt.numpy() - K).__abs__().max()) <= 1e-13 * np.abs(K).max()
    w = np.linalg.eigvalsh(Kp)
    assert w.min() > 0 and w.max() / w.min() > 1e3
    with pytest.raises(ValueError, match="0 < s < 1"):
        fractional_diffusion_matrix(pts, s=1.0, device="cpu")


def test_pcg_preconditioned_by_tlr():
    """Fig. 9 at n = 512, tile 64: K + eps I compressed and factored at
    loose eps (JAX's probes injected, so both packages run the same
    randomized factorization) preconditions PCG on K with the same
    iteration counts; looser eps takes more iterations, and plain CG more
    than either."""
    _, Kfd = fractional_diffusion_problem(512, 64)
    A = from_dense(jnp.asarray(Kfd), 64, 64, 1e-10)
    At = tlr_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")
    rhs = np.random.default_rng(0).standard_normal(512)
    rt = torch.as_tensor(rhs)
    iters = {}
    for eps in (1e-2, 1e-6):
        Aeps = from_dense(jnp.asarray(Kfd + eps * np.eye(512)), 64, 64,
                          eps * 1e-3)
        fj = jax_cholesky(Aeps, JCholOptions(eps=eps, bs=8))
        ft = tlr_cholesky(tlr_from_numpy(Aeps.D, Aeps.U, Aeps.V, Aeps.ranks,
                                         device="cpu"),
                          CholOptions(eps=eps, bs=8, probes=jax_probes(0)))
        _, it, hist = pcg(lambda v: tlr_matvec(At, v), rt,
                          precond=lambda r: ft.solve(r), tol=1e-6,
                          maxiter=300)
        _, itj, _ = jax_pcg(lambda v: jax_matvec(A, v), jnp.asarray(rhs),
                            precond=lambda r: fj.solve(r), tol=1e-6,
                            maxiter=300)
        assert it == itj and hist[-1] < 1e-6
        iters[eps] = it
    assert iters[1e-6] <= iters[1e-2] and iters[1e-6] < 50
    _, it_plain, _ = pcg(lambda v: tlr_matvec(At, v), rt, tol=1e-6,
                         maxiter=300)
    assert it_plain > iters[1e-2]


# -- the example --------------------------------------------------------------------


def test_example_ns_suite_checks(capsys):
    """examples/fractional_diffusion_pcg_torch.py --suite ns --check at
    n = 256, tile 32 on the CPU: Newton-Schulz PCG beats plain CG."""
    path = ROOT / "examples" / "fractional_diffusion_pcg_torch.py"
    spec = importlib.util.spec_from_file_location("frac_pcg_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--n", "256", "--tile", "32", "--suite", "ns", "--check",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "check OK" in out and "unpreconditioned CG: 44 iters" in out
