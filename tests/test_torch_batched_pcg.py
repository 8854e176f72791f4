"""Parity of the port's batched-RHS PCG (``repro_torch/core/solve.py``:
``BatchedPCG`` and the 2-D route of ``pcg``) against the JAX package.
Mirrors the batched cases of tests/test_plans.py (matches scalar per
column, per-column tolerance, per-column breakdown, the maxiter window
guard, the zero column), holding each to the JAX package's ``pcg`` on the
same ``(n, k)`` block; drives both packages' ``BatchedPCG`` through the
same load / advance / evict / cancel / reset sequence; and runs the
compressed tile operator preconditioned by a loose factor carried across
from JAX.

Tolerances: equal iteration counts, breakdown tags and history lengths;
histories within 1e-8 absolute (relative residuals); X within 1e-10
relative (Frobenius, over the block).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BatchedPCG as JBatchedPCG
from repro.core import TLROperator as JOperator
from repro.core import pcg as jax_pcg
from repro_torch.convert import factorization_from_numpy, operator_from_numpy
from repro_torch.core import BatchedPCG, pcg

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


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


def _dense(A):
    """The dense matvec in both packages: (port, JAX)."""
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    return (lambda v: At @ v), (lambda v: Aj @ v)


def _same_block(port, ref, k):
    """A port ``(X, iters, hists)`` against the JAX package's."""
    (X, it, hs), (Xj, itj, hsj) = port, ref
    assert X.shape == tuple(Xj.shape) and len(hs) == len(hsj) == k
    np.testing.assert_array_equal(np.asarray(it), np.asarray(itj))
    assert [h.breakdown for h in hs] == [h.breakdown for h in hsj]
    for h, hj in zip(hs, hsj):
        assert len(h) == len(hj)
        np.testing.assert_allclose(list(h), list(hj), rtol=0, atol=1e-8)
    Xj = np.asarray(Xj)
    assert np.linalg.norm(X.numpy() - Xj) <= 1e-10 * np.linalg.norm(Xj)


def test_batched_matches_jax_and_scalar_per_column():
    A, _ = _spd_problem(seed=18)
    mv, mvj = _dense(A)
    B = np.random.default_rng(19).standard_normal((A.shape[0], 4))
    kw = dict(tol=1e-8, maxiter=200, check_every=8)
    port = pcg(mv, torch.as_tensor(B), **kw)
    _same_block(port, jax_pcg(mvj, jnp.asarray(B), **kw), 4)
    X, iters, hists = port
    assert iters.shape == (4,)
    for j in range(4):
        xj, itj, hj = pcg(mv, torch.as_tensor(B[:, j]), **kw)
        assert int(iters[j]) == itj
        assert hists[j].breakdown is None and hj.breakdown is None
        np.testing.assert_allclose(list(hists[j]), list(hj), rtol=1e-6,
                                   atol=1e-14)
        np.testing.assert_allclose(X[:, j].numpy(), xj.numpy(), rtol=1e-8,
                                   atol=1e-12)


def test_batched_per_column_tolerance():
    A, _ = _spd_problem(seed=20)
    mv, mvj = _dense(A)
    b = np.random.default_rng(21).standard_normal(A.shape[0])
    B = np.stack([b, b], axis=1)
    kw = dict(tol=np.array([1e-2, 1e-10]), maxiter=200, check_every=4)
    port = pcg(mv, torch.as_tensor(B), **kw)
    _same_block(port, jax_pcg(mvj, jnp.asarray(B), **kw), 2)
    _, iters, hists = port
    assert int(iters[0]) < int(iters[1])
    assert hists[0][-1] < 1e-2 and hists[1][-1] < 1e-10


def test_batched_per_column_breakdown():
    n = 64
    rng = np.random.default_rng(22)
    M = rng.standard_normal((n, n))
    Apos = M @ M.T + n * np.eye(n)
    Pt, Pj = torch.as_tensor(Apos), jnp.asarray(Apos)
    mv = lambda V: torch.stack([Pt @ V[:, 0], -Pt @ V[:, 1]], dim=1)
    mvj = lambda V: jnp.stack([Pj @ V[:, 0], -Pj @ V[:, 1]], axis=1)
    B = rng.standard_normal((n, 2))
    kw = dict(tol=1e-8, maxiter=50, check_every=4)
    port = pcg(mv, torch.as_tensor(B), **kw)
    _same_block(port, jax_pcg(mvj, jnp.asarray(B), **kw), 2)
    X, iters, hists = port
    assert hists[0].breakdown is None and hists[0][-1] < 1e-8
    assert hists[1].breakdown == "indefinite_curvature"
    x1, it1, h1 = pcg(lambda v: -Pt @ v, torch.as_tensor(B[:, 1]), **kw)
    assert int(iters[1]) == it1 and h1.breakdown == hists[1].breakdown
    np.testing.assert_array_equal(X[:, 1].numpy(), x1.numpy())


def test_batched_maxiter_window_guard():
    A, _ = _spd_problem(seed=23)
    mv, mvj = _dense(A)
    B = np.random.default_rng(24).standard_normal((A.shape[0], 3))
    kw = dict(tol=1e-30, maxiter=10, check_every=4)
    port = pcg(mv, torch.as_tensor(B), **kw)
    _same_block(port, jax_pcg(mvj, jnp.asarray(B), **kw), 3)
    np.testing.assert_array_equal(port[1], [10, 10, 10])
    assert all(len(h) == 11 for h in port[2])


def test_batched_zero_column():
    A, b = _spd_problem(seed=25)
    mv, mvj = _dense(A)
    B = np.stack([b, np.zeros_like(b)], axis=1)
    kw = dict(tol=1e-8, maxiter=200, check_every=8)
    port = pcg(mv, torch.as_tensor(B), **kw)
    _same_block(port, jax_pcg(mvj, jnp.asarray(B), **kw), 2)
    X, iters, hists = port
    assert int(iters[1]) == 0 and hists[1] == []
    np.testing.assert_array_equal(X[:, 1].numpy(), 0.0)
    assert hists[0][-1] < 1e-8


def test_engine_lifecycle_matches_jax():
    """Both packages' engines driven through the same load / advance /
    evict / cancel / reset sequence report the same statuses, iteration
    counts and evicted iterates at every step."""
    A, _ = _spd_problem(n=96, seed=26)
    mv, mvj = _dense(A)
    n = A.shape[0]
    rng = np.random.default_rng(27)
    rhs = rng.standard_normal((n, 4))
    eng = BatchedPCG(mv, n, 3, maxiter=50, check_every=3,
                     dtype=torch.float64, device="cpu")
    jeng = JBatchedPCG(mvj, n, 3, maxiter=50, check_every=3,
                       dtype=jnp.float64)

    def both(method, *args, **kw):
        out = getattr(eng, method)(*args, **kw)
        jout = getattr(jeng, method)(*args, **kw)
        assert eng.status == jeng.status
        np.testing.assert_array_equal(eng.iters, jeng.iters)
        np.testing.assert_array_equal(eng.converged, jeng.converged)
        return out, jout

    def evict_done():
        for j in eng.done_columns:
            (x, it, h, conv), (xj, itj, hj, convj) = both("evict", j)
            assert (it, conv, h.breakdown) == (itj, convj, hj.breakdown)
            np.testing.assert_allclose(list(h), list(hj), rtol=0,
                                       atol=1e-8)
            np.testing.assert_allclose(x, np.asarray(xj), rtol=1e-10,
                                       atol=1e-12)

    both("load", 0, rhs[:, 0], tol=1e-10)
    both("load", 1, rhs[:, 1], tol=1e-3, maxiter=7)
    assert eng.status == ["pending", "pending", "idle"]
    both("load", 2, np.zeros(n))                 # done at load
    assert eng.status[2] == "done"
    with pytest.raises(ValueError, match="not done"):
        eng.evict(0)
    both("advance")
    assert eng.status == ["active", "active", "done"]
    evict_done()
    both("cancel", 0)                            # a timeout mid-flight
    assert eng.status == ["idle", "active", "idle"]
    both("load", 0, rhs[:, 2], tol=1e-6)
    both("load", 2, rhs[:, 3], tol=1e-8)
    with pytest.raises(ValueError, match="still active"):
        eng.load(1, rhs[:, 0])
    finished = []
    while eng.active_columns:
        fin, jfin = both("advance")
        assert sorted(fin) == sorted(jfin)
        finished += fin
        evict_done()
    assert sorted(finished) == [0, 1, 2]
    assert eng.iters[1] == 7                     # its own budget
    both("load", 1, rhs[:, 0])
    both("reset")
    assert eng.status == ["idle"] * 3 and eng.active_columns == []


@pytest.fixture(scope="module")
def tile_problem():
    """The compressed operator (1e-10) and a loose factor of the same
    matrix (compressed at 0.5) from the JAX package, carried across."""
    rng = np.random.default_rng(4)
    M = rng.standard_normal((128, 128))
    A = M @ M.T / 128 + 2.0 * np.eye(128)
    jop = JOperator.compress(jnp.asarray(A), 32, eps=1e-10)
    jfact = JOperator.compress(jnp.asarray(A), 32, eps=0.5).cholesky()
    L = jfact.L
    op = operator_from_numpy(jop.A.D, jop.A.U, jop.A.V, jop.A.ranks,
                             device="cpu")
    fact = factorization_from_numpy(L.D, L.U, L.V, L.ranks, d=jfact.d,
                                    perm=jfact.perm, device="cpu")
    return A, jop, jfact, op, fact


def test_tile_operator_with_loose_factor(tile_problem):
    A, jop, jfact, op, fact = tile_problem
    B = np.random.default_rng(28).standard_normal((128, 4))
    tol = np.array([1e-4, 1e-6, 1e-8, 1e-11])
    kw = dict(tol=tol, maxiter=100, check_every=4)
    port = pcg(op, torch.as_tensor(B), precond=fact, **kw)
    _same_block(port, jax_pcg(jop, jnp.asarray(B), precond=jfact, **kw), 4)
    X, iters, hists = port
    assert len(set(iters.tolist())) > 1          # the tolerances spread
    for j in range(4):
        assert hists[j].breakdown is None and hists[j][-1] < tol[j]
