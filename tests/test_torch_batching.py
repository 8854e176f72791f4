"""Rank-bucketed batching of the port (``repro_torch/core/batching.py``)
against the JAX package's (``repro/core/batching.py``), on the CPU.

Mirrors tests/test_batching.py (except the tile-mesh case, not ported) and
the non-PCG cases of tests/test_plans.py, with the same numpy inputs on
both sides:

* plans: the same buckets, gather indices, count padding, ladder widths
  and rank-0 set as JAX's ``plan_rank_buckets``; ``resolve_policy``'s
  record equal key by key; the memo gives a new plan after an in-place
  write to a ranks tensor (torch tensors are mutable, JAX arrays are not);
* ranked rounding equal to JAX's ranked result, the wide concatenation
  that densifies included: ranks equal, dense within 1e-10 (the port's
  plain MGS2 / Jacobi against JAX's Householder / LAPACK reference differ
  by rounding, ~1e-13 here);
* ranked read paths (matvec, tri_matvec, TRSM forward and transposed, 1
  and several right-hand sides) within 1e-12 of JAX and of the flat path;
* the left driver, ranked, fused and dynamic, Cholesky and LDL^T, with
  JAX's probes injected, on the n = 384, b = 64 problem of
  tests/test_torch_factorization.py: ranks, ``column_iters`` and each
  column's projection width equal, dense L within 1e-8 (the tolerance
  of that file);
* the right driver, ranked Cholesky and LDL^T: ranks, ``flushes`` and
  ``append_widths`` equal, dense L within 1e-8;
* rank floors and counts: the rank-0 bucket calls no kernel and keeps
  rank 0; the number of distinct dispatch shapes stays bounded and a
  repeat call adds none.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CholOptions as JCholOptions
from repro.core import TLROperator as JOperator
from repro.core import batching as jb
from repro.core import covariance_problem, exp_covariance, \
    kd_tree_ordering, tlr_axpy
from repro.core import solve as jsolve
from repro.core.algebra import tlr_round as jax_round
from repro.core.algebra import tlr_round_tiles as jax_round_tiles
from repro.core.tlr import TLRMatrix as JTLRMatrix
from repro.core.tlr import num_tiles
from repro_torch.convert import operator_from_numpy, tlr_from_numpy
from repro_torch.core import batching as tb
from repro_torch.core import solve as tsolve
from repro_torch.core.algebra import tlr_round, tlr_round_tiles
from repro_torch.core.buckets import trace_counts, trace_counts_diff
from repro_torch.core.cholesky import CholOptions
from repro_torch.kernels import ops

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain QR and Jacobi versions run thousands of small ops a call;
    beside the suite's other workers torch's intra-op pool oversubscribes
    the cores. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_probes(seed: int = 0):
    """The JAX driver's Omega: normal(fold_in(fold_in(PRNGKey(seed), k), it))."""
    key = jax.random.PRNGKey(seed)

    def probes(k, it, shape, dtype, device):
        kk = jax.random.fold_in(jax.random.fold_in(key, k), it)
        z = np.array(jax.random.normal(kk, shape, jnp.float64))
        return torch.as_tensor(z, dtype=dtype, device=device)

    return probes


def _port(A):
    """The port's operator on a JAX TLRMatrix's exact tiles."""
    return operator_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")


def _cov_operator(seed, nb, b, eps=1e-5, ell=0.1):
    """tests/test_batching.py's covariance operator with a heterogeneous
    rank distribution (short correlation length, loose threshold)."""
    rng = np.random.default_rng(seed)
    n = nb * b
    pts = rng.random((n, 3))
    K = np.asarray(exp_covariance(pts[kd_tree_ordering(pts, b)], ell))
    jop = JOperator.compress(jnp.asarray(K), b, b, eps)
    return K, jop, _port(jop.A)


def _block_diag_op(nb=4, b=32, seed=0):
    """Block-diagonal SPD matrix: every off-diagonal tile has rank 0."""
    rng = np.random.default_rng(seed)
    n = nb * b
    K = np.zeros((n, n))
    for s in range(0, n, b):
        M = rng.standard_normal((b, b))
        K[s:s + b, s:s + b] = M @ M.T + b * np.eye(b)
    jop = JOperator.compress(jnp.asarray(K), b, b, 1e-10)
    return K, jop, _port(jop.A)


def _skewed(nb=8, b=16, r_max=16, seed=0, sym=False):
    """tests/test_plans.py's skewed-rank factor (most tiles rank 1-2, a few
    at r_max, some exactly 0; columns past each rank zero) as numpy arrays;
    ``sym`` symmetrizes the diagonal blocks."""
    rng = np.random.default_rng(seed)
    nt = num_tiles(nb)
    ranks = np.ones(nt, np.int32)
    ranks[rng.permutation(nt)[: max(1, nt // 4)]] = 2
    ranks[rng.permutation(nt)[: max(1, nt // 8)]] = r_max
    ranks[rng.permutation(nt)[: max(1, nt // 8)]] = 0
    D = np.tril(rng.standard_normal((nb, b, b)) * 0.1)
    D[:, np.arange(b), np.arange(b)] = 2.0 + rng.random((nb, b))
    if sym:
        D = D + np.swapaxes(D, 1, 2)
    U = np.zeros((nt, b, r_max))
    V = np.zeros((nt, b, r_max))
    for t, r in enumerate(ranks):
        U[t, :, :r] = rng.standard_normal((b, r)) * 0.1
        V[t, :, :r] = rng.standard_normal((b, r)) * 0.1
    return D, U, V, ranks


def _both(arrays):
    """(JAX TLRMatrix, port TLRMatrix) of the same numpy arrays."""
    return (JTLRMatrix(*(jnp.asarray(a) for a in arrays)),
            tlr_from_numpy(*arrays, device="cpu"))


def _problem(n, d, eps):
    _, K = covariance_problem(n, d, 64)
    jop = JOperator.compress(jnp.asarray(K), 64, 64, eps)
    return np.asarray(K), jop.A, _port(jop.A).A


@pytest.fixture(scope="module")
def problem():
    """tests/test_torch_factorization.py's n = 384, b = 64 problem. Its L
    ranks (32-64) bucket to the cap, so only the first columns' widths
    are narrow."""
    return _problem(384, 3, 1e-7)


@pytest.fixture(scope="module")
def cov2d():
    """A 2-D covariance at n = 512, b = 64, compressed at 1e-8: A ranks
    12-44, L ranks 6-48, so the ranked drivers project and append at
    widths 32 and 64."""
    return _problem(512, 2, 1e-8)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _lower(L):
    d = L.to_dense()
    return np.tril(d.numpy() if isinstance(d, torch.Tensor) else
                   np.asarray(d))


# -- plans ------------------------------------------------------------------------


def test_rank_ladder_and_bucket_width():
    for cap in (8, 12, 64, 1152):
        assert tb.rank_ladder(cap) == jb.rank_ladder(cap)
    assert tb.bucket_width([3, 9], 64) == 16
    assert tb.bucket_width(torch.tensor([64]), 64) == 64
    assert tb.bucket_width([0, 0], 64) == 1    # floor: no 0-width batches
    assert tb.bucket_width(np.zeros((0,)), 64) == 1
    assert tb.bucket_width([5], 0) == 0


def _assert_same_plan(pp, jp):
    assert (pp.n, pp.cap) == (jp.n, jp.cap)
    assert len(pp.buckets) == len(jp.buckets)
    for a, b in zip(pp.buckets, jp.buckets):
        assert (a.width, a.count, a.padded) == (b.width, b.count, b.padded)
        np.testing.assert_array_equal(a.idx, b.idx)
    np.testing.assert_array_equal(pp.zero_idx, jp.zero_idx)
    np.testing.assert_array_equal(pp.widths, jp.widths)
    np.testing.assert_array_equal(pp.ranks_host, jp.ranks_host)
    for attr in ("zero_count", "max_rank", "median_rank", "rank_skew",
                 "max_width"):
        assert getattr(pp, attr) == getattr(jp, attr), attr
    for fn in ("padded_cols", "useful_cols", "flat_cols",
               "padded_flop_ratio"):
        assert getattr(pp, fn)() == getattr(jp, fn)(), fn


@pytest.mark.parametrize("case", ["listed", "skewed", "covariance", "zeros"])
def test_plan_matches_jax(case, problem):
    if case == "listed":
        ranks, cap = np.asarray([0, 1, 2, 3, 4, 5, 8, 9, 0]), 16
    elif case == "skewed":
        ranks, cap = _skewed()[3], 16
    elif case == "covariance":
        ranks, cap = np.asarray(problem[1].ranks), 64
    else:
        ranks, cap = np.zeros(7, np.int32), 8
    pp = tb.plan_rank_buckets(torch.as_tensor(np.array(ranks)), cap)
    jp = jb.plan_rank_buckets(jnp.asarray(ranks), cap)
    _assert_same_plan(pp, jp)
    assert sum(pp.bucket_flops(16)) <= pp.flat_flops(16)
    if case == "listed":
        widths = {bk.width: sorted(bk.idx.tolist()) for bk in pp.buckets}
        assert widths == {1: [1], 2: [2], 4: [3, 4], 8: [5, 6], 16: [7]}


@pytest.mark.parametrize("case", [("auto", 0), ("flat", 0), ("ranked", 0),
                                  ("auto", 3), ("ranked", 1)])
def test_resolve_policy_matches_jax(case, problem):
    batching, flush = case
    for ranks, cap, b in ((_skewed()[3], 16, 16),
                          (np.asarray(problem[1].ranks), 64, 64)):
        pp = tb.tile_plan(torch.as_tensor(np.array(ranks)), cap)
        jp = jb.tile_plan(jnp.asarray(ranks), cap)
        pol = tb.resolve_policy(batching, pp, b=b, dtype=torch.float64,
                                right_flush=flush)
        want = jb.resolve_policy(batching, jp, b=b, dtype=jnp.float64,
                                 right_flush=flush)
        assert pol.keys() == want.keys()
        for key in want:
            assert pol[key] == want[key], key
    with pytest.raises(ValueError, match="batching"):
        tb.resolve_policy("bogus", pp, b=16)


def test_choose_and_resolve_batching():
    skew = tb.tile_plan(torch.tensor([1, 1, 1, 16]), 16)
    assert tb.choose_batching(skew) == "ranked"          # skew 16 >= 4
    flat = tb.tile_plan(torch.tensor([8, 12, 16]), 16)
    assert tb.choose_batching(flat) == "flat"            # skew 2 < 4
    assert tb.choose_batching(tb.tile_plan(torch.zeros(0), 16)) == "flat"
    assert tb.choose_batching(tb.tile_plan(torch.zeros(5), 16)) == "flat"
    with pytest.raises(ValueError, match="auto"):
        tb.resolve_batching("auto")
    with pytest.raises(ValueError, match="batching"):
        tb.resolve_batching("bucketed")
    assert tb.resolve_batching(None) == "flat"
    assert tb.resolve_batching("auto", torch.tensor([1, 1, 1, 16]),
                               16) == "ranked"


def test_tile_plan_memo_and_in_place_mutation():
    """One plan per ranks object; an in-place write (the drivers write
    ``L.ranks`` in place) or a new object gets a new plan, as a mutated
    host array does in the JAX package."""
    rk = torch.tensor([0, 1, 2, 8, 8, 3], dtype=torch.int32)
    p1 = tb.tile_plan(rk, 8)
    assert tb.tile_plan(rk, 8) is p1
    rk[0] = 5
    p2 = tb.tile_plan(rk, 8)
    assert p2 is not p1 and p2.widths[0] == 8 and p1.widths[0] == 0
    rk.index_add_(0, torch.tensor([1]), torch.tensor([3], dtype=torch.int32))
    p3 = tb.tile_plan(rk, 8)
    assert p3 is not p2 and p3.widths[1] == 4
    assert tb.tile_plan(rk.clone(), 8) is not p3
    host = np.array([0, 1, 2, 8, 8, 3], np.int64)
    h1 = tb.tile_plan(host, 8)
    assert tb.tile_plan(host, 8) is h1
    host[0] = 5
    assert tb.tile_plan(host, 8).widths[0] == 8


# -- ranked rounding ----------------------------------------------------------------


def test_round_ranked_matches_jax_and_flat():
    _, jop, op = _cov_operator(0, 6, 32)
    ranks = op.ranks.numpy()
    assert ranks.min() < ranks.max()  # heterogeneous, else the test is void
    assert op.plan().rank_skew == jop.plan().rank_skew
    want = jax_round(jop.A, 1e-6, batching="ranked", impl="ref")
    for batching in ("ranked", "auto"):
        got = op.round(1e-6, batching=batching)
        np.testing.assert_array_equal(got.ranks.numpy(),
                                      np.asarray(want.ranks))
        assert _rel(got.to_dense(), want.to_dense()) <= 1e-10
    flat = tlr_round(op.A, 1e-6)
    np.testing.assert_array_equal(flat.ranks.numpy(), got.ranks.numpy())
    assert _rel(got.to_dense(), flat.to_dense()) <= 1e-10


def test_round_ranked_wide_concat_densify_bucket():
    """Accumulated concatenations whose per-tile width exceeds b route
    through the densify buckets and agree with JAX's ranked pass."""
    _, jop, _ = _cov_operator(1, 4, 32)
    S = tlr_axpy(1.0, jop.A, tlr_axpy(1.0, jop.A, jop.A))  # widths up to 3b
    assert S.r_max > jop.b and int(np.asarray(S.ranks).max()) > jop.b
    want = jax_round(S, 1e-8, batching="ranked", impl="ref")
    pS = _port(S).A
    got = tlr_round(pS, 1e-8, batching="ranked")
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(want.ranks))
    assert _rel(got.to_dense(), want.to_dense()) <= 1e-10
    flat = tlr_round(pS, 1e-8)
    assert _rel(got.to_dense(), flat.to_dense()) <= 1e-10


def test_round_tiles_ranked_needs_ranks():
    _, jop, op = _cov_operator(2, 3, 16)
    U, V = op.A.U, op.A.V
    with pytest.raises(ValueError, match="ranks"):
        tlr_round_tiles(U, V, 1e-8, batching="ranked")
    _, _, jr, je = jax_round_tiles(jop.A.U, jop.A.V, 1e-8, ranks=jop.A.ranks,
                                   batching="ranked", impl="ref")
    _, _, rf, ef = tlr_round_tiles(U, V, 1e-8)
    _, _, rr, er = tlr_round_tiles(U, V, 1e-8, ranks=op.ranks,
                                   batching="ranked")
    np.testing.assert_array_equal(rr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(rr.numpy(), rf.numpy())
    np.testing.assert_allclose(er.numpy(), np.asarray(je), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(er.numpy(), ef.numpy(), rtol=1e-10,
                               atol=1e-14)


# -- ranked read paths ----------------------------------------------------------------


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("nrhs", [None, 4])
def test_trsm_ranked_matches_jax_and_flat(trans, nrhs):
    JL, L = _both(_skewed())
    rng = np.random.default_rng(2)
    y = rng.standard_normal(L.n if nrhs is None else (L.n, nrhs))
    want = jsolve.tlr_trsv(JL, jnp.asarray(y), trans=trans, batching="ranked")
    got = tsolve.tlr_trsv(L, torch.from_numpy(y), trans=trans,
                          batching="ranked")
    flat = tsolve.tlr_trsv(L, torch.from_numpy(y), trans=trans,
                           batching="flat")
    assert got.shape == y.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-12,
                               atol=1e-12)
    # the plan widths of the column steps are JAX's
    assert tsolve._trsv_bucket_widths(tb.tile_plan(L.ranks, L.r_max), L.nb,
                                      trans, tb.rank_ladder(L.nb - 1)) == \
        jsolve._trsv_bucket_widths(jb.tile_plan(JL.ranks, JL.r_max), JL.nb,
                                   trans, jb.rank_ladder(JL.nb - 1))


@pytest.mark.parametrize("nrhs", [None, 3])
def test_matvec_ranked_matches_jax_and_flat(nrhs):
    JA, A = _both(_skewed(seed=1, sym=True))
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.n if nrhs is None else (A.n, nrhs))
    want = jsolve.tlr_matvec(JA, jnp.asarray(x), batching="ranked")
    got = tsolve.tlr_matvec(A, torch.from_numpy(x), batching="ranked")
    auto = tsolve.tlr_matvec(A, torch.from_numpy(x))
    flat = tsolve.tlr_matvec(A, torch.from_numpy(x), batching="flat")
    assert got.shape == x.shape
    for y in (got, auto):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("trans", [False, True])
def test_tri_matvec_ranked_matches_jax_and_flat(trans):
    JL, L = _both(_skewed(seed=4))
    x = np.random.default_rng(4).standard_normal((L.n, 2))
    want = jsolve.tlr_tri_matvec(JL, jnp.asarray(x), trans=trans,
                                 batching="ranked")
    got = tsolve.tlr_tri_matvec(L, torch.from_numpy(x), trans=trans,
                                batching="ranked")
    flat = tsolve.tlr_tri_matvec(L, torch.from_numpy(x), trans=trans,
                                 batching="flat")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-12,
                               atol=1e-12)


# -- the left driver ---------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(mode="fused"),
    dict(mode="dynamic", ldl=True),
    dict(mode="dynamic", on="cov2d"),
    dict(mode="fused", ldl=True, on="cov2d"),
])
def test_left_ranked_matches_jax_with_injected_probes(request, case):
    case = dict(case)
    on = case.pop("on", "problem")
    _, JA, A = request.getfixturevalue(on)
    ldl = case.pop("ldl", False)
    kw = dict(eps=1e-6, bs=8, batching="ranked") | case
    jop, op = JOperator(JA), _port_op(A)
    jf = (jop.ldlt if ldl else jop.cholesky)(JCholOptions(**kw))
    pf = (op.ldlt if ldl else op.cholesky)(
        CholOptions(probes=jax_probes(0), **kw))
    assert pf.stats["batching"] == jf.stats["batching"] == "ranked"
    np.testing.assert_array_equal(pf.L.ranks.numpy(), np.asarray(jf.L.ranks))
    assert pf.stats["column_iters"] == jf.stats["column_iters"]
    assert [e["wQ"] for e in pf.stats["column_events"]] == \
        [e["wQ"] for e in jf.stats["column_events"]]
    wq = [e["wQ"] for e in pf.stats["column_events"]]
    assert all(w in tb.rank_ladder(A.r_max) for w in wq)
    if on == "cov2d":
        assert min(wq) < A.r_max   # the ranked widths were exercised
    assert _rel(_lower(pf.L), _lower(jf.L)) <= 1e-8
    if ldl:
        assert _rel(pf.d, jf.d) <= 1e-8
    assert pf.stats["policy"] == jf.stats["policy"]


def _port_op(A):
    from repro_torch import TLROperator
    return TLROperator(A)


def test_left_auto_resolves_as_jax(problem):
    """The default ``"auto"`` takes the JAX package's decision (flat on
    this problem, whose A ranks all bucket to 64) and its factor."""
    _, JA, A = problem
    jf = JOperator(JA).cholesky(JCholOptions(eps=1e-6, bs=8))
    pf = _port_op(A).cholesky(CholOptions(eps=1e-6, bs=8,
                                          probes=jax_probes(0)))
    assert pf.stats["policy"] == jf.stats["policy"]
    assert pf.stats["batching"] == jf.stats["batching"]
    np.testing.assert_array_equal(pf.L.ranks.numpy(), np.asarray(jf.L.ranks))
    assert _rel(_lower(pf.L), _lower(jf.L)) <= 1e-8


# -- the right driver ----------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(),
    dict(ldl=True),
    # a narrow window: flushes through the densify buckets
    dict(right_flush=2, on="cov2d"),
])
def test_right_ranked_matches_jax(request, case):
    case = dict(case)
    _, JA, A = request.getfixturevalue(case.pop("on", "problem"))
    ldl = case.pop("ldl", False)
    kw = dict(eps=1e-6, algo="right", batching="ranked") | case
    jop, op = JOperator(JA), _port_op(A)
    jf = (jop.ldlt if ldl else jop.cholesky)(JCholOptions(**kw))
    pf = (op.ldlt if ldl else op.cholesky)(CholOptions(**kw))
    np.testing.assert_array_equal(pf.L.ranks.numpy(), np.asarray(jf.L.ranks))
    for key in ("flushes", "append_widths", "acc_width", "batching",
                "policy"):
        assert pf.stats[key] == jf.stats[key], key
    assert [e["wQ"] for e in pf.stats["column_events"]] == \
        [e["wQ"] for e in jf.stats["column_events"]]
    assert _rel(_lower(pf.L), _lower(jf.L)) <= 1e-8
    if ldl:
        assert _rel(pf.d, jf.d) <= 1e-8
    if case:
        assert pf.stats["flushes"] > 0
        assert min(pf.stats["append_widths"]) < A.r_max


# -- rank floors and dispatch counts ---------------------------------------------------


@pytest.fixture
def dispatch_calls(monkeypatch):
    """Counts the calls of each kernel's dispatch (``kernels/ops``), the
    launch counters of the plain path (the CUDA counters count only the
    card's launches)."""
    calls = {}
    for name in ("batched_gemm", "batched_qr", "small_svd"):
        inner = getattr(ops, name)

        def spy(*a, _inner=inner, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _inner(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    return calls


def test_zero_rank_bucket_calls_no_kernel_and_keeps_floor(dispatch_calls):
    K, jop, op = _block_diag_op()
    assert int(op.ranks.max()) == 0
    snap = trace_counts()
    R = op.round(1e-10, batching="ranked")
    assert dispatch_calls == {}            # no QR, no SVD, no GEMM
    assert trace_counts_diff(snap) == {}   # no bucket core dispatched
    assert int(R.ranks.max()) == 0
    np.testing.assert_allclose(R.to_dense().numpy(), K, rtol=0, atol=1e-12)
    # mixed: rank-0 tiles of a skewed operator stay at rank 0
    D, U, V, ranks = _skewed(nb=6, b=16, seed=5, sym=True)
    A = tlr_from_numpy(D, U, V, ranks, device="cpu")
    U2, V2, r2, e2 = tb.bucketed_round_tiles(A.U, A.V, A.ranks, 1e-12)
    zero = ranks == 0
    assert zero.any() and (r2.numpy()[zero] == 0).all()
    assert (U2.numpy()[zero] == 0).all() and (e2.numpy()[zero] == 0).all()
    assert (r2.numpy()[~zero] == ranks[~zero]).all()
    # a zero-rank read touches no plan chain
    x = torch.randn(op.n, dtype=torch.float64)
    snap = trace_counts()
    y = op.matvec(x, batching="ranked")
    assert trace_counts_diff(snap) == {}
    want = np.concatenate([K[s:s + 32, s:s + 32] @ x.numpy()[s:s + 32]
                           for s in range(0, op.n, 32)])
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-10, atol=1e-10)


def test_right_ranked_block_diagonal_no_phantom_ranks(dispatch_calls):
    """Every panel of a block-diagonal matrix is rank 0: the ranked right
    driver skips each trailing update, resurrects no rank and never
    flushes."""
    K, _, op = _block_diag_op()
    fact = op.cholesky(CholOptions(eps=1e-8, algo="right",
                                   batching="ranked"))
    assert int(fact.L.ranks.max()) == 0 and float(fact.L.U.abs().max()) == 0
    assert fact.stats["append_widths"] == [0] * (op.nb - 1)
    assert fact.stats["flushes"] == 0
    assert dispatch_calls == {}
    x = np.random.default_rng(1).standard_normal(op.n)
    y = fact.solve(torch.from_numpy(K @ x)).numpy()
    assert np.linalg.norm(y - x) / np.linalg.norm(x) < 1e-8


def test_batching_shape_count_bounded():
    """The rounding buckets dispatch O(log) shapes, reuse them across rank
    distributions sharing the ladder, and add none at steady state."""
    _, _, op = _cov_operator(7, 6, 16)
    op.round(1e-6, batching="ranked")
    t0 = tb.batching_trace_count()
    op.round(1e-6, batching="ranked")
    op.round(1e-4, batching="ranked")      # new eps: same shapes
    assert tb.batching_trace_count() == t0
    _, _, big = _cov_operator(8, 12, 16)
    t0 = tb.batching_trace_count()
    big.round(1e-6, batching="ranked")
    nt = big.A.U.shape[0]
    bound = (int(math.log2(big.r_max)) + 1) + (int(math.log2(nt)) + 1)
    assert 0 < tb.batching_trace_count() - t0 <= bound
    t0 = tb.batching_trace_count()
    big.round(1e-6, batching="ranked")
    assert tb.batching_trace_count() == t0


def test_plan_shape_count_pinned():
    """Repeated ranked reads on one plan add no dispatch shape; a fresh
    plan adds at most one per bucket."""
    D, U, V, ranks = _skewed(seed=7, sym=True)
    A = tlr_from_numpy(D, U, V, ranks, device="cpu")
    plan = tb.tile_plan(A.ranks, A.r_max)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(A.n))
    snap = trace_counts()
    tsolve.tlr_matvec(A, x, batching="ranked")
    added = trace_counts_diff(snap).get("plan", 0)
    assert 0 < added <= len(plan.buckets)
    warm = trace_counts()
    tsolve.tlr_matvec(A, x + 1.0, batching="ranked")
    tsolve.tlr_matvec(A, 2.0 * x, batching="ranked")
    assert trace_counts_diff(warm) == {}
