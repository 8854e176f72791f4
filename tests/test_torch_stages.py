"""The port's column-stage graph, the right driver's lookahead schedule, the
column SYRK's head / tail split and left-looking inter-tile pivoting
(Algorithm 9), held against the JAX package: tests/test_stages.py and the
pivoting cases of tests/test_factorization.py.

* Stage graph: the port's dependency builder and schedules on the graphs of
  tests/test_stages.py, with the same orders as the JAX package's.
* Lookahead: on the CPU only the stage order changes, so the lookahead
  factors equal the sequential ones bit for bit (flat and ranked, Cholesky
  and LDL^T), and the executed order is the JAX driver's.
* SYRK: ``head`` then ``tail`` equals one ``all`` call bit for bit, each
  part writes only its own tiles, and each agrees with the JAX package's
  ``tlr_syrk_column`` to 1e-12 (absolute, on O(1) random operands: the two
  sum the same products in other orders).
* Pivoting: with the JAX driver's probes injected (its power-iteration
  start vectors included) the pivot sequence and ranks are JAX's exactly
  and the dense factor agrees to 1e-12 relative (the drivers differ only
  in summation order; measured ~1e-14); with torch's own probes the
  factor of ``P K P^T`` meets the eps contract and the solve honours the
  permutation.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CholOptions as JCholOptions
from repro.core import LookaheadSchedule as JLookaheadSchedule
from repro.core import TLROperator as JOperator
from repro.core import covariance_problem, from_dense
from repro.core import tlr_cholesky as jax_cholesky
from repro.core import tlr_syrk_column as jax_syrk_column
from repro_torch.convert import operator_from_numpy, tlr_from_numpy
from repro_torch.core import (CholOptions, LookaheadSchedule,
                              SequentialSchedule, Stage, build_deps,
                              run_graph, tile_perm_to_element_perm,
                              tlr_cholesky, tlr_syrk_column)
from repro_torch.core.tlr import tril_pairs
from test_torch_health import jax_probes

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops a call (the plain QR and Jacobi versions):
    one intra-op thread, as tests/test_torch_rightlook.py. Restored
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stage(name, kind="diag", k=0, reads=(), writes=(), destroys=(), seq=0,
           log=None):
    fn = (lambda: log.append(name)) if log is not None else (lambda: None)
    return Stage(name=name, kind=kind, k=k, fn=fn, reads=tuple(reads),
                 writes=tuple(writes), destroys=tuple(destroys), seq=seq)


# -- dependency builder --------------------------------------------------------


def test_build_deps_raw_edges():
    stages = [
        _stage("w", writes=[("t", 0)], seq=0),
        _stage("r1", reads=[("t", 0)], seq=1),
        _stage("r2", reads=[("t", 0)], seq=2),
    ]
    deps = build_deps(stages)
    assert deps["w"] == set()
    assert deps["r1"] == {"w"}
    assert deps["r2"] == {"w"}


@pytest.mark.parametrize("kind", ["write", "destroy"])
def test_build_deps_rejects_double_write_or_destroy(kind):
    if kind == "write":
        stages = [_stage("a", writes=[("t", 0)], seq=0),
                  _stage("b", writes=[("t", 0)], seq=1)]
        match = "written twice"
    else:
        stages = [_stage("a", writes=[("t", 0)], seq=0),
                  _stage("b", destroys=[("t", 0)], seq=1),
                  _stage("c", destroys=[("t", 0)], seq=2)]
        match = "destroyed twice"
    with pytest.raises(ValueError, match=match):
        build_deps(stages)


def test_destroy_anti_dependency_is_order_independent():
    """The destroyer runs after every other reader, even readers declared
    AFTER it -- the lookahead shape, where update_tail(k) (the destroyer)
    is constructed before panel(k+1) (the reader)."""
    stages = [
        _stage("w", writes=[("t", 0)], seq=0),
        _stage("destroyer", destroys=[("t", 0)], seq=1),
        _stage("late-reader", reads=[("t", 0)], seq=2),
    ]
    deps = build_deps(stages)
    assert deps["destroyer"] == {"w", "late-reader"}
    order = [s.name for s in SequentialSchedule().order(stages)]
    assert order.index("late-reader") < order.index("destroyer")


def test_cycle_detection():
    stages = [
        _stage("a", reads=[("u", 0)], writes=[("t", 0)], seq=0),
        _stage("b", reads=[("t", 0)], writes=[("u", 0)], seq=1),
    ]
    with pytest.raises(ValueError, match="cycle"):
        SequentialSchedule().order(stages)


# -- schedules -----------------------------------------------------------------


def _right_looking_graph(nb, lookahead, stage=_stage):
    """The right-looking driver's token shape, with no-op stage bodies."""
    stages = []

    def add(name, kind, k, **kw):
        stages.append(stage(name, kind=kind, k=k, seq=len(stages), **kw))

    for k in range(nb):
        dtok = ("Dh", k - 1) if lookahead else ("Dv", k - 1)
        add(f"diag:{k}", "diag", k, reads=[dtok] if k else [],
            writes=[("Lkk", k)])
        if k + 1 >= nb:
            continue
        atok = ("acch", k - 1) if lookahead else ("acc", k - 1)
        add(f"panel:{k}", "panel", k,
            reads=([atok] if k else []) + [("Lkk", k)],
            writes=[("panel", k)])
        prev = [("acc", k - 1), ("Dv", k - 1)] if k else []
        if lookahead:
            add(f"update_head:{k}", "update_head", k, reads=[("panel", k)],
                destroys=prev, writes=[("acch", k), ("Dh", k)])
            add(f"update_tail:{k}", "update_tail", k, reads=[("panel", k)],
                destroys=[("acch", k), ("Dh", k)],
                writes=[("acc", k), ("Dv", k)])
        else:
            add(f"update:{k}", "update", k, reads=[("panel", k)],
                destroys=prev, writes=[("acc", k), ("Dv", k)])
    return stages


def test_sequential_schedule_is_program_order():
    stages = _right_looking_graph(5, lookahead=False)
    order = [s.name for s in SequentialSchedule().order(stages)]
    assert order == [s.name for s in stages]


def test_lookahead_schedule_interleaves():
    """update_tail(k) sinks below diag(k+1) + panel(k+1), in the JAX
    package's order."""
    from repro.core import Stage as JStage

    def jstage(name, kind="diag", k=0, reads=(), writes=(), destroys=(),
               seq=0):
        return JStage(name=name, kind=kind, k=k, fn=lambda: None,
                      reads=tuple(reads), writes=tuple(writes),
                      destroys=tuple(destroys), seq=seq)

    stages = _right_looking_graph(4, lookahead=True)
    order = [s.name for s in LookaheadSchedule().order(stages)]
    assert order == [
        "diag:0", "panel:0", "update_head:0",
        "diag:1", "panel:1", "update_tail:0", "update_head:1",
        "diag:2", "panel:2", "update_tail:1", "update_head:2",
        "diag:3", "update_tail:2",
    ]
    jstages = _right_looking_graph(7, lookahead=True, stage=jstage)
    assert [s.name for s in LookaheadSchedule().order(
        _right_looking_graph(7, lookahead=True))] == \
        [s.name for s in JLookaheadSchedule().order(jstages)]


def test_run_graph_executes_and_reports():
    log = []
    stages = [
        _stage("a", kind="diag", writes=[("t", 0)], seq=0, log=log),
        _stage("b", kind="panel", reads=[("t", 0)], seq=1, log=log),
    ]
    rec = run_graph(stages, SequentialSchedule())
    assert log == ["a", "b"]
    assert rec["name"] == "sequential"
    assert rec["order"] == ["a", "b"]
    assert set(rec["kind_seconds"]) == {"diag", "panel"}


# -- driver integration --------------------------------------------------------


@pytest.fixture(scope="module")
def right_op():
    """n = 256, b = 32 (nb = 8): the JAX operator and the port's on its
    tiles."""
    _, K = covariance_problem(8 * 32, 3, 32)
    jop = JOperator.compress(jnp.asarray(K), 32, 32, 1e-9)
    A = jop.A
    return np.asarray(K), jop, operator_from_numpy(A.D, A.U, A.V, A.ranks,
                                                   device="cpu")


def _same_factors(a, b):
    for x, y in ((a.L.D, b.L.D), (a.L.U, b.L.U), (a.L.V, b.L.V),
                 (a.L.ranks, b.L.ranks)):
        assert torch.equal(x, y)
    if a.d is not None:
        assert torch.equal(a.d, b.d)


@pytest.mark.parametrize("batching", ["flat", "ranked"])
def test_lookahead_matches_sequential(right_op, batching):
    """Only the stage order changes: the lookahead factor equals the
    sequential one exactly, and the order and flush count are the JAX
    driver's (flat; the ranked driver's flushes are held to JAX's in
    tests/test_torch_batching.py)."""
    _, jop, op = right_op
    kw = dict(eps=1e-6, algo="right", batching=batching)
    fs = op.cholesky(CholOptions(**kw))
    fl = op.cholesky(CholOptions(lookahead=True, **kw))
    assert fs.stats["schedule"]["name"] == "sequential"
    assert fl.stats["schedule"]["name"] == "lookahead"
    assert fl.stats["schedule"]["requested_lookahead"] is True
    assert fl.stats["schedule"]["streams"] == 1     # no second stream here
    _same_factors(fs, fl)
    for key in ("flushes", "append_widths", "column_iters"):
        assert fs.stats[key] == fl.stats[key]
    order = fl.stats["schedule"]["order"]
    assert order.index("update_tail:0") > order.index("panel:1")
    if batching == "flat":
        jf = jop.cholesky(JCholOptions(lookahead=True, **kw))
        assert order == jf.stats["schedule"]["order"]
        assert fl.stats["flushes"] == jf.stats["flushes"]


def test_lookahead_ldlt_matches_sequential(right_op):
    _, _, op = right_op
    kw = dict(eps=1e-6, algo="right", batching="flat")
    fs = op.ldlt(CholOptions(**kw))
    fl = op.ldlt(CholOptions(lookahead=True, **kw))
    _same_factors(fs, fl)


def test_left_driver_records_but_ignores_lookahead():
    """The left driver's column graph is a serial chain -- the flag is
    recorded in the schedule stats but the order stays sequential."""
    _, K = covariance_problem(4 * 32, 3, 32)
    jop = JOperator.compress(jnp.asarray(K), 32, 32, 1e-9)
    op = operator_from_numpy(jop.A.D, jop.A.U, jop.A.V, jop.A.ranks,
                             device="cpu")
    f = op.cholesky(CholOptions(eps=1e-6, algo="left", lookahead=True))
    jf = jop.cholesky(JCholOptions(eps=1e-6, algo="left", lookahead=True))
    for fact in (f, jf):
        assert fact.stats["schedule"]["name"] == "sequential"
        assert fact.stats["schedule"]["requested_lookahead"] is True
    assert f.stats["schedule"]["order"] == jf.stats["schedule"]["order"]


def test_schedule_stats_schema(right_op):
    _, _, op = right_op
    f = op.cholesky(CholOptions(eps=1e-6, algo="right", lookahead=True))
    sched = f.stats["schedule"]
    assert set(sched) >= {"name", "stages", "order", "kind_seconds",
                          "requested_lookahead"}
    assert sched["stages"] == len(sched["order"])
    # one diag per column, one panel + head + tail per off-diagonal column
    assert sched["stages"] == op.nb + 3 * (op.nb - 1)
    assert set(sched["kind_seconds"]) == {"diag", "panel", "update_head",
                                          "update_tail"}


# -- the column SYRK's head / tail split ---------------------------------------


def _syrk_args(nb=6, b=16, r=4, k=1, seed=0):
    rng = np.random.default_rng(seed)
    nt = nb * (nb - 1) // 2
    w = 3 * r + b
    T = nb - 1 - k
    return (rng.standard_normal((nt, b, w)), rng.standard_normal((nt, b, w)),
            rng.standard_normal((nb, b, b)), rng.standard_normal((T, b, r)),
            rng.standard_normal((T, b, r)), np.full((T,), r, np.int32))


def _port_syrk(args, used, k, parts, dk=None):
    accU, accV, D, Up, Vn, ranks = (torch.from_numpy(np.array(x))
                                    for x in args)
    for part in parts:
        tlr_syrk_column(accU, accV, used, D, Up, Vn, ranks, dk, k, part=part)
    return accU, accV, D


@pytest.mark.parametrize("offset", ["scalar", "per_tile"])
def test_syrk_head_plus_tail_equals_all(offset):
    """head then tail equals one "all" call bit for bit, and the JAX
    package's head / tail / all to 1e-12; per-tile offsets (ranked
    batching) as well as the scalar fast path."""
    args = _syrk_args()
    nb, k = 6, 1
    nt = nb * (nb - 1) // 2
    used = 16 if offset == "scalar" else \
        np.random.default_rng(1).integers(0, 16, nt)
    a = _port_syrk(args, used, k, ["all"])
    ht = _port_syrk(args, used, k, ["head", "tail"])
    for x, y in zip(a, ht):
        assert torch.equal(x, y)
    jargs = [jnp.asarray(x) for x in args]
    ja = jax_syrk_column(jargs[0], jargs[1], used, jargs[2], jargs[3],
                         jargs[4], jargs[5], None, k)
    jh = jax_syrk_column(jargs[0], jargs[1], used, jargs[2], jargs[3],
                         jargs[4], jargs[5], None, k, part="head")
    for part, want in (("all", ja), ("head", jh)):
        got = _port_syrk(args, used, k, [part])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-12)


def test_syrk_parts_write_only_their_tiles():
    """Each part leaves every tile and diagonal block outside its own set
    untouched: head writes column k+1's tiles and D[k+1], tail the tiles
    (i, j) with j > k+1 and D[k+2:] -- what lets a tail on a second stream
    run beside the next panel's reads."""
    args = _syrk_args(nb=7, k=1)
    nb, k = 7, 1
    pairs = tril_pairs(nb)
    base = [torch.from_numpy(np.array(x)) for x in args[:3]]
    for part, cols, dks in (("head", pairs[:, 1] == k + 1, [k + 1]),
                            ("tail", pairs[:, 1] > k + 1,
                             list(range(k + 2, nb)))):
        accU, accV, D = _port_syrk(args, 16, k, [part])
        changed = (accU != base[0]).flatten(1).any(1).numpy()
        assert (changed == cols).all()
        assert ((accV != base[1]).flatten(1).any(1).numpy() == cols).all()
        dchanged = np.nonzero((D != base[2]).flatten(1).any(1).numpy())[0]
        assert dchanged.tolist() == dks


def test_syrk_in_place_matches_jax_ldl():
    """The in-place LDL^T update (with D_k) matches the JAX package's
    copying default, which leaves its inputs alive."""
    args = _syrk_args(seed=2)
    dk = np.random.default_rng(3).uniform(0.5, 2.0, 16)
    got = _port_syrk(args, 16, 1, ["all"], dk=torch.from_numpy(dk))
    jargs = [jnp.asarray(x) for x in args]
    want = jax_syrk_column(jargs[0], jargs[1], 16, jargs[2], jargs[3],
                           jargs[4], jargs[5], jnp.asarray(dk), 1)
    assert not jargs[0].is_deleted()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_bad_part_rejected():
    args = [torch.from_numpy(np.array(x)) for x in _syrk_args()]
    accU, accV, D, Up, Vn, ranks = args
    with pytest.raises(ValueError, match="part"):
        tlr_syrk_column(accU, accV, 16, D, Up, Vn, ranks, None, 1,
                        part="middle")


@pytest.mark.parametrize("algo", ["left", "right"])
def test_factorization_emits_no_warnings(algo):
    """A lookahead factorization warns about nothing (the JAX test checks
    for donation warnings; the port writes in place) and meets the eps
    contract."""
    _, K = covariance_problem(4 * 32, 3, 32)
    K = np.asarray(K)
    jop = JOperator.compress(jnp.asarray(K), 32, 32, 1e-9)
    op = operator_from_numpy(jop.A.D, jop.A.U, jop.A.V, jop.A.ranks,
                             device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        f = op.cholesky(CholOptions(eps=1e-6, algo=algo, lookahead=True))
    assert [str(w.message) for w in rec] == []
    L = np.tril(f.L.to_dense().numpy())
    err = np.linalg.norm(K - L @ L.T, 2)
    assert err < (1e-2 if algo == "left" else 1e-4)


# -- inter-tile pivoting (Algorithm 9) -----------------------------------------


@pytest.fixture(scope="module")
def pivot_problem():
    """tests/test_factorization.py's ``_cov_tlr(n=384, b=64)``, and the same
    K scaled by a random positive diagonal, ``S K S``.

    The covariance of the regular grid has diagonal tiles in mirror-image
    pairs whose Frobenius norms tie to the last bit or two (16.16385652677788
    twice, in both packages), so which of a tied pair the argmax picks is
    decided by the norm's reduction order (XLA's against torch's) -- either
    is the argmax in exact arithmetic. The scaled K separates the candidates
    (its diagonal tiles' norms differ by percents), so there the pivot
    sequences must be equal; it is the n = 256 covariance, to keep the
    JAX runs short."""
    _, K = covariance_problem(384, 3, 64)
    K = np.asarray(K)
    _, K4 = covariance_problem(256, 3, 64)
    s = np.exp(0.2 * np.random.default_rng(0).standard_normal(256))
    out = {}
    for name, M in (("grid", K),
                    ("scaled", s[:, None] * np.asarray(K4) * s[None, :])):
        A = from_dense(jnp.asarray(M), 64, 64, 1e-7)
        out[name] = (M, A, tlr_from_numpy(A.D, A.U, A.V, A.ranks,
                                          device="cpu"))
    return out


def _pivoted_error(K, fact):
    """||P K P^T - L L^T||_2 via the dense lower factor."""
    L = np.tril(fact.L.to_dense().numpy())
    e = tile_perm_to_element_perm(fact.perm, fact.L.b)
    return np.linalg.norm(K[np.ix_(e, e)] - L @ L.T, 2)


@pytest.mark.parametrize("pivot", ["frobenius", "power"])
def test_pivoted_cholesky_matches_jax(pivot_problem, pivot):
    """JAX's probes injected: the same pivot sequence and permutation, the
    same ranks, the factor to 1e-12 relative (on the scaled K, whose
    candidates do not tie)."""
    K, A, At = pivot_problem["scaled"]
    kw = dict(eps=1e-6, bs=8, pivot=pivot, batching="flat")
    jf = jax_cholesky(A, JCholOptions(**kw))
    pf = tlr_cholesky(At, CholOptions(probes=jax_probes(0), **kw))
    assert pf.stats["pivots"] == jf.stats["pivots"]
    np.testing.assert_array_equal(pf.perm, np.asarray(jf.perm))
    assert (pf.perm != np.arange(A.nb)).any()       # the swaps happened
    np.testing.assert_array_equal(pf.L.ranks.numpy(), np.asarray(jf.L.ranks))
    Lj = np.tril(np.asarray(jf.L.to_dense()))
    Lp = np.tril(pf.L.to_dense().numpy())
    assert np.linalg.norm(Lp - Lj) / np.linalg.norm(Lj) <= 1e-12


@pytest.mark.parametrize("pivot", ["frobenius", "power"])
def test_pivoted_cholesky(pivot_problem, pivot):
    """Inter-tile pivoting with torch's own probes: a correct factorization
    of P A P^T, and a solve that honours the permutation."""
    K, A, At = pivot_problem["grid"]
    fact = tlr_cholesky(At, CholOptions(eps=1e-6, bs=8, pivot=pivot))
    assert _pivoted_error(K, fact) < 1e-4
    assert fact.perm.shape == (A.nb,)
    assert sorted(fact.perm.tolist()) == list(range(A.nb))
    assert len(fact.stats["pivots"]) == A.nb
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(384)
    x = fact.solve(torch.from_numpy(K @ x_true)).numpy()
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-2
