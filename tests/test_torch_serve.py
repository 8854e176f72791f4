"""The port's TLR inference server (``repro_torch/serve``) against the JAX
package's: one mixed schedule through both servers on the same factor and
operator (carried across with ``repro_torch.convert``), tick by tick; the
packed sample product on JAX's own draw; the no-new-dispatch-shape pin
after warmup; and the cases of tests/test_serve.py and of the serve half
of tests/test_health.py (rejections, unknown and evicted residents,
deadline timeouts under ``serve.admit``, a poisoned column under
``serve.solve``, breakdown retries with backoff, the health counters).

Tolerances: equal completion order, ticks, attempts, ok / error and
per-tick occupancy; solve values and logdet within 1e-12 of JAX's;
samples within 1e-12 of the port's sequential ``fact.sample(z=draw)`` on
the request's draw, and the packed sample product within 1e-12 of JAX's
on JAX's draw; pcg_solve with equal iterations and values within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.core import TLROperator as JOperator
from repro.serve import ServeRequest as JRequest
from repro.serve import TLRServer as JServer
from repro_torch import faults
from repro_torch.convert import factorization_from_numpy, operator_from_numpy
from repro_torch.core import TLROperator, trace_counts, trace_counts_diff
from repro_torch.serve import (KINDS, RequestQueue, RequestRejected,
                               ServeRequest, ServerStats, TLRServer)

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

N, B = 128, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops a call: one intra-op thread beside the suite's
    other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spd(n=N, seed=0, shift=2.0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return M @ M.T / n + shift * np.eye(n)


def _carry(jop, jfact):
    """The JAX operator and factor as the port's, on the CPU."""
    A, L = jop.A, jfact.L
    op = operator_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")
    fact = factorization_from_numpy(L.D, L.U, L.V, L.ranks, d=jfact.d,
                                    perm=jfact.perm, device="cpu")
    return op, fact


@pytest.fixture(scope="module")
def problem():
    """The dense A, the JAX operator and Cholesky, and the port's copies."""
    A = _spd()
    jop = JOperator.compress(jnp.asarray(A), B, eps=1e-10)
    jfact = jop.cholesky()
    return (A, jop, jfact) + _carry(jop, jfact)


@pytest.fixture(scope="module")
def iterative_problem():
    """A near-exact operator with a loose factor (compressed at 0.5) as the
    preconditioner, so PCG iterates and per-request tolerances spread."""
    A = _spd(seed=4)
    jop = JOperator.compress(jnp.asarray(A), B, eps=1e-10)
    jfact = JOperator.compress(jnp.asarray(A), B, eps=0.5).cholesky()
    return (A, jop, jfact) + _carry(jop, jfact)


def _mixed(n, count, seed=100, cls=ServeRequest, tol=1e-8):
    """A deterministic mixed schedule cycling through every kind (the JAX
    suite's ``_mixed_requests``)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for k in range(count):
        kind = KINDS[k % len(KINDS)]
        rhs = (rng.standard_normal(n)
               if kind in ("solve", "pcg_solve") else None)
        reqs.append(cls(kind, rhs=rhs, tol=tol, maxiter=150, seed=k))
    return reqs


def _draw(req, n=N):
    return torch.randn((n, 1), generator=req.sample_generator(),
                       dtype=torch.float64)


def _same_schedule(srv, jsrv):
    """Completion order, per-request bookkeeping and occupancy equal."""
    assert list(srv.results) == list(jsrv.results)
    for rid, out in srv.results.items():
        ref = jsrv.results[rid]
        assert (out.kind, out.ticks, out.attempts, out.ok, out.error,
                out.iterations, out.converged, out.breakdown) == (
            ref.kind, ref.ticks, ref.attempts, ref.ok, ref.error,
            ref.iterations, ref.converged, ref.breakdown), rid
    assert srv.stats.tick_active == jsrv.stats.tick_active
    for key in ("ticks", "admitted", "completed", "rejected", "timeouts",
                "errors", "pcg_retries"):
        assert getattr(srv.stats, key) == getattr(jsrv.stats, key), key


# -- parity with JAX and the no-new-shape pin ----------------------------------


def test_mixed_drain_matches_jax(problem):
    """36 mixed requests through both servers: the same schedule tick by
    tick, the same values, and no new dispatch shape after warmup."""
    A, jop, jfact, op, fact = problem
    srv = fact.serve(operator=op, slots=8, check_every=4)
    snap = trace_counts()
    jsrv = jfact.serve(operator=jop, slots=8, check_every=4)
    reqs = _mixed(N, 36)
    for r, jr in zip(reqs, _mixed(N, 36, cls=JRequest)):
        assert srv.submit(r) == jsrv.submit(jr)
    results = srv.run()
    assert trace_counts_diff(snap) == {}
    jresults = jsrv.run()
    assert len(results) == 36 and srv.pending == 0 and srv.active == 0
    _same_schedule(srv, jsrv)
    ld = float(fact.logdet())
    for r in reqs:
        out, ref = results[r.rid], jresults[r.rid]
        assert out.ok
        if r.kind == "solve":
            np.testing.assert_allclose(out.value, ref.value, rtol=1e-12,
                                       atol=1e-12)
        elif r.kind == "logdet":
            assert out.value == ld
            assert out.value == pytest.approx(ref.value, abs=1e-12)
        elif r.kind == "sample":
            want = fact.sample(z=_draw(r)).numpy()
            np.testing.assert_allclose(out.value, want, rtol=1e-12,
                                       atol=1e-12)
        else:
            assert out.converged and out.history[-1] < 1e-8
            assert len(out.history) == len(ref.history)
            np.testing.assert_allclose(list(out.history), list(ref.history),
                                       rtol=0, atol=1e-8)
            np.testing.assert_allclose(out.value, ref.value, rtol=1e-8,
                                       atol=1e-8)
            np.testing.assert_allclose(out.value, np.linalg.solve(A, r.rhs),
                                       rtol=1e-5, atol=1e-6)


def test_sample_block_on_jax_draw(problem):
    """The packed ``L @ Z`` sample product of both servers on JAX's own
    per-request draws."""
    _, jop, jfact, op, fact = problem
    srv = fact.serve(slots=4, warmup=False)
    jsrv = jfact.serve(slots=4, warmup=False)
    Z = np.zeros((N, 4))
    for i, seed in enumerate((3, 7, 11)):
        Z[:, i] = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                               (N, 1), jnp.float64))[:, 0]
    got = srv._sample_block(srv._residents["default"], torch.as_tensor(Z))
    want = jsrv._sample_block(jsrv._residents["default"], jnp.asarray(Z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(got[:, 3].numpy(), 0.0)


def test_sample_draw_is_the_requests_own(problem):
    """A request's draw depends on its seed (or rid) alone: the same on
    every call and for every slot it lands in."""
    fact = problem[4]
    srv = fact.serve(slots=3)
    reqs = [ServeRequest("sample", seed=5), ServeRequest("sample"),
            ServeRequest("sample", seed=5)]
    rids = [srv.submit(r) for r in reqs]
    results = srv.run()
    np.testing.assert_array_equal(results[rids[0]].value,
                                  results[rids[2]].value)
    want = fact.sample(z=_draw(ServeRequest("sample", seed=rids[1])))
    np.testing.assert_allclose(results[rids[1]].value, want.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_stats_record(problem):
    op, fact = problem[3:]
    srv = fact.serve(operator=op, slots=4, check_every=4)
    for r in _mixed(N, 16, seed=101):
        srv.submit(r)
    srv.run()
    st = srv.stats
    assert st.completed == st.admitted == 16
    assert sum(st.tick_active) == sum(res.ticks
                                      for res in srv.results.values())
    assert 0.0 < st.occupancy() <= 1.0
    summ = st.summary()
    assert summ["slots"] == 4 and summ["completed"] == 16
    assert summ["latency"]["count"] == 16
    assert summ["latency"]["p99_s"] >= summ["latency"]["p50_s"] > 0.0
    assert "telemetry" not in summ
    for kind in KINDS:
        assert summ[f"latency_{kind}"]["count"] == 4
    assert all(res.latency_s > 0 and res.ticks >= 1
               for res in srv.results.values())


def test_eviction_refill_invariants_randomized(problem):
    """Random interleaving of submits and ticks: occupancy never exceeds
    the slot count, direct kinds complete in their admission tick, every
    request completes exactly once, in FIFO order per direct kind."""
    op, fact = problem[3:]
    rng = np.random.default_rng(7)
    srv = fact.serve(operator=op, slots=3, check_every=2)
    reqs = _mixed(N, 24, seed=102)
    pending = list(reqs)
    submitted = []
    while pending or srv.pending or srv.active:
        if pending and (rng.random() < 0.6 or not (srv.pending
                                                   or srv.active)):
            burst = rng.integers(1, 5)
            for r in pending[:burst]:
                submitted.append(srv.submit(r))
            pending = pending[burst:]
        else:
            srv.tick()
        assert srv.active <= srv.slots
    results = srv.run()
    assert sorted(results) == sorted(submitted)
    for r in reqs:
        out = results[r.rid]
        if r.kind in ("solve", "logdet", "sample"):
            assert out.ticks == 1
        else:
            assert out.ticks >= 1 and out.converged
    order = list(results)
    for kind in ("solve", "logdet", "sample"):
        rids = [r.rid for r in reqs if r.kind == kind]
        assert [q for q in order if q in rids] == sorted(rids)


def test_slot_starvation_free_under_long_pcg(iterative_problem):
    op, fact = iterative_problem[3:]
    srv = fact.serve(operator=op, slots=2, check_every=1)
    rng = np.random.default_rng(8)
    slow = ServeRequest("pcg_solve", rhs=rng.standard_normal(N), tol=1e-12,
                        maxiter=200)
    srv.submit(slow)
    quick = [ServeRequest("solve", rhs=rng.standard_normal(N))
             for _ in range(4)]
    for r in quick:
        srv.submit(r)
    results = srv.run()
    assert results[slow.rid].ticks > 1
    assert all(results[r.rid].ticks == 1 for r in quick)


def test_per_request_tolerance_and_budget_matches_jax(iterative_problem):
    A, jop, jfact, op, fact = iterative_problem
    b = np.random.default_rng(9).standard_normal(N)
    srv = fact.serve(operator=op, slots=4, check_every=4)
    jsrv = jfact.serve(operator=jop, slots=4, check_every=4)
    for tol, maxiter in ((1e-2, 200), (1e-11, 200), (1e-30, 3)):
        srv.submit(ServeRequest("pcg_solve", rhs=b, tol=tol,
                                maxiter=maxiter))
        jsrv.submit(JRequest("pcg_solve", rhs=b, tol=tol, maxiter=maxiter))
    results = srv.run()
    jsrv.run()
    _same_schedule(srv, jsrv)
    lo, hi, cap = (results[i] for i in range(3))
    assert lo.iterations < hi.iterations
    assert lo.history[-1] < 1e-2 and hi.history[-1] < 1e-11
    assert cap.iterations == 3 and not cap.converged
    for res in (lo, hi):
        rel = np.linalg.norm(A @ res.value - b) / np.linalg.norm(b)
        assert rel < (1e-2 if res is lo else 1e-10)
        np.testing.assert_allclose(res.value, jsrv.results[res.rid].value,
                                   rtol=1e-8, atol=1e-8)


# -- routing and validation ----------------------------------------------------


def test_multi_factorization_routing():
    """Two residents of the port's own compression and Cholesky."""
    ops = [TLROperator.compress(torch.as_tensor(_spd(seed=s, shift=h)), B,
                                eps=1e-10) for s, h in ((1, 2.0), (2, 3.0))]
    f1, f2 = (o.cholesky() for o in ops)
    srv = TLRServer(slots=4, check_every=4)
    srv.register("a", f1, operator=ops[0])
    srv.register("b", f2, operator=ops[1])
    srv.warmup()
    y = np.random.default_rng(10).standard_normal(N)
    with pytest.raises(ValueError, match="fid is required"):
        srv.submit(ServeRequest("solve", rhs=y))
    ra = ServeRequest("solve", rhs=y, fid="a")
    rb = ServeRequest("solve", rhs=y, fid="b")
    rl = ServeRequest("logdet", fid="b")
    for r in (ra, rb, rl):
        srv.submit(r)
    results = srv.run()
    for r, f in ((ra, f1), (rb, f2)):
        np.testing.assert_allclose(results[r.rid].value,
                                   f.solve(torch.as_tensor(y)).numpy(),
                                   rtol=1e-12, atol=1e-12)
    assert results[rl.rid].value == pytest.approx(float(f2.logdet()))
    with pytest.raises(ValueError, match="already registered"):
        srv.register("a", f1)


def test_submit_validation(problem):
    fact = problem[4]
    srv = TLRServer(slots=2)
    srv.register("f", fact)               # no operator: pcg unavailable
    y = np.ones(N)
    with pytest.raises(ValueError, match="unknown request kind"):
        srv.submit(ServeRequest("inverse", rhs=y))
    with pytest.raises(ValueError, match="requires rhs"):
        srv.submit(ServeRequest("solve"))
    with pytest.raises(ValueError, match="rhs length"):
        srv.submit(ServeRequest("solve", rhs=np.ones(N + 1)))
    with pytest.raises(ValueError, match="registered with its operator"):
        srv.submit(ServeRequest("pcg_solve", rhs=y))
    with pytest.raises(ValueError, match="unknown factorization"):
        srv.submit(ServeRequest("solve", rhs=y, fid="nope"))
    with pytest.raises(KeyError):
        srv.result(123)
    assert srv.pending == 0 and srv.stats.rejected == 5
    # a right-hand side given as a tensor is taken to the host
    rid = srv.submit(ServeRequest("solve", rhs=torch.ones(N)))
    np.testing.assert_allclose(srv.run()[rid].value,
                               fact.solve(torch.ones(N, dtype=torch.float64))
                               .numpy(), rtol=1e-12, atol=1e-12)


def test_sample_requires_cholesky():
    op = TLROperator.compress(torch.as_tensor(_spd(n=64, seed=3)), 32,
                              eps=1e-10)
    fact = op.ldlt()
    srv = TLRServer(slots=2)
    srv.register("f", fact)
    with pytest.raises(ValueError, match="Cholesky"):
        srv.submit(ServeRequest("sample"))
    y = np.ones(64)
    r = ServeRequest("solve", rhs=y)
    srv.submit(r)
    results = srv.run()
    np.testing.assert_allclose(results[r.rid].value,
                               fact.solve(torch.as_tensor(y)).numpy(),
                               rtol=1e-10, atol=1e-10)


def test_request_queue_fifo():
    q = RequestQueue()
    rids = [q.submit(ServeRequest("logdet")) for _ in range(3)]
    assert rids == [0, 1, 2] and len(q) == 3
    assert q.peek().rid == 0
    assert [q.pop().rid for _ in range(3)] == rids
    assert q.pop() is None and not q


def test_server_stats_empty():
    st = ServerStats(slots=4)
    assert st.occupancy() == 0.0
    assert st.latency_percentiles()["count"] == 0
    assert st.summary()["requests_per_s"] == 0.0


def test_server_needs_a_card_unless_the_factor_is_on_the_cpu(problem):
    """The engine of a CPU factor lives on the CPU; an engine with no
    device to infer defaults to the card, which is absent here."""
    op, fact = problem[3:]
    srv = fact.serve(operator=op, slots=2, warmup=False)
    assert srv._residents["default"].engine.X.device.type == "cpu"
    if not torch.cuda.is_available():
        from repro_torch.core import BatchedPCG
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchedPCG(lambda v: v, N, 2)


# -- serve-side degradation (tests/test_health.py), against JAX ----------------


def test_submit_rejects_nonfinite_rhs(problem):
    op, fact = problem[3:]
    srv = fact.serve(operator=op, slots=2)
    rhs = np.ones(N)
    rhs[3] = np.inf
    with pytest.raises(RequestRejected, match="non-finite"):
        srv.submit(ServeRequest("solve", rhs=rhs))
    with pytest.raises(ValueError):
        srv.submit(ServeRequest("pcg_solve", rhs=rhs))
    assert srv.stats.rejected == 2
    assert srv.pending == 0 and srv.active == 0


def test_unknown_and_evicted_fid(problem):
    op, fact = problem[3:]
    srv = TLRServer(slots=2)
    srv.register("f0", fact, operator=op)
    with pytest.raises(RequestRejected, match="unknown factorization"):
        srv.submit(ServeRequest("logdet", fid="nope"))
    rid = srv.submit(ServeRequest("logdet"))
    srv.tick()                            # rid completes
    queued = srv.submit(ServeRequest("solve", rhs=np.ones(N)))
    pcg_rid = srv.submit(ServeRequest("pcg_solve", rhs=np.ones(N),
                                      tol=1e-14))
    srv._refill()                         # pcg_rid takes a slot
    srv.evict_resident("f0")
    assert srv.results[rid].ok
    for q in (queued, pcg_rid):
        res = srv.results[q]
        assert not res.ok and res.error == "resident_evicted"
    with pytest.raises(RequestRejected, match="was evicted"):
        srv.submit(ServeRequest("logdet", fid="f0"))
    with pytest.raises(RequestRejected, match="unknown factorization"):
        srv.evict_resident("f0")
    assert srv.stats.errors == 2 and srv.active == 0


def _both_servers(problem, slots, jop=None, op=None):
    _, jop0, jfact, op0, fact = problem
    srv = fact.serve(operator=op or op0, slots=slots)
    jsrv = jfact.serve(operator=jop or jop0, slots=slots)
    return srv, jsrv


def test_deadline_timeout_isolated_matches_jax(problem):
    A = problem[0]
    srv, jsrv = _both_servers(problem, 2)
    rng = np.random.default_rng(1)
    rhs = [rng.standard_normal(N) for _ in range(2)]
    rs = srv.submit(ServeRequest("solve", rhs=rhs[0], deadline_ticks=2))
    ro = srv.submit(ServeRequest("solve", rhs=rhs[1]))
    jsrv.submit(JRequest("solve", rhs=rhs[0], deadline_ticks=2))
    jsrv.submit(JRequest("solve", rhs=rhs[1]))
    with faults.inject(faults.Fault(site="serve.admit", rid=rs, delay=6)):
        results = srv.run(max_ticks=10)
    with jfaults.inject(jfaults.Fault(site="serve.admit", rid=rs, delay=6)):
        jsrv.run(max_ticks=10)
    _same_schedule(srv, jsrv)
    assert results[rs].error == "timeout" and not results[rs].ok
    assert results[rs].value is None
    assert results[ro].ok
    np.testing.assert_allclose(results[ro].value, np.linalg.solve(A, rhs[1]),
                               atol=1e-7)
    assert srv.stats.timeouts == 1


def test_deadline_cancels_a_slotted_pcg_column(iterative_problem):
    """A pcg_solve past its deadline leaves its slot mid-flight; the
    freed column serves the next request in the same tick."""
    srv, jsrv = _both_servers(iterative_problem, 1)
    rng = np.random.default_rng(11)
    b, y = rng.standard_normal(N), rng.standard_normal(N)
    for s, R in ((srv, ServeRequest), (jsrv, JRequest)):
        s.submit(R("pcg_solve", rhs=b, tol=1e-14, maxiter=500,
                   deadline_ticks=3))
        s.submit(R("solve", rhs=y))
    results = srv.run()
    jsrv.run()
    _same_schedule(srv, jsrv)
    assert results[0].error == "timeout" and results[1].ok
    assert results[1].ticks == 1 and srv.stats.timeouts == 1


def test_poisoned_column_isolated_matches_jax(problem):
    A = problem[0]
    srv, jsrv = _both_servers(problem, 4)
    rng = np.random.default_rng(2)
    rhs = [rng.standard_normal(N) for _ in range(3)]
    rids = [srv.submit(ServeRequest("solve", rhs=y)) for y in rhs]
    for y in rhs:
        jsrv.submit(JRequest("solve", rhs=y))
    with faults.inject(faults.Fault(site="serve.solve", rid=rids[1])):
        results = srv.run()
    with jfaults.inject(jfaults.Fault(site="serve.solve", rid=rids[1])):
        jresults = jsrv.run()
    _same_schedule(srv, jsrv)
    bad = results[rids[1]]
    assert not bad.ok and bad.error == "nonfinite_result"
    assert bad.value is None
    for y, rid in zip(rhs, rids):
        if rid == rids[1]:
            continue
        assert results[rid].ok and np.isfinite(results[rid].value).all()
        np.testing.assert_allclose(results[rid].value, jresults[rid].value,
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(results[rid].value,
                                   np.linalg.solve(A, y), atol=1e-7)
    assert srv.stats.errors == 1


def test_pcg_breakdown_retries_with_backoff_matches_jax(problem):
    """PCG against an indefinite operator breaks down; the request
    re-admits with exponential backoff up to its retry budget, then
    completes as a typed degraded result, as in the JAX package."""
    A = problem[0]
    jneg = JOperator.compress(jnp.asarray(-A), 32, eps=1e-10)
    neg = operator_from_numpy(jneg.A.D, jneg.A.U, jneg.A.V, jneg.A.ranks,
                              device="cpu")
    srv, jsrv = _both_servers(problem, 2, jop=jneg, op=neg)
    b = np.random.default_rng(3).standard_normal(N)
    rid = srv.submit(ServeRequest("pcg_solve", rhs=b, tol=1e-10,
                                  retries=2))
    jsrv.submit(JRequest("pcg_solve", rhs=b, tol=1e-10, retries=2))
    results = srv.run(max_ticks=50)
    jsrv.run(max_ticks=50)
    _same_schedule(srv, jsrv)
    out = results[rid]
    assert not out.ok and out.error == "pcg_breakdown"
    assert out.breakdown is not None
    assert out.attempts == 3
    assert srv.stats.pcg_retries == 2 and srv.stats.errors == 1
    assert srv.stats.ticks == jsrv.stats.ticks


def test_health_counters_in_summary(problem):
    op, fact = problem[3:]
    srv = fact.serve(operator=op, slots=2)
    h = srv.stats.summary()["health"]
    assert set(h) == {"rejected", "timeouts", "errors", "pcg_retries"}
