"""The port's telemetry layer (``repro_torch.obs``), mirroring
tests/test_obs.py case by case (span nesting, Chrome-trace schema, metrics
parity with the drivers' ``stats``, the disabled-mode pin), plus parity
with the JAX package's ``repro.obs``:

* the span trees match: on the same tiles, with JAX's probes injected into
  the left-looking driver, the left Cholesky and the ranked right
  Cholesky (then a ranked solve and matvec, and a short serve drain on
  JAX's factor carried across) record the same spans in the same order --
  name, category, parent name, depth -- with equal integer attributes;
* FLOP attributes are held to the port's own analytic
  ``TilePlan.bucket_flops`` (the JAX package takes XLA's cost_analysis);
* on the CPU an enabled span never enters NVTX (a CPU-only torch build
  has none), and ``torch.profiler`` records the spans as user ranges.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import CholOptions as JCholOptions
from repro.core import TLROperator as JOperator
from repro.serve import ServeRequest as JRequest
from repro_torch import obs
from repro_torch.convert import factorization_from_numpy, operator_from_numpy
from repro_torch.core import (CholOptions, HealthMonitor, RetryPolicy,
                              TLROperator, trace_counts, trace_counts_diff)
from repro_torch.core.batching import bucketed_round_tiles, tile_plan
from repro_torch.serve import ServeRequest

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain QR and Jacobi versions run many small ops a call: one
    intra-op thread beside the suite's other workers. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _telemetry_off():
    """Every test starts and ends with telemetry disabled (both packages)."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _dense(n=256, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2))
    d = np.linalg.norm(X[:, None] - X[None], axis=-1)
    return np.exp(-d / 0.5) + 1e-2 * np.eye(n)


def _problem(n=256, b=32, seed=0):
    return TLROperator.compress(torch.as_tensor(_dense(n, seed)), b, b, 1e-8,
                                device="cpu")


RIGHT = CholOptions(eps=1e-8, algo="right", batching="ranked")


@pytest.fixture(scope="module")
def recorded():
    """One recording over the ranked right Cholesky, a solve and a short
    serve drain (the layers of tests/test_obs.py's export test)."""
    op = _problem()
    obs.enable()
    fact = op.cholesky(RIGHT)
    fact.solve(torch.ones(op.n, dtype=op.dtype))
    srv = fact.serve(slots=4)
    srv.submit(ServeRequest("solve", rhs=np.ones(op.n)))
    srv.submit(ServeRequest("logdet"))
    srv.run()
    tel = obs.disable()
    return op, fact, tel


# -- span mechanics ------------------------------------------------------------


def test_span_nesting_and_ordering():
    tel = obs.enable()
    with obs.span("outer", cat="factor", k=0):
        with obs.span("inner_a", cat="factor"):
            pass
        with obs.span("inner_b", cat="factor") as ib:
            ib.set(flops=10.0)
    obs.disable()
    by_name = {s.name: s for s in tel.spans}
    assert set(by_name) == {"outer", "inner_a", "inner_b"}
    out, ia, ib = by_name["outer"], by_name["inner_a"], by_name["inner_b"]
    assert out.parent == -1 and out.depth == 0
    assert ia.parent == out.id and ib.parent == out.id
    assert ia.depth == ib.depth == 1
    assert out.ts <= ia.ts and ia.ts + ia.dur <= ib.ts + ib.dur
    assert ib.ts + ib.dur <= out.ts + out.dur + 1e-9
    assert ib.args["flops"] == 10.0
    assert out.args == {"k": 0}


def test_disabled_span_is_shared_noop():
    assert not obs.enabled()
    h1 = obs.span("a", cat="x", big=list(range(3)))
    h2 = obs.span("b")
    assert h1 is h2 is obs.NOOP_SPAN
    with h1 as h:
        assert h.set(x=1) is h
    assert obs.current() is None


def test_subtree_selection():
    tel = obs.enable()
    with obs.span("r1") as r1:
        with obs.span("c1"):
            with obs.span("g1"):
                pass
    with obs.span("r2"):
        pass
    obs.disable()
    assert {s.name for s in tel.subtree(r1)} == {"r1", "c1", "g1"}
    assert {s.name for s in tel.subtree(None)} == {"r1", "c1", "g1", "r2"}


def test_set_after_close_lands_on_the_span():
    """The right driver reads a panel's ranks after its span closed; the
    recorded span shares the handle's attributes."""
    tel = obs.enable()
    with obs.span("p", cat="factor") as h:
        pass
    h.set(rank_hist={"8": 3})
    obs.disable()
    assert tel.spans[0].args == {"rank_hist": {"8": 3}}


# -- Chrome-trace / Perfetto schema --------------------------------------------


def assert_chrome_trace_schema(obj):
    """tests/test_obs.py's schema check: the object form, ph/pid/tid/name
    on every event, ts+dur on complete events, JSON throughout."""
    assert isinstance(obj, dict) and isinstance(obj["traceEvents"], list)
    json.dumps(obj)
    for ev in obj["traceEvents"]:
        assert ev["ph"] in ("X", "C", "M")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert isinstance(ev["name"], str)
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
        if ev["ph"] == "M":
            assert ev["name"] in ("process_name", "thread_name")
            assert isinstance(ev["args"]["name"], str)


def test_chrome_trace_export_covers_all_layers(recorded, tmp_path):
    _, _, tel = recorded
    path = tmp_path / "trace.json"
    obj = obs.export_chrome_trace(str(path), tel)
    assert_chrome_trace_schema(obj)
    assert json.loads(path.read_text())["traceEvents"]

    evs = obj["traceEvents"]
    cats = {e.get("cat") for e in evs if e["ph"] == "X"}
    assert {"factor", "solve", "serve", "algebra"} <= cats
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"chol.factorize", "chol.diag", "chol.panel", "trsm.sweep",
            "trsm.column", "serve.tick", "round.bucket"} <= names
    serve_names = {e["name"] for e in evs
                   if e["ph"] == "X" and e.get("cat") == "serve"}
    assert {"serve.tick", "serve.pack", "serve.dispatch", "serve.sync",
            "serve.evict"} <= serve_names
    counters = {e["name"] for e in evs if e["ph"] == "C"}
    assert "retraces" in counters and "occupancy" in counters
    tids_meta = {e["tid"] for e in evs
                 if e["ph"] == "M" and e["name"] == "thread_name"}
    tids_used = {e["tid"] for e in evs if e["ph"] in ("X", "C")}
    assert tids_used <= tids_meta


def test_json_safe_takes_tensors_and_numpy_scalars():
    obs.enable()
    with obs.span("x", cat="factor", a=torch.tensor(3), b=np.float64(0.5),
                  c=torch.ones(2), d=np.int64(7)):
        pass
    obj = obs.to_chrome_trace()
    args = next(e for e in obj["traceEvents"] if e["ph"] == "X")["args"]
    assert args["a"] == 3 and args["b"] == 0.5 and args["d"] == 7
    assert isinstance(args["c"], str)
    json.dumps(obj)


def test_span_tree_nesting_in_trace():
    """Every chol.panel / chol.diag span lies inside the chol.factorize
    root's window, one level below it."""
    op = _problem(n=128, b=32, seed=1)
    obs.enable()
    op.cholesky(CholOptions(eps=1e-8, algo="left"))
    tel = obs.disable()
    roots = [s for s in tel.spans if s.name == "chol.factorize"]
    assert len(roots) == 1
    r = roots[0]
    phases = [s for s in tel.spans if s.name in ("chol.diag", "chol.panel")]
    assert phases
    for s in phases:
        assert r.ts - 1e-9 <= s.ts
        assert s.ts + s.dur <= r.ts + r.dur + 1e-9
        assert s.depth == r.depth + 1


# -- metrics parity with existing stats ----------------------------------------


def test_metrics_parity_with_driver_stats(recorded):
    op, fact, _ = recorded
    stats = fact.stats
    snap = stats["telemetry"]
    assert snap["padded_flop_ratio_plan"] == \
        stats["policy"]["padded_flop_ratio"]
    nb = op.nb
    ph = snap["phases"]
    assert ph["chol.diag"]["count"] == nb
    assert ph["chol.panel"]["count"] == len(stats["column_events"]) == nb - 1
    assert stats["flushes"] > 0
    assert ph["chol.flush"]["count"] == stats["flushes"]
    col_s = sum(e["seconds"] for e in stats["column_events"])
    assert 0 < ph["chol.panel"]["seconds"] <= col_s * 1.5 + 0.5
    assert snap["padded_flop_ratio"] >= 1.0
    assert snap["flops_padded"] >= snap["flops"] > 0
    assert set(snap["retraces"]) <= set(trace_counts())
    assert "retraces" in snap["counters"]
    # the root's subtree only: the solve and the server are not in it
    assert "trsm.sweep" not in ph and "serve.tick" not in ph


def test_bucket_flops_match_plan_estimates():
    """round.bucket spans carry the analytic FLOPs of
    ``TilePlan.bucket_flops`` at the dispatched shapes, bucket by
    bucket."""
    rng = np.random.default_rng(3)
    n, b, w = 24, 16, 16
    ranks = np.zeros(n, np.int64)
    ranks[:20] = rng.integers(1, w + 1, 20)
    U = torch.as_tensor(rng.standard_normal((n, b, w)))
    for t in range(n):
        U[t, :, ranks[t]:] = 0.0
    plan = tile_plan(ranks, w)
    obs.enable()
    bucketed_round_tiles(U, U.clone(), ranks, 1e-10, r_out=w)
    tel = obs.disable()
    spans = [s for s in tel.spans if s.name == "round.bucket"]
    assert len(spans) == len(plan.buckets)
    assert [s.args["flops_padded"] for s in spans] == plan.bucket_flops(b, w)
    for s, bk in zip(spans, plan.buckets):
        assert (s.args["width"], s.args["count"], s.args["padded"]) == \
            (bk.width, bk.count, bk.padded)
        assert 0 < s.args["flops"] <= s.args["flops_padded"]
        assert s.args["bytes"] > 0


def test_server_stats_telemetry_merge_and_null_latencies():
    from repro_torch.serve import ServerStats

    st = ServerStats(slots=4)
    p = st.latency_percentiles("solve")
    assert p["count"] == 0
    assert p["p50_s"] is None and p["p99_s"] is None
    summ = st.summary()
    assert summ["ticks"] == 0 and summ["requests_per_s"] == 0.0
    assert summ["latency"]["p50_s"] is None
    assert "telemetry" not in summ
    json.dumps(summ)

    obs.enable()
    with obs.span("serve.tick", cat="serve"):
        pass
    summ = st.summary()
    obs.disable()
    assert summ["telemetry"]["phases"]["serve.tick"]["count"] == 1


def test_health_counter_is_cumulative():
    tel = obs.enable()
    m = HealthMonitor(RetryPolicy(), "left", 4)
    m.record("spd_breakdown", 1, "diag", remedy="clamp")
    m.record("spd_breakdown", 2, "panel", remedy="jitter", attempt=1)
    m.record("rank_overflow", 2, "panel", remedy="eps_loosen", attempt=1)
    obs.disable()
    assert [c[0] for c in tel.counters] == ["health"] * 3
    assert tel.counters[-1][2] == {"spd_breakdown": 2.0,
                                   "rank_overflow": 1.0}
    assert obs.metrics_snapshot(tel)["counters"]["health"] == \
        tel.counters[-1][2]


# -- disabled-mode pin ---------------------------------------------------------


def test_disabled_mode_no_registry_drift_and_same_results():
    """With telemetry off a factorization leaves the dispatch-shape
    registry as it was and adds no ``telemetry`` key; enabling telemetry
    adds no dispatch shape and changes no bit of the factor."""
    op = _problem(n=128, b=32, seed=2)
    o = CholOptions(eps=1e-8, algo="right", batching="ranked")
    op.cholesky(o)
    snap = trace_counts()
    fact_off = op.cholesky(o)
    assert trace_counts_diff(snap) == {}
    assert "telemetry" not in fact_off.stats
    obs.enable()
    fact_on = op.cholesky(o)
    obs.disable()
    assert trace_counts_diff(snap) == {}
    assert "telemetry" in fact_on.stats
    for a, b in ((fact_on.L.D, fact_off.L.D), (fact_on.L.U, fact_off.L.U),
                 (fact_on.L.V, fact_off.L.V),
                 (fact_on.L.ranks, fact_off.L.ranks)):
        assert torch.equal(a, b)


def test_disabled_span_overhead_bound():
    """The disabled fast path is one global check: < 5 us a span on the
    CPU, per call (tests/test_obs.py's bound)."""
    assert not obs.enabled()
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span("x", cat="factor"):
            pass
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 5e-6, f"disabled span cost {per_call * 1e9:.0f} ns"


def test_disabled_mode_wall_time_overhead():
    """A warmed factorization with telemetry off stays within the band of
    itself re-run (tests/test_obs.py's 25 % + 0.05 s): the instrumented
    code is the disabled path. On the left driver at n = 256, which takes
    a tenth of a second on the CPU."""
    op = _problem(n=256, b=32, seed=4)
    o = CholOptions(eps=1e-8, algo="left")
    op.cholesky(o)
    reps = 3
    times = []
    for _ in range(2 * reps):
        t0 = time.perf_counter()
        op.cholesky(o)
        times.append(time.perf_counter() - t0)
    assert min(times[reps:]) <= min(times[:reps]) * 1.25 + 0.05


def test_export_without_recording_raises():
    with pytest.raises(RuntimeError):
        obs.to_chrome_trace()


# -- CPU behaviour of the device annotations -----------------------------------


def _raise(*a, **k):
    raise AssertionError("NVTX entered without a CUDA card")


def test_no_nvtx_without_a_card(monkeypatch):
    """A CPU-only torch build raises on NVTX: with CUDA unavailable an
    enabled span must not enter it (here through a whole factorization)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", _raise)
    obs.enable()
    with obs.span("x", cat="factor"):
        pass
    _problem(n=128, b=32).cholesky(CholOptions(eps=1e-8))
    tel = obs.disable()
    assert any(s.name == "chol.panel" for s in tel.spans)


def test_nvtx_ranges_with_a_card(monkeypatch):
    """With a card, every enabled span pushes and pops one NVTX range of
    its own name, nested as the spans are."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    obs.enable()
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    obs.disable()
    assert calls == [("push", "outer"), ("push", "inner"), ("pop",),
                     ("pop",)]
    obs.enable(device_annotations=False)
    with obs.span("quiet"):
        pass
    obs.disable()
    assert len(calls) == 4


def test_profiler_records_spans_as_user_ranges():
    """torch.profiler (CPU activity) sees the driver's spans as user
    ranges: the host ranges it links the CUDA kernels to on the card."""
    from torch.profiler import ProfilerActivity, profile

    op = _problem(n=128, b=32)
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op.cholesky(CholOptions(eps=1e-8))
    obs.disable()
    names = {e.name for e in prof.events()}
    assert {"chol.factorize", "chol.diag", "chol.panel"} <= names


# -- span trees against the JAX package -----------------------------------------

# Integer (and string) attributes compared span by span.
TREE_ATTRS = ("k", "T", "Tb", "Jb", "iters", "wk", "part", "width", "count",
              "padded", "rank_hist", "nb", "w", "kind", "stage", "tick",
              "active", "pending", "algo", "schedule", "devices", "mesh")


def _norm(v):
    if isinstance(v, dict):
        return {str(k): int(x) for k, x in v.items()}
    if isinstance(v, str):
        return v
    return int(v)


def span_tree(tel):
    """Each span in open order: name, category, parent name, depth and the
    compared attributes."""
    by_id = {s.id: s for s in tel.spans}
    out = []
    for s in sorted(tel.spans, key=lambda s: s.id):
        parent = by_id[s.parent].name if s.parent in by_id else None
        attrs = {a: _norm(s.args[a]) for a in TREE_ATTRS if a in s.args}
        out.append((s.name, s.cat, parent, s.depth, attrs))
    return out


def jax_probes(seed: int = 0):
    """The JAX driver's Omega: ``normal(fold_in(fold_in(PRNGKey(seed), k),
    it), shape)`` in the operator's dtype."""
    key = jax.random.PRNGKey(seed)

    def probes(k, it, shape, dtype, device):
        kk = jax.random.fold_in(jax.random.fold_in(key, k), it)
        z = np.array(jax.random.normal(kk, shape, jnp.float64))
        return torch.as_tensor(z, dtype=dtype, device=device)

    return probes


@pytest.fixture(scope="module")
def trees():
    """Span trees of both packages on the same tiles: n = 160, tile 32
    (nb = 5, one flush on the ranked right driver), where the JAX
    package's compiles stay near 20 s."""
    K = _dense(160)
    jop = JOperator.compress(jnp.asarray(K), 32, 32, 1e-8)
    A = jop.A
    op = operator_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")
    n = op.n
    out = {}

    jobs.enable()
    jop.cholesky(JCholOptions(eps=1e-8, algo="left"))
    out["left"] = [span_tree(jobs.disable())]
    obs.enable()
    op.cholesky(CholOptions(eps=1e-8, algo="left", probes=jax_probes(0)))
    out["left"].append(span_tree(obs.disable()))

    jobs.enable()
    jf = jop.cholesky(JCholOptions(eps=1e-8, algo="right",
                                   batching="ranked"))
    jf.solve(jnp.ones(n))
    jop.matvec(jnp.ones(n), batching="ranked")
    out["right"] = [span_tree(jobs.disable())]
    obs.enable()
    pf = op.cholesky(CholOptions(eps=1e-8, algo="right", batching="ranked"))
    pf.solve(torch.ones(n, dtype=op.dtype))
    op.matvec(torch.ones(n, dtype=op.dtype), batching="ranked")
    out["right"].append(span_tree(obs.disable()))
    out["right_ranks"] = (np.asarray(jf.L.ranks), pf.L.ranks.numpy())

    # A short drain on JAX's right factor, carried across, so that both
    # servers run the same schedule.
    L = jf.L
    cf = factorization_from_numpy(L.D, L.U, L.V, L.ranks, perm=jf.perm,
                                  device="cpu")
    rhs = np.random.default_rng(5).standard_normal((3, n))
    trees_ = []
    for fact, req in ((jf, JRequest), (cf, ServeRequest)):
        srv = fact.serve(slots=2)
        for kind, y in (("solve", rhs[0]), ("logdet", None),
                        ("sample", None), ("solve", rhs[1])):
            srv.submit(req(kind, rhs=y, seed=1))
        (jobs if req is JRequest else obs).enable()
        srv.run()
        trees_.append(span_tree((jobs if req is JRequest else obs)
                                .disable()))
    out["serve"] = trees_
    return out


def test_left_span_tree_matches_jax(trees):
    jt, pt = trees["left"]
    assert [s[0] for s in pt].count("chol.panel") == 4
    assert pt == jt


def test_right_ranked_span_tree_matches_jax(trees):
    np.testing.assert_array_equal(*trees["right_ranks"])
    jt, pt = trees["right"]
    names = {s[0] for s in pt}
    assert {"chol.flush", "chol.syrk", "chol.sync", "round.bucket",
            "algebra.syrk_column", "trsm.sweep", "trsm.column",
            "matvec.bucket"} <= names
    assert pt == jt


def test_serve_span_tree_matches_jax(trees):
    jt, pt = trees["serve"]
    assert {"serve.tick", "serve.pack", "serve.dispatch", "serve.sync",
            "serve.evict"} <= {s[0] for s in pt}
    # the factor's solves inside serve.dispatch are part of the tree
    assert pt == jt
