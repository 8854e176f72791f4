"""Breakdown detection, bounded recovery and the fault-injection matrix of
the port (``core/health.py``, ``faults.py`` and the drivers' ``check=True``
hooks), held against the JAX package on the same operands: the
factorization half of tests/test_health.py (its serve half waits for the
server's port).

Both packages factor the same tiles (the JAX operand carried across as
numpy arrays) and plant the same faults (``spike_rank`` draws its spike
from numpy's ``default_rng(seed)`` in both). The left driver runs with the
JAX driver's probes injected -- including the rank-overflow re-pass's
stream ``fold_in(fold_in(key, k), 7000 + attempt)`` -- so both take the
same decisions. Compared exactly: each recorded event's kind, column,
stage, remedy, attempt and rows, a breakdown's reason, column and
remedies, ``columns_checked``. Compared to tolerance: the jitter shifts to
1e-6 relative (they come from one eigenvalue each, computed by different
LAPACK calls); a repaired factor to 1e-8 relative: the repairs factor a
tile whose smallest eigenvalues sit at the clamp ``eps * scale`` (1e-6),
so the two packages' eigendecompositions, equal to ~1e-16, reach the
factor amplified by that conditioning (measured 2.1e-9 on the
indefinite-diagonal case).

A clean ``check=True`` run must return the ``check=False`` factors bit for
bit on all three drivers (left, right, right with lookahead): the checks
only read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.core import CholOptions as JCholOptions
from repro.core import FactorizationBreakdown as JBreakdown
from repro.core import RetryPolicy as JRetryPolicy
from repro.core import column_flags as jax_column_flags
from repro.core import covariance_problem, from_dense
from repro.core import tlr_cholesky as jax_cholesky
from repro_torch import faults
from repro_torch.convert import tlr_from_numpy
from repro_torch.core import (CholOptions, FactorizationBreakdown,
                              HealthMonitor, RetryPolicy, SequentialSchedule,
                              Stage, column_flags, run_graph, tlr_cholesky)

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain QR and Jacobi versions run many small ops a call; beside
    the suite's other workers torch's thread pool oversubscribes the
    cores. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_probes(seed: int = 0):
    """Port probe source drawing exactly the JAX driver's Omega:
    ``normal(fold_in(...fold_in(fold_in(PRNGKey(seed), k), *stream)...,
    it), shape)``; ``it=None`` is the draw straight from the column's key
    (power pivoting's start vectors)."""
    key = jax.random.PRNGKey(seed)

    def probes(k, it, shape, dtype, device, stream=()):
        kk = jax.random.fold_in(key, k)
        for s in stream:
            kk = jax.random.fold_in(kk, s)
        if it is not None:
            kk = jax.random.fold_in(kk, it)
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
        z = np.array(jax.random.normal(kk, shape, jdtype))
        return torch.as_tensor(z, dtype=dtype, device=device)

    return probes


def to_port(A):
    return tlr_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")


@pytest.fixture(scope="module")
def prob3():
    """3-D covariance, nb=4: the generic SPD operand."""
    _, K = covariance_problem(256, 3, 64)
    A = from_dense(jnp.asarray(K), 64, 64, 1e-9)
    return K, A, to_port(A)


@pytest.fixture(scope="module")
def prob1():
    """1-D covariance, b=32: rank-1 off-diagonal tiles, so a spiked tile
    is the only thing near a hard rank cap."""
    _, K = covariance_problem(256, 1, 32)
    A = from_dense(jnp.asarray(K), 32, 32, 1e-10)
    return A, to_port(A)


DRIVERS = [("left", False), ("right", False), ("right", True)]
IDS = ["left", "right", "right-lookahead"]


def _opts(algo, lookahead=False, **kw):
    """The same options for both packages (JAX's probes for the port)."""
    kw = dict(eps=1e-6, bs=8, algo=algo, lookahead=lookahead) | kw
    return JCholOptions(**kw), CholOptions(probes=jax_probes(0), **kw)


def _finite(fact) -> bool:
    return all(bool(np.isfinite(np.asarray(x)).all())
               for x in (fact.L.D, fact.L.U, fact.L.V))


def _events(fact):
    return fact.stats["health"]["events"]


def _same_events(port, jax_events):
    """Kinds, columns, stages, remedies, attempts and rows equal; jitter
    shifts to 1e-6 relative."""
    key = ("kind", "column", "stage", "remedy", "attempt")
    assert [tuple(e[k] for k in key) for e in port] == \
        [tuple(e[k] for k in key) for e in jax_events]
    for p, j in zip(port, jax_events):
        assert p["detail"].get("rows") == j["detail"].get("rows")
        if "shift" in j["detail"]:
            assert p["detail"]["shift"] == pytest.approx(
                j["detail"]["shift"], rel=1e-6)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# -- clean path: checks read, never write --------------------------------------


@pytest.mark.parametrize("algo,lookahead", DRIVERS, ids=IDS)
def test_clean_path_bitwise_parity(prob3, algo, lookahead):
    """check=True on a healthy operand reproduces the unchecked factors
    bitwise, records zero events (as the JAX package does on the same
    operand) and stamps the health summary into stats; check=False carries
    no health machinery."""
    _, A, At = prob3
    jo, _ = _opts(algo, lookahead, check=True)
    off = tlr_cholesky(At, CholOptions(eps=1e-6, bs=8, algo=algo,
                                       lookahead=lookahead))
    on = tlr_cholesky(At, CholOptions(eps=1e-6, bs=8, algo=algo,
                                      lookahead=lookahead, check=True))
    for a, b in ((off.L.D, on.L.D), (off.L.U, on.L.U), (off.L.V, on.L.V),
                 (off.L.ranks, on.L.ranks)):
        assert torch.equal(a, b)
    assert "health" not in off.stats
    h = on.stats["health"]
    assert h["events"] == []
    assert h["columns_checked"] == A.nb
    assert on.stats["schedule"]["checks"] > 0
    jf = jax_cholesky(A, jo)
    assert jf.stats["health"]["events"] == []
    assert jf.stats["health"]["columns_checked"] == h["columns_checked"]
    assert on.stats["schedule"]["checks"] == jf.stats["schedule"]["checks"]
    assert h["policy"] == jf.stats["health"]["policy"]


# -- recovery ladders ----------------------------------------------------------


@pytest.mark.parametrize("algo,lookahead", DRIVERS, ids=IDS)
def test_indefinite_diag_recovers(prob3, algo, lookahead):
    """A genuinely indefinite diagonal tile recovers through the recorded
    SPD ladder with finite factors, through both drivers and the lookahead
    schedule, with the JAX package's events."""
    _, A, At = prob3
    jo, po = _opts(algo, lookahead, check=True)
    fact = tlr_cholesky(faults.make_diag_indefinite(At, 2, magnitude=4.0),
                        po)
    jf = jax_cholesky(jfaults.make_diag_indefinite(A, 2, magnitude=4.0), jo)
    assert _finite(fact)
    spd = [e for e in _events(fact) if e["kind"] == "spd_breakdown"]
    assert spd, "no spd_breakdown event recorded for an indefinite tile"
    assert all(e["remedy"] in ("clamp", "jitter") for e in spd)
    assert any(e["column"] == 2 for e in spd)
    _same_events(_events(fact), _events(jf))
    if algo == "left":
        np.testing.assert_array_equal(fact.L.ranks.numpy(),
                                      np.asarray(jf.L.ranks))
        assert _rel(np.tril(fact.L.to_dense().numpy()),
                    np.tril(np.asarray(jf.L.to_dense()))) <= 1e-8


def test_rank_spike_recovers_left(prob1):
    """A planted rank spike under a hard cap recovers through the
    eps-loosen / densify ladder (left driver), the re-pass drawing the JAX
    driver's stream; the factors stay finite and agree with JAX's."""
    A, At = prob1
    jo, po = _opts("left", r_max_out=16, check=True)
    fact = tlr_cholesky(faults.spike_rank(At, 4, 1, seed=3, scale=1e-4), po)
    jf = jax_cholesky(jfaults.spike_rank(A, 4, 1, seed=3, scale=1e-4), jo)
    assert _finite(fact)
    over = [e for e in _events(fact) if e["kind"] == "rank_overflow"]
    assert over and {"eps_loosen"} <= {e["remedy"] for e in over}
    _same_events(_events(fact), _events(jf))
    np.testing.assert_array_equal(fact.L.ranks.numpy(),
                                  np.asarray(jf.L.ranks))
    assert _rel(np.tril(fact.L.to_dense().numpy()),
                np.tril(np.asarray(jf.L.to_dense()))) <= 1e-8


def test_rank_spike_accepts_right(prob1):
    """The right driver's rounding is already SVD-optimal, so the same
    spike resolves as a recorded 'accept' rather than a re-pass."""
    A, At = prob1
    jo, po = _opts("right", r_max_out=16, check=True)
    fact = tlr_cholesky(faults.spike_rank(At, 4, 1, seed=3, scale=3e-4), po)
    jf = jax_cholesky(jfaults.spike_rank(A, 4, 1, seed=3, scale=3e-4), jo)
    assert _finite(fact)
    over = [e for e in _events(fact) if e["kind"] == "rank_overflow"]
    assert over and all(e["remedy"] == "accept" for e in over)
    _same_events(_events(fact), _events(jf))


def _breakdowns(port_call, jax_call):
    """Both calls raise; returns the two reports."""
    with pytest.raises(FactorizationBreakdown) as pi:
        port_call()
    with pytest.raises(JBreakdown) as ji:
        jax_call()
    p, j = pi.value.report, ji.value.report
    assert (p.column, p.stage, p.reason, p.remedies) == \
        (j.column, j.stage, j.reason, j.remedies)
    assert str(pi.value) == str(ji.value)
    return p, pi.value


@pytest.mark.parametrize("algo", ["left", "right"])
def test_rank_spike_breakdown(prob1, algo):
    """A spike too large for any remedy is a typed breakdown carrying the
    column and the remedies tried -- not a silently degraded factor."""
    A, At = prob1
    jo, po = _opts(algo, r_max_out=16, check=True)
    rep, err = _breakdowns(
        lambda: tlr_cholesky(faults.spike_rank(At, 4, 1, seed=3, scale=1e-3),
                             po),
        lambda: jax_cholesky(jfaults.spike_rank(A, 4, 1, seed=3, scale=1e-3),
                             jo))
    assert rep.reason == "rank_overflow"
    assert rep.column >= 0
    assert "rank_overflow" in str(err)


# -- unrecoverable faults: structured breakdown, never NaN factors -------------


@pytest.mark.parametrize("algo,lookahead", DRIVERS, ids=IDS)
def test_nan_diag_breakdown(prob3, algo, lookahead):
    """A NaN diagonal tile exhausts the jitter ladder (NaN is not fixable
    by shifting) and raises with the remedies it tried."""
    _, A, At = prob3
    jo, po = _opts(algo, lookahead, check=True)

    def port():
        with faults.inject(faults.Fault(site="chol.diag", kind="nan",
                                        column=2)):
            tlr_cholesky(At, po)

    def jax_run():
        with jfaults.inject(jfaults.Fault(site="chol.diag", kind="nan",
                                          column=2)):
            jax_cholesky(A, jo)

    rep, err = _breakdowns(port, jax_run)
    assert rep.column == 2 and rep.reason == "spd_breakdown"
    assert "jitter" in rep.remedies
    assert "column 2" in str(err)


@pytest.mark.parametrize("algo,lookahead", DRIVERS, ids=IDS)
def test_nan_panel_breakdown(prob3, algo, lookahead):
    """A NaN produced mid-panel (healthy pivots) is unrecoverable: the
    check at the stage boundary raises instead of letting the NaN
    propagate through every later column."""
    _, A, At = prob3
    jo, po = _opts(algo, lookahead, check=True)

    def port():
        with faults.inject(faults.Fault(site="chol.panel", kind="nan",
                                        column=1)):
            tlr_cholesky(At, po)

    def jax_run():
        with jfaults.inject(jfaults.Fault(site="chol.panel", kind="nan",
                                          column=1)):
            jax_cholesky(A, jo)

    rep, _ = _breakdowns(port, jax_run)
    assert rep.column == 1 and rep.reason == "nonfinite_panel"


def test_poisoned_input_tile_detected(prob3):
    """A NaN planted in the *operand* poisons the unchecked factorization
    silently; with check=True the same operand is a structured breakdown
    at the first column that touches the tile, as in the JAX package."""
    _, A, At = prob3
    Ap = faults.poison_tile(At, 2, 0)
    assert torch.isfinite(At.U).all()          # the mutator copies
    silent = tlr_cholesky(Ap, CholOptions(eps=1e-6, bs=8))
    assert not _finite(silent)
    jo, po = _opts("left", check=True)
    rep, _ = _breakdowns(lambda: tlr_cholesky(Ap, po),
                         lambda: jax_cholesky(jfaults.poison_tile(A, 2, 0),
                                              jo))
    assert rep.reason == "nonfinite_panel" and rep.column == 0


# -- units: policy, flags, stage hook, fault sites ----------------------------


def test_retry_policy_schedules():
    rp = RetryPolicy(max_retries=2, shift0=1e-8, growth=16.0,
                     eps_growth=4.0)
    jp = JRetryPolicy(max_retries=2, shift0=1e-8, growth=16.0,
                      eps_growth=4.0)
    assert rp.shift(0) == pytest.approx(1e-8)
    assert rp.shift(2) == pytest.approx(1e-8 * 256)
    assert rp.eps_at(1e-6, 1) == pytest.approx(4e-6)
    assert rp.eps_floor(1e-6) == pytest.approx(1.6e-5)
    for a in range(3):
        assert rp.shift(a) == jp.shift(a)
        assert rp.eps_at(1e-6, a) == jp.eps_at(1e-6, a)
    assert rp.eps_floor(1e-6) == jp.eps_floor(1e-6)
    assert CholOptions().retry == RetryPolicy()


def test_column_flags_reductions():
    """The one-reduction scan: non-finite counts, min pivot + argmin, and
    the rank-overflow count, equal to the JAX package's flags."""
    pivots = np.asarray([1.0, -2.0, np.nan, 3.0])
    arr = np.asarray([[1.0, np.inf], [0.0, 2.0]])
    flags = column_flags(torch.from_numpy(pivots), (torch.from_numpy(arr),))
    assert flags[0] == 1          # non-finite array entries
    assert flags[1] == 1          # non-finite pivots
    assert flags[2] == -2.0       # min finite pivot
    assert flags[3] == 1          # its index
    np.testing.assert_array_equal(
        flags, jax_column_flags(jnp.asarray(pivots), (jnp.asarray(arr),)))
    ranks = np.asarray([4, 2, 4], np.int32)
    err = np.asarray([1e-3, 1e-9, 1e-9])
    flags = column_flags(torch.ones(2, dtype=torch.float64),
                         ranks=torch.from_numpy(ranks),
                         err=torch.from_numpy(err), r_cap=4, eps=1e-6)
    assert flags[4] == 1          # only the at-cap, over-eps tile counts
    np.testing.assert_array_equal(flags, jax_column_flags(
        jnp.ones(2), ranks=jnp.asarray(ranks), err=jnp.asarray(err),
        r_cap=4, eps=1e-6))
    allnan = column_flags(torch.full((3,), float("nan"), dtype=torch.float64))
    assert allnan[1] == 3 and allnan[2] == np.inf and allnan[3] == 0


def test_stage_check_hooks_run_and_time():
    """`Stage.check` runs after the stage body, is counted and timed
    separately, and absent hooks cost nothing."""
    ran = []
    stages = [
        Stage(name="diag[0]", kind="diag", k=0,
              fn=lambda: ran.append("fn0"),
              check=lambda: ran.append("chk0"), writes=(("x", 0),), seq=0),
        Stage(name="panel[0]", kind="panel", k=0,
              fn=lambda: ran.append("fn1"),
              reads=(("x", 0),), writes=(("y", 0),), seq=1),
    ]
    sched = run_graph(stages, SequentialSchedule())
    assert ran == ["fn0", "chk0", "fn1"]
    assert sched["checks"] == 1
    assert sched["kind_seconds"]["check"] >= 0.0


def test_monitor_report_and_fault_sites():
    """The monitor's breakdown report lists the column's remedies (not its
    accepts); the fault sites return corrupted copies, fire once and match
    the JAX package's output on the same tile."""
    h = HealthMonitor(RetryPolicy(), "left", 4)
    h.record("spd_breakdown", 1, "diag", remedy="clamp")
    h.record("rank_overflow", 1, "panel", remedy="accept")
    h.record("spd_breakdown", 2, "diag", remedy="jitter", attempt=1)
    with pytest.raises(FactorizationBreakdown) as ei:
        h.fail(1, "panel", "nonfinite_panel", nonfinite=3)
    assert ei.value.report.remedies == ["clamp"]
    assert [e.column for e in ei.value.report.events] == [1, 1, 1]
    assert h.summary()["counters"] == {"spd_breakdown": 2,
                                       "rank_overflow": 1,
                                       "nonfinite_panel": 1}
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 6))
    M = M @ M.T
    tile = torch.from_numpy(M.copy())
    fault = faults.Fault(site="chol.diag", kind="indefinite", column=3)
    jfault = jfaults.Fault(site="chol.diag", kind="indefinite", column=3)
    with faults.inject(fault), jfaults.inject(jfault):
        assert torch.equal(faults.corrupt_diag(tile, 2), tile)
        out = faults.corrupt_diag(tile, 3)
        want = np.asarray(jfaults.corrupt_diag(jnp.asarray(M), 3))
        assert torch.equal(faults.corrupt_diag(tile, 3), tile)   # once
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-14)
    assert torch.equal(tile, torch.from_numpy(M)) and fault.fired == 1
    assert not faults.active()
    Q = torch.zeros((3, 4, 2), dtype=torch.float64)
    with faults.inject(faults.Fault(site="chol.panel", column=0, tile=5)):
        assert torch.equal(faults.corrupt_panel(Q, 0), Q)      # past T
    with faults.inject(faults.Fault(site="chol.panel", column=0, tile=1)):
        P = faults.corrupt_panel(Q, 0)
    assert torch.isnan(P[1, 0, 0]) and not torch.isnan(Q).any()
