"""The port's right-looking TLR Cholesky / LDL^T (sequential schedule),
mirroring tests/test_rightlook.py, plus parity with the JAX package's
right-looking driver on the same tiles (flat batching here; the ranked
driver is held to JAX's in tests/test_torch_batching.py).

The port runs its plain kernel versions here (``device="cpu"``): MGS2 QR
and row-cyclic Jacobi SVD in the rounding passes, where the JAX package's
default ``impl="ref"`` on the CPU runs Householder QR and LAPACK's SVD. The
two agree on every rank and to rounding on the factor (see
``test_right_matches_jax``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CholOptions as JCholOptions
from repro.core import TLROperator as JOperator
from repro.core import covariance_problem
from repro_torch.convert import operator_from_numpy
from repro_torch.core.cholesky import CholOptions

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain QR and Jacobi versions run thousands of small ops a call.
    Beside the suite's other workers, torch's intra-op thread pool then
    oversubscribes the cores and slows this module several-fold; one
    thread is also faster when the module runs alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cov_op(n, b, d=3, eps=1e-9, shift=0.0):
    """Dense K, the JAX operator, and the port's operator on the JAX
    operator's exact tiles."""
    _, K = covariance_problem(n, d, b)
    K = np.asarray(K) + shift * np.eye(n)
    jop = JOperator.compress(jnp.asarray(K), b, b, eps)
    A = jop.A
    return K, jop, operator_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")


def _factor_error(K, fact):
    """||K - L (D) L^T||_2 via the dense lower factor (perm = identity)."""
    Ld = np.tril(fact.L.to_dense().numpy())
    if fact.d is not None:
        R = Ld @ np.diag(fact.d.reshape(-1).numpy()) @ Ld.T
    else:
        R = Ld @ Ld.T
    return np.linalg.norm(K - R, 2)


@pytest.mark.parametrize("nb", [2, 4, 8])
def test_right_cholesky_matches_dense(nb):
    b = 32
    K, _, op = _cov_op(nb * b, b)
    fact = op.cholesky(CholOptions(eps=1e-6, algo="right"))
    assert fact.stats["algo"] == "right" and fact.stats["impl"] == "plain"
    err = _factor_error(K, fact)
    assert err < 1e-4, f"nb={nb}: ||A - LL^T|| = {err}"
    assert fact.stats["modified_chol"] == 0


@pytest.mark.parametrize("flush", [1, 2, 4])
def test_right_flush_period_is_numerics_neutral(flush):
    K, _, op = _cov_op(256, 32)
    fact = op.cholesky(CholOptions(eps=1e-6, algo="right", right_flush=flush))
    assert _factor_error(K, fact) < 1e-4
    st = fact.stats
    assert st["acc_width"] == 32 + flush * 32
    assert st["policy"]["right_flush"] == flush
    # 8 columns: the first append lands at column 32 (A's width), the flush
    # comes when the next one would not fit
    assert st["flushes"] == {1: 6, 2: 3, 4: 1}[flush]


def test_right_ldlt_matches_dense_spd():
    K, _, op = _cov_op(256, 32)
    fact = op.ldlt(CholOptions(eps=1e-6, algo="right"))
    assert _factor_error(K, fact) < 1e-4
    assert (fact.d.numpy() > 0).all()


def test_right_ldlt_indefinite_and_solve():
    """LDL^T factors a mildly indefinite matrix; the handle solves with it."""
    n, b = 256, 32
    K, _, op = _cov_op(n, b, shift=-0.5)
    fact = op.ldlt(CholOptions(eps=1e-7, algo="right"))
    assert _factor_error(K, fact) < 1e-4
    assert (fact.d.numpy() < 0).any()
    x_true = np.random.default_rng(0).standard_normal(n)
    x = fact.solve(torch.from_numpy(K @ x_true)).numpy()
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-2


def test_left_right_agree():
    """Same matrix, same eps: both drivers meet the eps-scaled accuracy and
    their factorizations solve and take logdets alike (n = 256, b = 32; the
    JAX test uses n = 512, b = 64 under its slow marker)."""
    K, _, op = _cov_op(256, 32)
    fl = op.cholesky(CholOptions(eps=1e-6, bs=8, algo="left"))
    fr = op.cholesky(CholOptions(eps=1e-6, algo="right"))
    el, er = _factor_error(K, fl), _factor_error(K, fr)
    assert el < 1e-4 and er < 1e-4
    assert er < 100 * max(el, 1e-7)
    x_true = np.random.default_rng(1).standard_normal(op.n)
    y = torch.from_numpy(K @ x_true)
    nrm = np.linalg.norm(x_true)
    for fact in (fl, fr):
        assert np.linalg.norm(fact.solve(y).numpy() - x_true) / nrm < 1e-3
        _, ld_ref = np.linalg.slogdet(K)
        assert abs(float(fact.logdet()) - ld_ref) / abs(ld_ref) < 1e-3


def test_right_stats_schema_matches_left():
    _, _, op = _cov_op(128, 32)
    fl = op.cholesky(CholOptions(eps=1e-6, bs=8, algo="left"))
    fr = op.cholesky(CholOptions(eps=1e-6, algo="right"))
    assert set(fl.stats) <= set(fr.stats)
    for key in ("algo", "flushes", "acc_width", "column_iters",
                "column_ranks", "column_events", "modified_chol",
                "safety_valve", "schedule", "policy"):
        assert key in fr.stats
    assert fr.stats["policy"]["batching"] == "flat"
    for ev in fr.stats["column_events"]:
        assert ev["err"].shape == (ev["T"],) and np.isfinite(ev["err"]).all()
    assert fr.stats["column_iters"] == [1] * 3


def test_right_rejects_unported_and_invalid_options():
    """Only what the JAX package rejects raises: pivoting, a bad batching
    or algo. Lookahead and check=True run (tests/test_torch_stages.py and
    tests/test_torch_health.py hold them to the JAX package)."""
    _, _, op = _cov_op(128, 32)
    with pytest.raises(ValueError, match="pivot"):
        op.cholesky(CholOptions(algo="right", pivot="frobenius"))
    fl = op.cholesky(CholOptions(algo="right", lookahead=True))
    assert fl.stats["schedule"]["name"] == "lookahead"
    fc = op.cholesky(CholOptions(algo="right", check=True))
    assert fc.stats["health"]["events"] == []
    with pytest.raises(ValueError, match="batching"):
        op.cholesky(CholOptions(algo="right", batching="bucketed"))
    fr = op.cholesky(CholOptions(algo="right", batching="ranked"))
    assert fr.stats["batching"] == "ranked"
    for call in (op.cholesky, op.ldlt):
        with pytest.raises(ValueError, match="algo"):
            call(CholOptions(algo="up"))


@pytest.mark.parametrize("ldl", [False, True])
def test_right_matches_jax(ldl):
    """The port's ``algo="right"`` against the JAX package's
    ``algo="right", batching="flat"`` (default ``impl="ref"``) on the same
    tiles, n = 256, b = 32: ranks per column equal, the dense lower factors
    within 1e-8 relative (measured ~2e-10 on the CPU: MGS2 and Jacobi
    against Householder and LAPACK differ by rounding plus MGS2's 1e-8
    relative drop of dead directions, far below the eps = 1e-6 cut), solves
    within 1e-8 relative, and the same flush count and stage order."""
    _, jop, op = _cov_op(256, 32)
    kw = dict(eps=1e-6, algo="right", batching="flat")
    jf = (jop.ldlt if ldl else jop.cholesky)(JCholOptions(**kw))
    pf = (op.ldlt if ldl else op.cholesky)(CholOptions(**kw))
    assert len(pf.stats["column_ranks"]) == len(jf.stats["column_ranks"])
    for rp, rj in zip(pf.stats["column_ranks"], jf.stats["column_ranks"]):
        np.testing.assert_array_equal(rp, np.asarray(rj))
    np.testing.assert_array_equal(pf.L.ranks.numpy(), np.asarray(jf.L.ranks))
    Lj = np.tril(np.asarray(jf.L.to_dense()))
    Lp = np.tril(pf.L.to_dense().numpy())
    assert np.linalg.norm(Lp - Lj) / np.linalg.norm(Lj) <= 1e-8
    if ldl:
        dj, dp = np.asarray(jf.d), pf.d.numpy()
        assert np.linalg.norm(dp - dj) / np.linalg.norm(dj) <= 1e-8
    y = np.random.default_rng(2).standard_normal((256, 2))
    xj = np.asarray(jf.solve(jnp.asarray(y)))
    xp = pf.solve(torch.from_numpy(y)).numpy()
    assert np.linalg.norm(xp - xj) / np.linalg.norm(xj) <= 1e-8
    for key in ("flushes", "acc_width", "column_traces"):
        assert pf.stats[key] == jf.stats[key]
    assert pf.stats["schedule"]["order"] == jf.stats["schedule"]["order"]
    assert [e["Tb"] for e in pf.stats["column_events"]] == \
        [e["Tb"] for e in jf.stats["column_events"]]
