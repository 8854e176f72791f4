"""Factorization parity of the PyTorch port against the JAX package: the
left-looking ARA Cholesky (fused and dynamic modes) and LDL^T on the
``_cov_tlr`` problem of tests/test_factorization.py (n=384, b=64, compress
eps 1e-7, factor eps 1e-6, bs=8), both with ``batching="flat"``.

With JAX's own probes injected (``CholOptions.probes``, drawn in the
operator's dtype as the JAX driver draws them) both packages run the same
randomized algorithm on the same Omega: ranks and ARA iterations must agree
exactly and the dense lower factors to ``||L_port - L_jax||_F / ||L_jax||_F
<= 1e-8`` (1e-4 for the f32 case), over the driver's options: fused and
dynamic modes, bucketed refills, per-tile Omega, the three Schur
compensations, LDL^T, a capped output rank and plain Cholesky without the
modified fallback. The two sides differ only in floating-point summation order
(LAPACK and BLAS called in different groupings), which the triangular
solves amplify by at most ``cond(L(k,k))``; the measured difference is
~1e-14, so 1e-8 leaves room without hiding an algorithmic change (a single
rank decision flipped would move L by ~eps = 1e-6).

With torch's own probes the port is held to the eps contract of
tests/test_factorization.py: ``||A - L L^T||_2 < 1e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (CholOptions as JCholOptions, covariance_problem,
                        from_dense, tlr_cholesky as jax_cholesky,
                        tlr_ldlt as jax_ldlt)
from repro_torch.convert import tlr_from_numpy
from repro_torch.core.cholesky import (CholOptions, dense_ldlt_tile,
                                       robust_cholesky, tlr_cholesky,
                                       tlr_ldlt)

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def jax_probes(seed: int = 0):
    """Port probe source drawing exactly the JAX driver's Omega:
    ``normal(fold_in(fold_in(PRNGKey(seed), k), it), shape)``."""
    key = jax.random.PRNGKey(seed)

    def probes(k, it, shape, dtype, device):
        kk = jax.random.fold_in(jax.random.fold_in(key, k), it)
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
        z = np.array(jax.random.normal(kk, shape, jdtype))
        return torch.as_tensor(z, dtype=dtype, device=device)

    return probes


@pytest.fixture(scope="module")
def problem():
    _, K = covariance_problem(384, 3, 64)
    A = from_dense(jnp.asarray(K), 64, 64, 1e-7)
    At = tlr_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")
    return K, A, At


def _lower_dense(L):
    return np.tril(np.asarray(L.to_dense()))


def _factor_error(K, fact):
    Ld = np.tril(fact.L.to_dense().numpy())
    if fact.d is not None:
        R = Ld @ np.diag(fact.d.reshape(-1).numpy()) @ Ld.T
    else:
        R = Ld @ Ld.T
    return np.linalg.norm(K - R, 2)


@pytest.mark.parametrize("case", [
    dict(mode="fused"),
    dict(mode="dynamic"),
    dict(mode="dynamic", bucket=3),        # Algorithm 5 eviction + refill
    dict(mode="dynamic", ldl=True),
    dict(mode="dynamic", share_omega=False),
    dict(mode="dynamic", schur="full"),
    dict(mode="dynamic", schur=None),
    dict(mode="fused", ldl=True),
    dict(mode="dynamic", r_max_out=32),
    dict(mode="dynamic", modified_chol=False),
    # f32 operator and probes at eps 1e-3: L agrees to 1.7e-5 (f32 rounding
    # in different summation orders, amplified by the triangular solves),
    # so it is held to 1e-4 instead of 1e-8
    dict(mode="dynamic", f32=True, eps=1e-3),
])
def test_factor_matches_jax_with_injected_probes(problem, case):
    K, A, At = problem
    case = dict(case)
    ldl = case.pop("ldl", False)
    tol = 1e-8
    if case.pop("f32", False):
        A = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x,
            A)
        At = tlr_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")
        assert At.D.dtype == torch.float32
        tol = 1e-4
    kw = dict(eps=1e-6, bs=8, batching="flat") | case
    jf = (jax_ldlt if ldl else jax_cholesky)(A, JCholOptions(**kw))
    pf = (tlr_ldlt if ldl else tlr_cholesky)(
        At, CholOptions(probes=jax_probes(0), **kw))
    np.testing.assert_array_equal(pf.L.ranks.numpy(), np.asarray(jf.L.ranks))
    assert pf.stats["column_iters"] == jf.stats["column_iters"]
    Lj, Lp = _lower_dense(jf.L), np.tril(pf.L.to_dense().numpy())
    assert np.linalg.norm(Lp - Lj) / np.linalg.norm(Lj) <= tol
    if ldl:
        dj, dp = np.asarray(jf.d), pf.d.numpy()
        assert np.linalg.norm(dp - dj) / np.linalg.norm(dj) <= tol
    assert pf.stats["schedule"]["order"] == jf.stats["schedule"]["order"]
    assert pf.stats["modified_chol"] == jf.stats["modified_chol"] == 0


@pytest.mark.parametrize("case", [
    dict(mode="fused"),
    dict(mode="dynamic"),
    dict(mode="dynamic", share_omega=False),
    dict(mode="dynamic", ldl=True),
])
def test_eps_contract_with_torch_probes(problem, case):
    K, _, At = problem
    case = dict(case)
    ldl = case.pop("ldl", False)
    fact = (tlr_ldlt if ldl else tlr_cholesky)(
        At, CholOptions(eps=1e-6, bs=8, seed=3, **case))
    assert _factor_error(K, fact) < 1e-4
    assert fact.stats["modified_chol"] == 0 and not fact.stats["safety_valve"]
    assert fact.stats["impl"] == "plain"


def test_unported_options_raise(problem):
    """Every CholOptions knob of the JAX package runs in the port; only the
    combinations the JAX package rejects raise, with the same ValueError:
    pivoting with algo="right" or with LDL^T, a bad algo or batching. A bad
    mode raises too (the JAX driver runs any mode but "fused" as
    "dynamic")."""
    _, A, At = problem
    bad = (dict(algo="right", pivot="frobenius"), dict(algo="up"),
           dict(batching="bucketed"))
    for kw in bad:
        with pytest.raises(ValueError):
            jax_cholesky(A, JCholOptions(**kw))
        with pytest.raises(ValueError):
            tlr_cholesky(At, CholOptions(**kw))
    with pytest.raises(ValueError, match="mode"):
        tlr_cholesky(At, CholOptions(mode="static"))
    for kw in (dict(pivot="power"), dict(pivot="frobenius")):
        with pytest.raises(ValueError, match="LDL"):
            jax_ldlt(A, JCholOptions(**kw))
        with pytest.raises(ValueError, match="LDL"):
            tlr_ldlt(At, CholOptions(**kw))
    # "auto" (the default) and "ranked" are ported and run
    assert CholOptions().batching == "auto"
    fact = tlr_cholesky(At, CholOptions(eps=1e-6, bs=8, batching="ranked"))
    assert fact.stats["batching"] == "ranked"
    assert fact.stats["policy"]["requested"] == "ranked"


def test_modified_cholesky_fallback():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    w = np.linspace(1.0, -1e-8, 32)
    Aind = torch.from_numpy((Q * w) @ Q.T)
    L, bad = robust_cholesky(Aind, delta=1e-6)
    assert bad and torch.isfinite(L).all()
    assert torch.linalg.matrix_norm(L @ L.T - Aind, 2) < 1e-4


def test_dense_ldlt_tile():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((48, 48))
    Aind = torch.from_numpy(M + M.T)
    L, d = dense_ldlt_tile(Aind)
    np.testing.assert_allclose((L @ torch.diag(d) @ L.T).numpy(),
                               Aind.numpy(), rtol=1e-6, atol=1e-8)
    assert (d < 0).any()
