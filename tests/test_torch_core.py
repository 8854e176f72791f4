"""Core-layer parity of the PyTorch port against the JAX package: the TLR
layout, bucket helpers, compression, the flat read paths (matvec,
triangular matvec, TRSM) and the covariance generators, on the same inputs.

Deterministic stages are held tightly: integer outputs (ranks, indices)
exactly, floating outputs to 1e-10 or better (both sides run LAPACK/BLAS in
f64 on the CPU; only the summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buckets as jbuckets
from repro.core import generators as jgen
from repro.core import solve as jsolve
from repro.core import tlr as jtlr
from repro.core.operator import TLROperator as JOperator
from repro_torch.convert import tlr_from_numpy
from repro_torch.core import buckets, generators, solve, tlr
from repro_torch.core.operator import TLROperator


def _random_tlr(nb=5, b=16, r=6, seed=0, lower=False):
    """numpy TLR arrays with per-tile ranks and zero tails; ``lower`` makes
    well-conditioned lower-triangular diagonal tiles (a valid factor L)."""
    rng = np.random.default_rng(seed)
    nt = nb * (nb - 1) // 2
    D = rng.standard_normal((nb, b, b))
    if lower:
        D = np.tril(D) + b * np.eye(b)
    else:
        D = D + np.swapaxes(D, 1, 2)
    ranks = rng.integers(0, r + 1, nt).astype(np.int32)
    mask = np.arange(r)[None, None, :] < ranks[:, None, None]
    U = rng.standard_normal((nt, b, r)) * mask * 0.3
    V = rng.standard_normal((nt, b, r)) * mask * 0.3
    return D, U, V, ranks


def test_packed_indexing_matches_jax():
    for nb in (1, 2, 5, 9):
        np.testing.assert_array_equal(tlr.tril_pairs(nb), jtlr.tril_pairs(nb))
        assert tlr.num_tiles(nb) == jtlr.num_tiles(nb)
    for i in range(1, 7):
        for j in range(i):
            assert tlr.tril_index(i, j) == jtlr.tril_index(i, j)
    with pytest.raises(ValueError):
        tlr.tril_index(2, 2)


def test_tlr_to_dense_matches_jax():
    D, U, V, ranks = _random_tlr()
    A = tlr_from_numpy(D, U, V, ranks, device="cpu")
    want = jtlr.tlr_to_dense(jnp.asarray(D), jnp.asarray(U), jnp.asarray(V),
                             5, 16)
    np.testing.assert_allclose(A.to_dense().numpy(), np.asarray(want),
                               rtol=1e-14, atol=1e-14)
    ja = jtlr.TLRMatrix(*(jnp.asarray(a) for a in (D, U, V, ranks)))
    assert A.memory_stats() == ja.memory_stats()


def test_bucket_helpers_match_jax():
    for cap in range(0, 70):
        ladder = buckets._bucket_ladder(cap)
        assert ladder == jbuckets._bucket_ladder(cap)
        for x in range(1, cap + 1):
            assert buckets._bucket_up(x, ladder) == \
                jbuckets._bucket_up(x, ladder)
    for nb in (2, 3, 8, 17, 64):
        ladder = buckets._bucket_ladder(nb - 1)
        for k in range(nb - 1):
            assert buckets._column_buckets(nb, k, ladder) == \
                jbuckets._column_buckets(nb, k, ladder)
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(
        buckets._pad_axis(x, 4, axis=1).numpy(),
        np.asarray(jbuckets._pad_axis(jnp.asarray(x.numpy()), 4, axis=1)))
    assert buckets._pad_axis(x, 2) is x


@pytest.fixture(scope="module")
def cov():
    pts, K = jgen.covariance_problem(512, 2, 64)
    return pts, K


@pytest.mark.parametrize("kernel", ["exp", "matern32"])
def test_torch_covariance_matches_numpy(cov, kernel):
    pts, _ = cov
    fn = {"exp": jgen.exp_covariance, "matern32": jgen.matern32_covariance}
    want = fn[kernel](pts, 0.1)
    got = generators.covariance_matrix(pts, kernel, 0.1, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
    ptsp, Kp = generators.covariance_problem(512, 2, 64, device="cpu")
    np.testing.assert_array_equal(ptsp, pts)


def test_compress_svd_matches_jax(cov):
    _, K = cov
    op = TLROperator.compress(K, 64, r_max=48, eps=1e-8, device="cpu")
    jop = JOperator.compress(jnp.asarray(K), 64, r_max=48, eps=1e-8)
    np.testing.assert_array_equal(op.ranks.numpy(), np.asarray(jop.ranks))
    np.testing.assert_array_equal(op.A.D.numpy(), np.asarray(jop.A.D))
    got = op.A.U @ op.A.V.transpose(1, 2)
    want = np.einsum("tbr,tcr->tbc", np.asarray(jop.A.U), np.asarray(jop.A.V))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    assert op.memory_stats()["max_rank"] == jop.memory_stats()["max_rank"]


def test_compress_zero_tile_has_rank_zero():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((32, 32))
    K = np.zeros((64, 64))
    K[:32, :32] = M @ M.T
    K[32:, 32:] = M.T @ M
    op = TLROperator.compress(K, 32, eps=1e-8, device="cpu")
    assert op.ranks.tolist() == [0]
    assert (op.A.U == 0).all() and (op.A.V == 0).all()


def test_compress_ara_matches_jax(cov):
    """method="ara" with JAX's probes: ranks equal, factors to 1e-10."""
    _, K = cov
    key = jax.random.PRNGKey(0)

    def probes(k, it, shape, dtype, device):
        z = jax.random.normal(jax.random.fold_in(key, it), shape, jnp.float64)
        return torch.as_tensor(np.array(z), dtype=dtype, device=device)

    op = TLROperator.compress(K, 64, r_max=48, eps=1e-6, method="ara", bs=8,
                              probes=probes, device="cpu")
    jop = JOperator.compress(jnp.asarray(K), 64, r_max=48, eps=1e-6,
                             method="ara", bs=8)
    np.testing.assert_array_equal(op.ranks.numpy(), np.asarray(jop.ranks))
    got = op.A.U @ op.A.V.transpose(1, 2)
    want = np.einsum("tbr,tcr->tbc", np.asarray(jop.A.U), np.asarray(jop.A.V))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("nrhs", [None, 4])
def test_matvec_matches_jax(nrhs):
    D, U, V, ranks = _random_tlr(seed=1)
    A = tlr_from_numpy(D, U, V, ranks, device="cpu")
    JA = jtlr.TLRMatrix(*(jnp.asarray(a) for a in (D, U, V, ranks)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((80,) if nrhs is None else (80, nrhs))
    got = TLROperator(A) @ torch.from_numpy(x)
    want = jsolve.tlr_matvec(JA, jnp.asarray(x), batching="flat")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(), A.to_dense().numpy() @ x,
                               rtol=1e-12, atol=1e-12)
    ranked = solve.tlr_matvec(A, torch.from_numpy(x), batching="ranked")
    np.testing.assert_allclose(ranked.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="batching"):
        solve.tlr_matvec(A, torch.from_numpy(x), batching="bucketed")


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("nrhs", [None, 3])
def test_tri_matvec_and_trsv_match_jax(trans, nrhs):
    D, U, V, ranks = _random_tlr(nb=6, seed=2, lower=True)
    L = tlr_from_numpy(D, U, V, ranks, device="cpu")
    JL = jtlr.TLRMatrix(*(jnp.asarray(a) for a in (D, U, V, ranks)))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((96,) if nrhs is None else (96, nrhs))
    xt = torch.from_numpy(x)
    y = solve.tlr_tri_matvec(L, xt, trans=trans)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jsolve.tlr_tri_matvec(
            JL, jnp.asarray(x), trans=trans, batching="flat")),
        rtol=1e-12, atol=1e-12)
    z = solve.tlr_trsv(L, y, trans=trans)
    np.testing.assert_allclose(
        z.numpy(), np.asarray(jsolve.tlr_trsv(
            JL, jnp.asarray(y.numpy()), trans=trans, batching="flat")),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        z.numpy(), solve.tlr_trsv_reference(L, y, trans=trans).numpy(),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-10, atol=1e-10)


def test_single_tile_trsv():
    D, U, V, ranks = _random_tlr(nb=1, lower=True)
    L = tlr_from_numpy(D, U, V, ranks, device="cpu")
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(16))
    for trans in (False, True):
        z = solve.tlr_trsv(L, y, trans=trans)
        Dk = L.D[0].T if trans else L.D[0]
        np.testing.assert_allclose((Dk @ z).numpy(), y.numpy(), atol=1e-12)
