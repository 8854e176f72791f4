"""Mixed-precision TLR storage in the port (the paper's section 7
proposal: off-diagonal factors stored low precision, every read in the
working precision), mirroring tests/test_mixed_precision.py, with parity
against the JAX package:

* ``compress(store_dtype=torch.float32)`` against JAX's
  ``store_dtype=np.float32`` on the same K: equal ranks, f32 factors whose
  tile products agree to f32 rounding;
* the left Cholesky of JAX's f32-stored operator with JAX's probes
  injected: equal ranks and ARA iterations, L within 1e-8 (the kernels
  read the promoted f64 factors, as JAX's sampling promotes);
* the leftovers of the ported slices: ``morton_ordering`` and
  ``rank_heatmap`` equal JAX's exactly, and ``run_ara_host`` gives
  ``run_ara_fused``'s Q and ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CholOptions as JCholOptions
from repro.core import TLROperator as JOperator
from repro.core import covariance_problem as jax_covariance_problem
from repro.core import morton_ordering as jax_morton
from repro.core import rank_heatmap as jax_rank_heatmap
from repro_torch.convert import operator_from_numpy
from repro_torch.core import (ARAParams, CholOptions, TLROperator,
                              covariance_problem, morton_ordering,
                              rank_heatmap, run_ara_fused, tlr_cholesky,
                              tlr_matvec, tlr_to_dense)
from repro_torch.core.ara import (ara_iteration, dense_batch_sampler,
                                  run_ara_host)

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops a call: one intra-op thread beside the suite's
    other workers. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def K():
    _, K = covariance_problem(512, 3, 64, device="cpu")
    return K


def _f32(K, eps=1e-8):
    return TLROperator.compress(K, 64, 64, eps, store_dtype=torch.float32)


# -- tests/test_mixed_precision.py, on the port ----------------------------------


def test_f32_storage_halves_lowrank_memory(K):
    A64 = TLROperator.compress(K, 64, 64, 1e-8).A
    A32 = _f32(K).A
    assert A32.U.dtype == A32.V.dtype == torch.float32
    assert A32.D.dtype == torch.float64
    m64 = A64.memory_stats()
    m32 = A32.memory_stats()
    assert m32["lowrank_bytes_logical"] * 2 == m64["lowrank_bytes_logical"]
    # reconstruction error bounded by f32 resolution of the tiles
    err = torch.linalg.matrix_norm(A32.to_dense() - K, 2)
    assert err < 1e-5


def test_memory_stats_uses_stored_dtype_consistently(K):
    op = TLROperator.compress(K, 64, 64, 1e-8, store_dtype=np.float32)
    A = op.A
    m = op.memory_stats()
    assert m["compute_dtype"] == "float64"
    assert m["store_dtype"] == "float32"
    ranks = A.ranks.numpy()
    assert m["lowrank_bytes_logical"] == 2 * 64 * int(ranks.sum()) * 4
    assert m["lowrank_bytes_padded"] == (A.U.numel() + A.V.numel()) * 4
    assert m["dense_diag_bytes"] == A.D.numel() * 8
    assert m["full_dense_bytes"] == A.n * A.n * 8
    assert m["dense_equivalent_gb"] == pytest.approx(
        m["full_dense_bytes"] / 2**30)
    assert m["total_bytes_logical"] == (m["dense_diag_bytes"]
                                        + m["lowrank_bytes_logical"])
    assert m["total_bytes_padded"] == (m["dense_diag_bytes"]
                                       + m["lowrank_bytes_padded"])


def test_mixed_precision_solve_through_handle(K):
    op = _f32(K)
    fact = op.cholesky(CholOptions(eps=1e-5, bs=8))
    assert fact.L.U.dtype == torch.float64
    rng = np.random.default_rng(1)
    X_true = rng.standard_normal((op.n, 2))
    X = fact.solve(K @ torch.as_tensor(X_true)).numpy()
    assert np.linalg.norm(X - X_true) / np.linalg.norm(X_true) < 1e-2


def test_factorization_with_f32_stored_tiles(K):
    """Factor a mixed-precision TLR matrix at eps=1e-5: accuracy holds
    (the reads promote to f64; storage error ~1e-7 stays below eps)."""
    A32 = _f32(K).A
    fact = tlr_cholesky(A32, CholOptions(eps=1e-5, bs=8))
    Ld = torch.tril(tlr_to_dense(fact.L.D, fact.L.U, fact.L.V, A32.nb,
                                 A32.b))
    err = torch.linalg.matrix_norm(K - Ld @ Ld.T, 2)
    assert err < 1e-3, err
    rng = np.random.default_rng(0)
    x_true = torch.as_tensor(rng.standard_normal(A32.n))
    x = fact.solve(K @ x_true)
    assert float((x - x_true).norm() / x_true.norm()) < 1e-2


def test_matvec_mixed_precision(K):
    A32 = _f32(K, 1e-10).A
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(A32.n))
    for batching in ("flat", "ranked"):
        y = tlr_matvec(A32, x, batching=batching)
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), (K @ x).numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("algo", ["left", "right"])
def test_both_drivers_factor_in_the_working_precision(algo):
    """The right driver's accumulators are f64 too (an f32 accumulator
    would lose the factor's precision silently). At n = 256, where the
    plain rounding kernels of the right driver take a second on the CPU."""
    _, K = covariance_problem(256, 3, 64, device="cpu")
    op = _f32(K)
    fact = op.cholesky(CholOptions(eps=1e-5, bs=8, algo=algo))
    assert fact.L.D.dtype == fact.L.U.dtype == torch.float64
    Ld = torch.tril(fact.L.to_dense())
    assert torch.linalg.matrix_norm(K - Ld @ Ld.T, 2) < 1e-3


def test_round_keeps_the_storage_precision(K):
    """``op.round`` rounds and stores in the factors' precision, as the
    JAX package does; the rounded operator still reads in f64."""
    op = _f32(K)
    r = op.round(1e-6)
    assert r.A.U.dtype == r.A.V.dtype == torch.float32
    assert r.A.D.dtype == torch.float64
    assert (r.ranks <= op.ranks).all()
    x = torch.ones(op.n, dtype=torch.float64)
    assert float((r @ x - K @ x).norm() / (K @ x).norm()) < 1e-5


# -- against the JAX package -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_f32():
    _, Kn = jax_covariance_problem(256, 3, 64)
    jop = JOperator.compress(jnp.asarray(Kn), 64, 64, 1e-8,
                             store_dtype=np.float32)
    return np.asarray(Kn), jop


def test_compress_store_dtype_matches_jax(jax_f32):
    Kn, jop = jax_f32
    op = TLROperator.compress(torch.as_tensor(Kn), 64, 64, 1e-8,
                              store_dtype=torch.float32)
    assert jop.A.U.dtype == np.float32
    np.testing.assert_array_equal(op.ranks.numpy(), np.asarray(jop.ranks))
    np.testing.assert_array_equal(op.A.D.numpy(), np.asarray(jop.A.D))
    got = (op.A.U.double() @ op.A.V.double().transpose(1, 2)).numpy()
    Uj = np.asarray(jop.A.U, np.float64)
    Vj = np.asarray(jop.A.V, np.float64)
    want = np.einsum("tbr,tcr->tbc", Uj, Vj)
    # each factor entry is rounded to f32 on both sides (2^-24 relative)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    assert op.memory_stats() == jop.memory_stats()


def jax_probes(seed: int = 0):
    key = jax.random.PRNGKey(seed)

    def probes(k, it, shape, dtype, device):
        kk = jax.random.fold_in(jax.random.fold_in(key, k), it)
        z = np.array(jax.random.normal(kk, shape, jnp.float64))
        return torch.as_tensor(z, dtype=dtype, device=device)

    return probes


def test_mixed_cholesky_matches_jax_with_injected_probes(jax_f32):
    """JAX's f32-stored tiles, carried across as they are: the port's left
    Cholesky promotes them where JAX's sampling does."""
    _, jop = jax_f32
    A = jop.A
    op = operator_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")
    assert op.A.U.dtype == torch.float32
    kw = dict(eps=1e-5, bs=8)
    jf = jop.cholesky(JCholOptions(**kw))
    pf = op.cholesky(CholOptions(probes=jax_probes(0), **kw))
    np.testing.assert_array_equal(pf.L.ranks.numpy(), np.asarray(jf.L.ranks))
    assert pf.stats["column_iters"] == jf.stats["column_iters"]
    Lj = np.tril(np.asarray(jf.L.to_dense()))
    Lp = np.tril(pf.L.to_dense().numpy())
    assert np.linalg.norm(Lp - Lj) / np.linalg.norm(Lj) <= 1e-8


def test_morton_ordering_matches_jax():
    rng = np.random.default_rng(7)
    for d in (1, 2, 3):
        pts = rng.standard_normal((300, d))
        pts[5] = pts[6]                       # a tie keeps its order
        np.testing.assert_array_equal(morton_ordering(pts),
                                      jax_morton(pts))
        np.testing.assert_array_equal(morton_ordering(pts, bits=8),
                                      jax_morton(pts, bits=8))


def test_rank_heatmap_matches_jax(jax_f32):
    _, jop = jax_f32
    A = jop.A
    op = operator_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")
    H = rank_heatmap(op.A)
    Hj = jax_rank_heatmap(A)
    assert H.dtype == Hj.dtype
    np.testing.assert_array_equal(H, Hj)
    one = operator_from_numpy(A.D[:1], A.U[:0], A.V[:0], A.ranks[:0],
                              device="cpu")
    np.testing.assert_array_equal(rank_heatmap(one.A), [[64]])


@pytest.mark.parametrize("share_omega", [True, False])
def test_run_ara_host_matches_fused(share_omega):
    """One iteration per ``step_fn`` call, convergence read on the host,
    then the projection: the fused loop's Q, B and ranks."""
    rng = np.random.default_rng(3)
    T, b, m = 6, 48, 48
    G = rng.standard_normal((T, b, 12)) * np.logspace(0, -9, 12)
    A = torch.as_tensor(G @ rng.standard_normal((T, 12, m)))
    sample, sample_t, data = dense_batch_sampler(A)
    p = ARAParams(bs=4, r_max=24, eps=1e-6)
    gen = torch.Generator().manual_seed(0)
    probes = [torch.randn((T, b, 4), generator=gen, dtype=A.dtype)
              for _ in range(p.iters)]

    def draw(it, shape, dtype, device):
        return probes[it][0] if len(shape) == 2 else probes[it]

    step = functools.partial(ara_iteration, sample, p=p,
                             share_omega=share_omega, T=T, b=b)
    calls = []

    def step_fn(data, state, draw):
        calls.append(state.it)
        return step(data, state, draw)

    Qh, Bh, rh, sh = run_ara_host(step_fn, sample, sample_t, data, draw,
                                  T=T, b=b, p=p, dtype=A.dtype,
                                  device=A.device, share_omega=share_omega)
    Qf, Bf, rf, sf = run_ara_fused(sample, sample_t, data, draw, T=T, b=b,
                                   p=p, dtype=A.dtype, device=A.device,
                                   share_omega=share_omega)
    assert torch.equal(rh, rf) and torch.equal(Qh, Qf) and torch.equal(Bh, Bf)
    assert calls == list(range(sf.it)) and sh.it == sf.it
    assert bool(sh.converged.all()) and sf.it < p.iters
