"""Parity of the port's tile algebra and Newton-Schulz preconditioner
(``repro_torch/core/algebra.py``, ``core/precond.py``) against the JAX
package, on the same compressed operators (JAX's ``TLROperator.compress``
arrays carried across with ``operator_from_numpy``). Mirrors
tests/test_algebra.py without its compile-count tests.

Tolerances:

* exact ops (scale, unrounded axpy, transpose, add_diag, generalize,
  unrounded symmetrize, the general-grid matvec): within 1e-13;
* ``tlr_gemm`` / ``tlr_syrk`` / rounded axpy and symmetrize: equal ranks,
  dense within 1e-10 relative in Frobenius (the JAX package rounds with
  LAPACK's QR and SVD, the port with the plain MGS2 and Jacobi versions of
  its kernels: equal to rounding, and no singular value sits within that
  of a cut here);
* a forced small chunk budget against one chunk: within 1e-13;
* the Newton-Schulz ``alpha``: within 1e-12; X after 4 iterations within
  1e-8 relative, with ``iters`` and ``eps_history`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TLROperator as JOperator
from repro.core import algebra as jalg
from repro.core import exp_covariance, kd_tree_ordering
from repro.core import tlr_newton_schulz as jax_newton_schulz
from repro.core import CholOptions as JCholOptions
from repro_torch.convert import (operator_from_numpy, tiles_from_numpy,
                                 tlr_from_numpy)
from repro_torch.core import algebra
from repro_torch.core import (TLROperator, TLRTiles, generalize, num_tiles,
                              offd_index, offd_pairs, symmetrize,
                              tlr_add_diag, tlr_axpy, tlr_gemm,
                              tlr_newton_schulz, tlr_round, tlr_scale,
                              tlr_syrk, tlr_transpose)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain QR and Jacobi versions run many small ops a call; beside
    the suite's other workers, torch's intra-op thread pool would
    oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spd_operator(seed, nb, b, eps=1e-10, kind="random"):
    """tests/test_algebra.py's operators: (JAX operator, port operator)."""
    rng = np.random.default_rng(seed)
    n = nb * b
    if kind == "random":
        M = rng.standard_normal((n, n)) / np.sqrt(n)
        A = M @ M.T + np.eye(n)
    else:
        pts = rng.random((n, 3))
        A = exp_covariance(pts[kd_tree_ordering(pts, b)], 0.3)
    jop = JOperator.compress(jnp.asarray(A), b, b, eps)
    top = operator_from_numpy(jop.A.D, jop.A.U, jop.A.V, jop.A.ranks,
                              device="cpu")
    return jop, top


def _dense(X):
    d = X.to_dense()
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def _exact(got, want):
    np.testing.assert_allclose(_dense(got), _dense(want), rtol=1e-13,
                               atol=1e-13)


def _rounded(got, want, tol=1e-10):
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(want.ranks))
    w = _dense(want)
    assert np.linalg.norm(_dense(got) - w) / np.linalg.norm(w) <= tol


def _jax_tiles(G):
    """A port ``TLRTiles`` as the JAX package's."""
    return jalg.TLRTiles(*(jnp.asarray(x.numpy())
                           for x in (G.D, G.U, G.V, G.ranks)))


# -- structured ops -----------------------------------------------------------


def test_axpy_exact_concat_and_round():
    (jA, tA), (jB, tB) = _spd_operator(0, 4, 32), _spd_operator(1, 4, 32)
    S = tlr_axpy(2.0, tA.A, tB.A)
    Sj = jalg.tlr_axpy(2.0, jA.A, jB.A)
    assert S.r_max == tA.r_max + tB.r_max
    np.testing.assert_array_equal(S.ranks.numpy(), np.asarray(Sj.ranks))
    _exact(S, Sj)
    want = 2 * _dense(tA) + _dense(tB)
    np.testing.assert_allclose(_dense(S), want, rtol=1e-13, atol=1e-13)
    Sr = tlr_axpy(2.0, tA.A, tB.A, eps=1e-8)
    assert Sr.r_max == min(S.r_max, tA.b)
    _rounded(Sr, jalg.tlr_axpy(2.0, jA.A, jB.A, eps=1e-8))
    # ranked rounding of the concatenation: buckets from A.r_max + B.ranks
    Srr = tlr_axpy(2.0, tA.A, tB.A, eps=1e-8, batching="ranked")
    _rounded(Srr, jalg.tlr_axpy(2.0, jA.A, jB.A, eps=1e-8,
                                batching="ranked"))


def test_axpy_rejects_mismatched_structures():
    (_, tA), (_, tB) = _spd_operator(0, 4, 32), _spd_operator(1, 2, 32)
    with pytest.raises(ValueError, match="matching structures"):
        tlr_axpy(1.0, tA.A, tB.A)
    with pytest.raises(ValueError, match="matching structures"):
        tlr_axpy(1.0, tA.A, generalize(tA.A))


def test_scale_and_add_diag():
    jop, top = _spd_operator(2, 3, 32)
    _exact(tlr_scale(-0.5, top.A), jalg.tlr_scale(-0.5, jop.A))
    _exact(tlr_add_diag(top.A, 3.0), jalg.tlr_add_diag(jop.A, 3.0))
    tiles = np.random.default_rng(0).standard_normal(tuple(top.A.D.shape))
    np.testing.assert_array_equal(
        tlr_add_diag(top.A, torch.as_tensor(tiles)).D.numpy(),
        np.asarray(jalg.tlr_add_diag(jop.A, jnp.asarray(tiles)).D))
    with pytest.raises(ValueError, match="scalar or shape"):
        tlr_add_diag(top.A, torch.ones((2, 2), dtype=torch.float64))


def test_round_error_bound_and_rank_monotonicity():
    """Against the JAX package's Pallas kernel bodies (interpret mode): at
    1e-10 the MGS2 QR's drop tolerance (1e-8 of the largest column, in
    both packages' kernels) cuts singular values that LAPACK's Householder
    QR, the JAX default on the CPU, keeps."""
    jop, top = _spd_operator(3, 4, 32, kind="cov")
    Ad = _dense(top)
    prev = None
    for eps in (1e-10, 1e-6, 1e-3):
        R = tlr_round(top.A, eps)
        _rounded(R, jalg.tlr_round(jop.A, eps, impl="interpret"))
        err = np.linalg.norm(_dense(R) - Ad)
        if eps >= 1e-6:   # at 1e-10 the QR's drop tolerance binds first
            assert err <= 10 * np.sqrt(num_tiles(top.nb) * top.b) * eps
        ranks = R.ranks.numpy()
        assert (ranks <= top.A.ranks.numpy()).all()
        if prev is not None:
            assert (ranks <= prev).all()
        prev = ranks


def test_round_wide_concat_densifies():
    """r_max past b takes the densify branch, on a TLRMatrix and on the
    general grid (``tlr_round`` takes a ``TLRTiles`` too)."""
    jop, top = _spd_operator(4, 3, 16)
    S = tlr_axpy(1.0, top.A, tlr_axpy(1.0, top.A, top.A))
    Sj = jalg.tlr_axpy(1.0, jop.A, jalg.tlr_axpy(1.0, jop.A, jop.A))
    assert S.r_max > top.b
    R = tlr_round(S, 1e-9)
    assert R.r_max == top.b
    _rounded(R, jalg.tlr_round(Sj, 1e-9))
    G = generalize(S)
    RG = G.round(1e-9)
    assert isinstance(RG, TLRTiles) and RG.r_max == top.b
    _rounded(RG, jalg.tlr_round(jalg.generalize(Sj), 1e-9))


def test_transpose_and_generalize_symmetrize():
    jop, top = _spd_operator(5, 4, 32)
    G, Gj = generalize(top.A), jalg.generalize(jop.A)
    _exact(G, Gj)
    np.testing.assert_array_equal(G.ranks.numpy(), np.asarray(Gj.ranks))
    # a nonsymmetric grid: G + 0.5 G G (unrounded structure from tlr_gemm)
    P = tlr_axpy(0.5, tlr_gemm(G, G, 1e-10), G)
    Pj = jalg.tlr_axpy(0.5, jalg.tlr_gemm(Gj, Gj, 1e-10), Gj)
    Pt = tlr_transpose(P)
    _exact(Pt, jalg.tlr_transpose(Pj))
    np.testing.assert_allclose(_dense(Pt), _dense(P).T, rtol=0, atol=1e-13)
    assert tlr_transpose(top.A) is top.A
    Sy, Syj = symmetrize(P), jalg.symmetrize(Pj)
    _exact(Sy, Syj)
    np.testing.assert_array_equal(Sy.ranks.numpy(), np.asarray(Syj.ranks))
    _rounded(P.symmetrize(1e-10), jalg.symmetrize(Pj, eps=1e-10))
    _rounded(symmetrize(P, 1e-10, batching="ranked"),
             jalg.symmetrize(Pj, eps=1e-10, batching="ranked"))
    # the general-grid matvec, one and four right-hand sides
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal(top.n), rng.standard_normal((top.n, 4))):
        np.testing.assert_allclose((P @ torch.as_tensor(x)).numpy(),
                                   np.asarray(Pj @ jnp.asarray(x)),
                                   rtol=1e-13, atol=1e-13)


def test_offd_indexing_matches_jax():
    for nb in (1, 2, 3, 5, 8):
        np.testing.assert_array_equal(offd_pairs(nb), jalg.offd_pairs(nb))
        assert {offd_index(int(i), int(j), nb) for i, j in offd_pairs(nb)} \
            == set(range(nb * (nb - 1)))
    for nb in (1, 2, 3, 6):
        for got, want in zip(algebra._gemm_indices(nb),
                             jalg._gemm_indices(nb)[:2]
                             + jalg._gemm_indices(nb)[3:]):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        offd_index(1, 1, 4)


# -- GEMM / SYRK --------------------------------------------------------------


@pytest.mark.parametrize("batching", ["flat", "ranked"])
def test_gemm_matches_jax(batching):
    (jA, tA), (jB, tB) = (_spd_operator(6, 4, 32, kind="cov"),
                          _spd_operator(7, 4, 32))
    C = tlr_gemm(tA.A, tB.A, 1e-10, batching=batching)
    assert isinstance(C, TLRTiles)
    _rounded(C, jalg.tlr_gemm(jA.A, jB.A, 1e-10, batching=batching))
    want = _dense(tA) @ _dense(tB)
    assert np.linalg.norm(_dense(C) - want) / np.linalg.norm(want) < 1e-8
    # a TLRTiles operand and a TLROperator operand, r_max_out capped
    C2 = tlr_gemm(C, tA, 1e-8, r_max_out=16, batching=batching)
    assert C2.r_max == 16
    _rounded(C2, jalg.tlr_gemm(jalg.tlr_gemm(jA.A, jB.A, 1e-10,
                                             batching=batching),
                               jA, 1e-8, r_max_out=16, batching=batching))


@pytest.mark.parametrize("nb", [1, 2])
def test_gemm_degenerate_grids(nb):
    """nb = 1: no off-diagonal tiles, the product is D @ D; nb = 2: no
    middle terms."""
    jop, top = _spd_operator(30, nb, 32)
    C = tlr_gemm(top.A, top.A, 1e-10)
    _rounded(C, jalg.tlr_gemm(jop.A, jop.A, 1e-10))
    want = _dense(top) @ _dense(top)
    np.testing.assert_allclose(_dense(C), want, rtol=1e-11, atol=1e-11)
    assert C.U.shape[0] == nb * (nb - 1)


def test_chunked_accumulation_equals_one_chunk(monkeypatch):
    """A byte budget of one output tile per chunk gives the one-chunk
    result: the chunks change only which tiles share a launch."""
    (_, tA), (_, tB) = (_spd_operator(8, 5, 16, kind="cov"),
                        _spd_operator(9, 5, 16))
    _, tL = _spd_operator(10, 5, 16)
    one = (tlr_gemm(tA.A, tB.A, 1e-10), tlr_syrk(tA.A, tL.A, 1e-10))
    assert algebra.gemm_chunks(5, 16, 16, 16) == 1
    monkeypatch.setattr(algebra, "GEMM_CHUNK_BYTES", 1)
    assert algebra.gemm_chunks(5, 16, 16, 16) == 20
    many = (tlr_gemm(tA.A, tB.A, 1e-10), tlr_syrk(tA.A, tL.A, 1e-10))
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a.ranks.numpy(), b.ranks.numpy())
        np.testing.assert_allclose(_dense(b), _dense(a), rtol=1e-13,
                                   atol=1e-13)


@pytest.fixture(scope="module")
def jax_factor():
    """The JAX package's Cholesky factor of another operator, and the
    port's copy of it."""
    jfac = _spd_operator(14, 4, 32, kind="cov")[0].cholesky(
        JCholOptions(eps=1e-9, bs=8))
    return jfac, tlr_from_numpy(jfac.L.D, jfac.L.U, jfac.L.V, jfac.L.ranks,
                                device="cpu")


@pytest.mark.parametrize("batching", ["flat", "ranked"])
def test_syrk_general_update(batching, jax_factor):
    """C = A - L L^T for an L that is not A's factor (JAX's factor of
    another operator, carried across)."""
    jop, top = _spd_operator(13, 4, 32)
    jfac, L = jax_factor
    C = tlr_syrk(top.A, L, 1e-10, batching=batching)
    _rounded(C, jalg.tlr_syrk(jop.A, jfac.L, 1e-10, batching=batching))
    Ld = np.tril(L.to_dense().numpy())
    want = _dense(top) - Ld @ Ld.T
    assert np.linalg.norm(_dense(C) - want) / np.linalg.norm(want) < 1e-7


def test_tiles_carry_across():
    jop, _ = _spd_operator(15, 3, 16)
    Gj = jalg.tlr_gemm(jop.A, jop.A, 1e-8)
    G = tiles_from_numpy(Gj.D, Gj.U, Gj.V, Gj.ranks, device="cpu")
    np.testing.assert_array_equal(G.U.numpy(), np.asarray(Gj.U))
    _exact(G, Gj)
    _exact(_jax_tiles(G), Gj)


# -- operator facade -----------------------------------------------------------


def test_operator_arithmetic():
    (jA, tA), (jB, tB) = _spd_operator(18, 4, 32), _spd_operator(19, 4, 32)
    for got, want in ((tA + tB, jA + jB), (tA - tB, jA - jB),
                      (2.5 * tA, 2.5 * jA), (tA * 2.5, jA * 2.5),
                      (-tA, -jA)):
        assert isinstance(got, TLROperator)
        _exact(got, want)
    rounded = (tA + tB).round(1e-8)
    assert isinstance(rounded, TLROperator) and rounded.r_max == tA.b
    _rounded(rounded.A, (jA + jB).round(1e-8).A)
    C = tA.compose(tB, eps=1e-10)
    assert isinstance(C, TLRTiles)
    _rounded(C, jA.compose(jB, eps=1e-10))
    np.testing.assert_allclose(_dense(C), _dense(tA) @ _dense(tB),
                               rtol=1e-7, atol=1e-8)
    with pytest.raises(TypeError):
        tA + 3


# -- Newton-Schulz preconditioner ----------------------------------------------


@pytest.mark.parametrize("scale,batching", [("norm", "flat"),
                                            ("trace", "ranked")])
def test_newton_schulz_matches_jax(scale, batching):
    jop, top = _spd_operator(23, 4, 32)
    X, info = tlr_newton_schulz(top, iters=4, eps=1e-9, scale=scale,
                                batching=batching)
    Xj, infoj = jax_newton_schulz(jop, iters=4, eps=1e-9, scale=scale,
                                  batching=batching)
    assert abs(info.alpha - infoj.alpha) <= 1e-12 * abs(infoj.alpha)
    assert info.iters == infoj.iters == 4
    assert info.eps_history == infoj.eps_history
    w = _dense(Xj)
    assert np.linalg.norm(_dense(X) - w) / np.linalg.norm(w) <= 1e-8
    assert info.max_rank == infoj.max_rank
    if scale == "trace":
        assert info.alpha == pytest.approx(1.0 / float(top.trace()),
                                           rel=1e-15)


def test_newton_schulz_adaptive_eps_and_stopping_rule():
    """Adaptive eps (loose early, tight late) and the residual stopping
    rule: the same iteration count and eps sequence as the JAX package."""
    jop, top = _spd_operator(22, 4, 32)
    kw = dict(iters=30, eps=1e-10, scale="norm", adaptive=True, tol=1e-6,
              track_residual=True)
    X, info = tlr_newton_schulz(top, **kw)
    _, infoj = jax_newton_schulz(jop, **kw)
    assert info.converged and infoj.converged
    assert info.iters == infoj.iters < 30
    np.testing.assert_allclose(info.eps_history, infoj.eps_history,
                               rtol=1e-6)
    np.testing.assert_allclose(info.residual_history,
                               infoj.residual_history, rtol=1e-4,
                               atol=1e-12)
    assert info.residual_history[-1] < 1e-6
    assert info.eps_history[-1] <= info.eps_history[0]
    assert info.eps_history[0] > 1e-10
    _, info1 = tlr_newton_schulz(top, iters=1, eps=1e-8, scale="trace",
                                 adaptive=True, tol=1e-12)
    assert info1.iters == 1 and not info1.converged
    _, info2 = tlr_newton_schulz(top, iters=2, eps=5e-2, scale="trace",
                                 adaptive=True)
    assert all(e >= 5e-2 for e in info2.eps_history)
    with pytest.raises(ValueError, match="scale"):
        tlr_newton_schulz(top, iters=1, scale="bogus")


def test_kernel_operands_meet_the_cuda_layout(monkeypatch):
    """Every ``batched_gemm`` / ``batched_qr`` / ``small_svd`` operand the
    algebra hands the kernels is contiguous (and the ranks int32), as the
    CUDA wrappers require; the plain versions on the CPU accept any
    layout, so this is checked here with a recording dispatcher. Covers
    the flat and ranked GEMM (down to width-1 buckets: the first
    Newton-Schulz product of a rank-0 X), SYRK, symmetrize and axpy."""
    from repro_torch.kernels import ops

    seen = []

    def check(name, inner):
        def run(*args):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), \
                (name, [tuple(t.shape) for t in tensors])
            if name == "batched_gemm":
                assert args[2].dtype == torch.int32
            seen.append(name)
            return inner(*args)
        return run

    for name in ("batched_gemm", "batched_qr", "small_svd"):
        monkeypatch.setattr(ops, name, check(name, getattr(ops, name)))
    _, top = _spd_operator(24, 4, 16)
    for batching in ("flat", "ranked"):
        tlr_newton_schulz(top, iters=1, eps=1e-9, batching=batching)
        tlr_syrk(top.A, top.A, 1e-9, batching=batching)
    assert set(seen) == {"batched_gemm", "batched_qr", "small_svd"}
