"""Parity of the port's rounding pass against the JAX package: the plain
versions of ``batched_qr`` and ``small_svd`` against the Pallas kernels
(interpret mode) and ``repro.kernels.ref``, then ``tlr_round_tiles`` (both
branches) and ``TLROperator.round`` against ``repro``'s with ``impl="ref"``.

Kernel tolerances are those of tests/test_kernels.py (f64 1e-12, f32 1e-5,
``atol`` scaled by the contraction length; the SVD's by 100). The plain
MGS2 runs the Pallas kernel's arithmetic, so it is also held to Q and R
elementwise; the plain Jacobi runs its rotations in the same row-cyclic
sequence (regrouped into wavefront stages), so singular values match it to
rounding. The rounding-pass tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TLROperator as JOperator
from repro.core import covariance_problem
from repro.core.algebra import tlr_round_tiles as jax_round_tiles
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.batched_qr import batched_qr_pallas
from repro.kernels.small_svd import small_svd_pallas
from repro_torch.convert import operator_from_numpy
from repro_torch.core.algebra import tlr_round, tlr_round_tiles
from repro_torch.kernels import batched_qr as tqr
from repro_torch.kernels import ops
from repro_torch.kernels import small_svd as tsvd

TOL = {jnp.float64: 1e-12, jnp.float32: 1e-5}
TORCH_DTYPE = {jnp.float64: torch.float64, jnp.float32: torch.float32}


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


def _rand(key, shape, dtype):
    return jax.random.normal(key, shape, jnp.float32).astype(dtype)


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float64).copy()).to(
        TORCH_DTYPE[dtype])


# -- batched_qr -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("T,b,r", [(1, 16, 4), (4, 32, 8), (3, 64, 16)])
def test_batched_qr_plain_matches_jax(T, b, r, dtype):
    """The rounding-pass contract (Y ~= Q R, orthonormal live columns, R
    upper triangular) against the Householder oracle's, and Q, R elementwise
    against the Pallas MGS2 (same algorithm, other summation order)."""
    Y = _rand(jax.random.PRNGKey(7), (T, b, r), dtype)
    Q, R = ops.batched_qr(_t(Y, dtype))
    assert Q.dtype == TORCH_DTYPE[dtype] and R.shape == (T, r, r)
    tol = TOL[dtype]
    Yn = np.asarray(Y, np.float64)
    for Qx, Rx in ((Q.numpy(), R.numpy()), ref.batched_qr_ref(Y)):
        Qx, Rx = np.asarray(Qx, np.float64), np.asarray(Rx, np.float64)
        np.testing.assert_allclose(Qx @ Rx, Yn, rtol=tol,
                                   atol=tol * np.sqrt(b))
        gram = np.swapaxes(Qx, 1, 2) @ Qx
        np.testing.assert_allclose(gram, np.broadcast_to(np.eye(r),
                                                         gram.shape),
                                   atol=10 * tol)
        assert np.allclose(Rx, np.triu(Rx), atol=tol)
    Qj, Rj = batched_qr_pallas(Y, interpret=True)
    np.testing.assert_allclose(Q.double().numpy(), np.asarray(Qj, np.float64),
                               rtol=tol, atol=tol * np.sqrt(b))
    np.testing.assert_allclose(R.double().numpy(), np.asarray(Rj, np.float64),
                               rtol=tol, atol=tol * np.sqrt(b))


def test_batched_qr_rank_deficient_drops_columns():
    """Dependent and zero columns come out exactly zero in Q, as in the
    Pallas kernel, with Y = Q R still holding."""
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((2, 24, 6))
    Y[0][:, 4] = 2.0 * Y[0][:, 1] - Y[0][:, 0]
    Y[1][:, 2] = 0.0
    Q, R = ops.batched_qr(torch.from_numpy(Y))
    Q, R = Q.numpy(), R.numpy()
    assert np.abs(Q[0][:, 4]).max() == 0.0
    assert np.abs(Q[1][:, 2]).max() == 0.0
    np.testing.assert_allclose(Q @ R, Y, atol=1e-10)
    Qj, _ = batched_qr_pallas(jnp.asarray(Y), interpret=True)
    assert (np.asarray(Qj)[0][:, 4] == 0).all()
    np.testing.assert_allclose(Q, np.asarray(Qj), atol=1e-12)


@pytest.mark.parametrize("scale", [1e5, 1e-5])
def test_batched_qr_extreme_column_scales(scale):
    """The drop tolerance follows the current column norms each sweep: an
    f32 panel scaled by 1e5 keeps every column in sweep 2."""
    Y = scale * _rand(jax.random.PRNGKey(11), (3, 32, 8), jnp.float32)
    Q, R = ops.batched_qr(_t(Y, jnp.float32))
    np.testing.assert_allclose((Q @ R).double().numpy(),
                               np.asarray(Y, np.float64), rtol=1e-4,
                               atol=1e-4 * scale)
    gram = (Q.transpose(1, 2) @ Q).numpy()
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(8), gram.shape),
                               atol=1e-3)


def test_batched_qr_rejects_wide_panels_and_other_dtypes():
    with pytest.raises(ValueError, match="tall panels"):
        ops.batched_qr(torch.zeros((1, 8, 16)))
    with pytest.raises(TypeError, match="float64, float32"):
        ops.batched_qr(torch.zeros((1, 8, 4), dtype=torch.bfloat16))


def _blocked_mgs2(Y, nb, sweeps=2):
    """MGS2 in panels of ``nb`` columns, each panel's trailing update in the
    blocked form the CUDA kernels use: with P the finished panel, S = P^T
    W_t, (I + strict_lower(P^T P)) D = S by forward substitution, W_t -= P
    D. That is MGS's own recurrence (d_a = p_a^T w - sum_{c<a} p_a^T p_c
    d_c); only the order of the sums differs. A ragged last panel is
    narrower."""
    T, b, r = Y.shape
    rel, tiny = tqr.REL[Y.dtype], torch.finfo(Y.dtype).tiny
    W = Y.clone()
    for _ in range(sweeps):
        col = W.square().sum(dim=1).sqrt()
        tol = (rel * col.amax(dim=1, keepdim=True)).clamp(min=tiny)
        for k0 in range(0, r, nb):
            k1 = min(k0 + nb, r)
            for k in range(k0, k1):
                q = W[:, :, k]
                nrm = q.square().sum(dim=1, keepdim=True).sqrt()
                q = torch.where(nrm > tol, q / torch.maximum(nrm, tol),
                                torch.zeros_like(q))
                W[:, :, k] = q
                later = W[:, :, k + 1:k1]
                later -= q[:, :, None] * torch.einsum("tb,tbj->tj", q,
                                                      later)[:, None, :]
            if k1 < r:
                P = W[:, :, k0:k1]
                G = P.transpose(1, 2) @ P
                D = P.transpose(1, 2) @ W[:, :, k1:]
                for a in range(1, k1 - k0):
                    D[:, a] -= torch.einsum("tc,tcj->tj", G[:, a, :a],
                                            D[:, :a])
                W[:, :, k1:] -= P @ D
    return W, W.transpose(1, 2) @ Y


def _graded_tiles(T, seed):
    """(T, 128, 128) exponential-covariance tiles (l = 0.1) between two
    clusters of 128 points, in [0, 0.5]^2 and [0.5, 1]^2: graded singular
    values, a quarter to a third of the columns live at the drop
    tolerance, as the right-looking driver densifies its tiles."""
    rng = np.random.default_rng(seed)
    pa = 0.5 * rng.random((T, 128, 2))
    pb = 0.5 + 0.5 * rng.random((T, 128, 2))
    d = np.sqrt(((pa[:, :, None, :] - pb[:, None, :, :]) ** 2).sum(-1))
    return np.exp(-d / 0.1)


def _contract(Y, Q, R):
    """(dead-column mask, max_t ||Q R - Y|| / ||Y||, max_t ||Q_live^T
    Q_live - I||) of one QR, in f64."""
    Y, Q, R = (np.asarray(x, np.float64) for x in (Y, Q, R))
    dead = np.abs(Q).max(axis=1) == 0
    res = (np.linalg.norm(Q @ R - Y, axis=(1, 2))
           / np.linalg.norm(Y, axis=(1, 2))).max()
    gram = np.swapaxes(Q, 1, 2) @ Q - np.stack([np.diag(~d) for d in dead])
    return dead, res, np.linalg.norm(gram, axis=(1, 2)).max()


@pytest.mark.parametrize("nb", [16, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("T,b,r", [(2, 40, 24), (3, 64, 40)])
def test_blocked_mgs2_matches_pallas_and_plain(T, b, r, dtype, nb):
    """The blocked form of the CUDA kernels (panels of 16 or 8, a ragged
    last panel) is MGS2: Q and R elementwise against the Pallas kernel and
    the plain version, at the kernel tolerances, with a dead column."""
    Y = np.array(_rand(jax.random.PRNGKey(5), (T, b, r), dtype),
                 np.float64)
    Y[0][:, 5] = 2.0 * Y[0][:, 1] - Y[0][:, 0]
    Y = Y.astype(np.dtype(dtype))
    Q, R = _blocked_mgs2(_t(Y, dtype), nb)
    assert float(Q[0, :, 5].abs().max()) == 0.0
    tol = TOL[dtype]
    for Qx, Rx in (batched_qr_pallas(jnp.asarray(Y), interpret=True),
                   tqr.batched_qr_plain(_t(Y, dtype))):
        np.testing.assert_allclose(Q.double().numpy(),
                                   np.asarray(Qx, np.float64), rtol=tol,
                                   atol=tol * np.sqrt(b))
        np.testing.assert_allclose(R.double().numpy(),
                                   np.asarray(Rx, np.float64), rtol=tol,
                                   atol=tol * np.sqrt(b))


@pytest.mark.parametrize("nb", [16, 8])
def test_blocked_mgs2_graded_contract(nb):
    """On graded covariance tiles Q elementwise is no gate for any
    summation order (permuting the plain version's rows moves Q by 1e-8),
    so the blocked form is held to the QR contract against the plain
    version and the Pallas kernel: the same dead columns, R within 1e-12
    relative (per tile, Frobenius), and the reconstruction and
    orthogonality errors within 10x theirs."""
    Y = _graded_tiles(3, 6)
    Q, R = (x.numpy() for x in _blocked_mgs2(torch.from_numpy(Y), nb))
    dead, res, orth = _contract(Y, Q, R)
    assert 0 < (~dead).sum() < dead.size
    for Qx, Rx in (batched_qr_pallas(jnp.asarray(Y), interpret=True),
                   tqr.batched_qr_plain(torch.from_numpy(Y))):
        Qx, Rx = np.asarray(Qx, np.float64), np.asarray(Rx, np.float64)
        dead_x, res_x, orth_x = _contract(Y, Qx, Rx)
        np.testing.assert_array_equal(dead, dead_x)
        rel = (np.linalg.norm(R - Rx, axis=(1, 2))
               / np.linalg.norm(Rx, axis=(1, 2)))
        assert rel.max() <= 1e-12
        assert res <= 10 * res_x and orth <= 10 * orth_x


# -- small_svd ------------------------------------------------------------------


def test_wavefront_stages_are_the_row_cyclic_sweep():
    """Every pair once per sweep, the pairs of a stage disjoint, and any two
    pairs that share a column kept in their row-cyclic order."""
    for n in range(1, 14):
        stages = tsvd.stages(n)
        seq = [(p, q) for ps, qs in stages for p, q in zip(ps, qs)]
        cyclic = [(p, q) for p in range(n) for q in range(p + 1, n)]
        assert sorted(seq) == cyclic
        at = {pq: i for i, (ps, qs) in enumerate(stages)
              for pq in zip(ps, qs)}
        for ps, qs in stages:
            assert len(set(ps) | set(qs)) == 2 * len(ps)
        for i, a in enumerate(cyclic):
            for c in cyclic[i + 1:]:
                if set(a) & set(c):
                    assert at[a] < at[c]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("T,n", [(1, 4), (3, 8), (2, 16)])
def test_small_svd_plain_matches_jax(T, n, dtype):
    """Singular values and the reconstruction against the Pallas Jacobi
    (interpret) and the LAPACK oracle, at tests/test_kernels.py's
    tolerances."""
    M = _rand(jax.random.PRNGKey(9), (T, n, n), dtype)
    U, s, V = ops.small_svd(_t(M, dtype))
    assert s.dtype == TORCH_DTYPE[dtype]
    tol = TOL[dtype]
    for want in (jops.small_svd(M, impl="interpret"), ref.small_svd_ref(M)):
        np.testing.assert_allclose(s.double().numpy(),
                                   np.asarray(want[1], np.float64),
                                   rtol=100 * tol, atol=100 * tol)
    rec = torch.einsum("tmn,tn,tkn->tmk", U, s, V).double().numpy()
    np.testing.assert_allclose(rec, np.asarray(M, np.float64), rtol=tol,
                               atol=100 * tol * np.sqrt(n))


def test_small_svd_low_rank_sorting_and_shape_checks():
    rng = np.random.default_rng(5)
    M = np.einsum("tm,tn->tmn", rng.standard_normal((3, 10)),
                  rng.standard_normal((3, 10)))  # rank-1 batch
    U, s, V = ops.small_svd(torch.from_numpy(M))
    s = s.numpy()
    assert (np.diff(s, axis=-1) <= 1e-12).all()   # descending
    assert (s[:, 1:] < 1e-10 * s[:, :1]).all()    # rank 1
    # U columns of (numerically) zero singular values are zeroed only
    # below tiny, as in the Pallas kernel; the reconstruction holds.
    np.testing.assert_allclose(
        np.einsum("tmn,tn,tkn->tmk", U.numpy(), s, V.numpy()), M,
        atol=1e-12)
    with pytest.raises(ValueError, match="n <= m"):
        ops.small_svd(torch.zeros((1, 4, 8)))


def test_small_svd_plain_follows_the_pallas_rotations():
    """Same rotation sequence as the Pallas kernel: before sorting, the
    values agree position by position, and U, V agree elementwise on a
    well-separated spectrum."""
    rng = np.random.default_rng(8)
    Qa, _ = np.linalg.qr(rng.standard_normal((2, 12, 12)))
    Qb, _ = np.linalg.qr(rng.standard_normal((2, 12, 12)))
    M = Qa * np.linspace(3.0, 0.1, 12)[None, None, :] @ Qb
    U, s, V = tsvd.small_svd_plain(torch.from_numpy(M))
    Uj, sj, Vj = small_svd_pallas(jnp.asarray(M), interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-12)
    np.testing.assert_allclose(U.numpy(), np.asarray(Uj), atol=1e-10)
    np.testing.assert_allclose(V.numpy(), np.asarray(Vj), atol=1e-10)


def _half_atan2_reference(x, y, work):
    """cos and sin of atan2(y, x) / 2 in the wider type ``work``; for x < 0
    through the complementary angle, (sin psi, +-cos psi) with psi =
    atan2(|y|, -x) / 2, which carries no cancellation when c is small."""
    x, y = x.astype(work), y.astype(work)
    theta = np.arctan2(y, x) / 2
    psi = np.arctan2(np.abs(y), -x) / 2
    neg = x < 0
    c = np.where(neg, np.sin(psi), np.cos(theta))
    s = np.where(neg, np.copysign(np.cos(psi), y), np.sin(theta))
    return c, s


@pytest.mark.parametrize("dtype,work,scale", [
    (np.float64, np.longdouble, 150), (np.float32, np.float64, 18)])
def test_rotation_matches_half_atan2(dtype, work, scale):
    """The angle without trigonometry (``small_svd.rotation``) against cos
    and sin of atan2(2 gamma, alpha - beta) / 2 taken in a wider type:
    within 2 ulp relative to each of c and s (the formula reaches 1.35),
    and within 2 eps of the working type's own cos / sin of half of
    atan2. Cases: all four quadrants, x < 0 with |y| << |x| (where
    sqrt((1 + u) / 2) would cancel), alpha == beta, and magnitudes near
    10^(+-scale) (f64 1e+-150; f32 1e+-18, within its range for squared
    norms). Skipped rotations give (1, 0)."""
    assert np.finfo(work).eps < np.finfo(dtype).eps / 100
    eps = np.finfo(dtype).eps
    rng = np.random.default_rng(11)
    for mag in (1.0, 10.0 ** scale, 10.0 ** -scale):
        x = rng.standard_normal(2000) * mag
        y = rng.standard_normal(2000) * mag
        x[:500] = -np.abs(x[:500])
        y[:500] *= 10.0 ** rng.uniform(-12, -1, 500)
        x[500:550] = 0.0
        x, y = x.astype(dtype), y.astype(dtype)
        for qx, qy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            assert ((np.sign(x) == qx) & (np.sign(y) == qy)).any()
        # alpha - beta = x exactly: alpha = |x| and beta = |x| - x are
        # exact in binary floating point.
        alpha, beta = np.abs(x), np.abs(x) - x
        assert (alpha - beta == x).all()
        c, s = tsvd.rotation(torch.from_numpy(alpha), torch.from_numpy(beta),
                             torch.from_numpy(y / 2))
        c, s = c.numpy(), s.numpy()
        assert c.dtype == dtype and (c >= 0).all()
        cr, sr = _half_atan2_reference(x, y, work)
        assert (np.abs(c - cr) <= 2 * eps * np.abs(cr)).all()
        assert (np.abs(s - sr) <= 2 * eps * np.abs(sr)).all()
        theta = np.arctan2(y, x) / 2
        assert np.abs(c - np.cos(theta)).max() <= 2 * eps
        assert np.abs(s - np.sin(theta)).max() <= 2 * eps
    tiny = np.finfo(dtype).tiny
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    c, s = tsvd.rotation(*(torch.tensor([v], dtype=tdtype)
                           for v in (1.0, 2.0, tiny)))
    assert (float(c), float(s)) == (1.0, 0.0)


def test_stages_overlap_sweeps_in_row_cyclic_order():
    """``stages(n, sweeps)``, the schedule of the kernel and the plain
    version: pair (p, q) of sweep k at stage k (2n - 1) + 2p + q, every
    pair of every sweep once, the pairs of a stage disjoint, and each
    column's uses in the flat row-cyclic sequence (sweep after sweep) at
    increasing stages, so the rotations are the sequential ones. Uses one
    stage apart are a row's consecutive pairs (p, q), (p, q + 1), whose
    column p the kernel keeps in one slot's registers; all others are at
    least two apart, which lets the kernel synchronise every second stage."""
    for n in range(1, 15):
        for sweeps in (1, 2, 3):
            st = tsvd.stages(n, sweeps)
            offset = 2 * n - 1
            got = sorted((t + 1, p, q) for t, (ps, qs) in enumerate(st)
                         for p, q in zip(ps, qs))
            seq = [(k, p, q) for k in range(sweeps) for p in range(n)
                   for q in range(p + 1, n)]
            assert got == sorted((k * offset + 2 * p + q, p, q)
                                 for k, p, q in seq)
            for ps, qs in st:
                assert len(set(ps) | set(qs)) == 2 * len(ps)
            last = {}
            for k, p, q in seq:
                t = k * offset + 2 * p + q
                for col in (p, q):
                    t0, pair0 = last.get(col, (-1, None))
                    assert t0 + 2 <= t or (t0 + 1 == t and pair0 == (k, p)
                                           and col == p)
                    last[col] = (t, (k, p))
    assert len(tsvd.stages(128, 8)) == 17 * 128 - 12


def _replay_order(n, rb=8, qb=4):
    """The order in which the CUDA kernel replays one sweep's rotations
    onto V (csrc/small_svd.cu, replay_unit): units of rb rows p0 .. p0 +
    nb - 1, first the pairs among them row by row, then the columns q >=
    p0 + nb in steps of qb, each step row-major over (row, column). The log
    is written in unit order: the pairs among the rows, then q-major."""
    order, log = [], []
    for p0 in range(0, n - 1, rb):
        nb = min(rb, n - 1 - p0)
        rows = range(p0, p0 + nb)
        tri = [(p, q) for p in rows for q in range(p + 1, p0 + nb)]
        order += tri
        log += tri
        log += [(p, q) for q in range(p0 + nb, n) for p in rows]
        for q0 in range(p0 + nb, n, qb):
            order += [(p, q) for p in rows
                      for q in range(q0, min(q0 + qb, n))]
    return order, log


def test_replay_order_keeps_the_row_cyclic_order():
    """The kernel's V replay applies every pair of a sweep once, in an
    order that keeps the row-cyclic order of any two pairs that share a
    column (so it gives the sequential product of the rotations), and the
    A phase's running log position (csrc/small_svd.cu) puts each pair at
    its place in the replay's log."""
    for n in list(range(2, 20)) + [33, 128]:
        cyclic = [(p, q) for p in range(n) for q in range(p + 1, n)]
        order, log = _replay_order(n)
        assert sorted(order) == cyclic and sorted(log) == cyclic
        rank = {pq: i for i, pq in enumerate(cyclic)}
        last = {}
        for p, q in order:
            for col in (p, q):
                assert last.get(col, -1) < rank[(p, q)]
                last[col] = rank[(p, q)]
        at = {pq: i for i, pq in enumerate(log)}
        for p in range(n - 1):
            # the kernel's running log position along row p (set_row, then
            # +1 while q is a row of the unit, then the q-major stride nb)
            p0 = p // 8 * 8
            nb = min(8, n - 1 - p0)
            i, qend = p - p0, p0 + nb
            start = p0 * (n - 1) - p0 * (p0 - 1) // 2
            qmajor = start + nb * (nb - 1) // 2 + i
            pos = start + i * nb - i * (i + 1) // 2 if p + 1 < qend else qmajor
            for q in range(p + 1, n):
                assert at[(p, q)] == pos
                pos = (pos + 1 if q + 1 < qend
                       else qmajor if q + 1 == qend else pos + nb)


# -- the rounding pass ------------------------------------------------------------


def _accumulated(seed, N=6, b=16, w=40):
    """(N, b, w) factor stacks whose products have singular values
    10^(0.75 - k/2): a spectrum that decays geometrically, as covariance
    tiles' do, with the cut at 1e-6 between two values. w > b splits the
    product over two halves plus random columns against zero ones."""
    rng = np.random.default_rng(seed)
    Qa, _ = np.linalg.qr(rng.standard_normal((N, b, b)))
    Qb, _ = np.linalg.qr(rng.standard_normal((N, b, b)))
    A = Qa * 10.0 ** (0.75 - np.arange(b) / 2)
    if w <= b:
        return A[:, :, :w].copy(), Qb[:, :, :w].copy()
    extra = w - 2 * b
    U = np.concatenate([A / 2, A / 2, np.zeros((N, b, extra))], axis=-1)
    V = np.concatenate([Qb, Qb, rng.standard_normal((N, b, extra))], axis=-1)
    return U, V


def _round_both(U, V, impl):
    Uj, Vj, rj, ej = jax_round_tiles(jnp.asarray(U), jnp.asarray(V), 1e-6,
                                     r_out=16, impl=impl)
    Ut, Vt, rt, et = tlr_round_tiles(torch.from_numpy(U), torch.from_numpy(V),
                                     1e-6, r_out=16)
    assert Ut.shape == (U.shape[0], 16, 16)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    rec_diff = np.abs((Ut @ Vt.transpose(1, 2)).numpy()
                      - np.asarray(Uj @ jnp.swapaxes(Vj, 1, 2))).max()
    return rt.numpy(), rec_diff, np.abs(et.numpy() - np.asarray(ej)).max()


@pytest.mark.parametrize("w", [12, 40])
def test_round_tiles_matches_jax(w):
    """Both branches (w <= b factored, w > b densify) against the JAX
    package's ``impl="ref"`` (Householder QR, LAPACK SVD). Ranks equal;
    the rounded tiles U V^T (entries O(1), f64) and the dropped-value norms
    ``err`` within 1e-10: with the cut between two singular values, the two
    algorithms differ only by rounding."""
    U, V = _accumulated(0, w=w)
    ranks, rec_diff, err_diff = _round_both(U, V, "ref")
    assert (ranks == (14 if w > 12 else 12)).all()
    assert rec_diff <= 1e-10 and err_diff <= 1e-10


def test_round_tiles_noise_at_the_drop_band():
    """A rank-5 product plus a noise floor of 1e-7, inside MGS2's drop band
    (columns whose residual is under 1e-8 x the largest column norm are
    zeroed; Householder keeps them). Against the Pallas kernels
    (``impl="interpret"``, the same MGS2 and Jacobi) the port agrees to
    1e-10; against ``impl="ref"`` to the drop tolerance, 1e-8 x the largest
    column norm of the dense tiles."""
    rng = np.random.default_rng(0)
    U = rng.standard_normal((6, 16, 5)) @ rng.standard_normal((6, 5, 40))
    U += 1e-7 * rng.standard_normal((6, 16, 40))
    V = rng.standard_normal((6, 16, 40)) / np.sqrt(40)
    _, rec_diff, err_diff = _round_both(U, V, "interpret")
    assert rec_diff <= 1e-10 and err_diff <= 1e-10
    band = 1e-8 * np.linalg.norm(U @ np.swapaxes(V, 1, 2), axis=1).max()
    _, rec_diff, err_diff = _round_both(U, V, "ref")
    assert rec_diff <= band and err_diff <= band


def test_round_tiles_zero_tile_has_rank_zero():
    U, V = _accumulated(1, N=3, w=40)
    U[1] = 0.0
    _, _, rt, et = tlr_round_tiles(torch.from_numpy(U), torch.from_numpy(V),
                                   1e-6, r_out=16)
    assert int(rt[1]) == 0 and float(et[1]) == 0.0


def test_operator_round_matches_jax():
    """``TLROperator.round`` on a compressed covariance operator (factored
    branch): ranks equal and the rounded operators' dense forms within
    1e-10 (entries O(1), f64)."""
    _, K = covariance_problem(256, 2, 32)
    jop = JOperator.compress(jnp.asarray(K), 32, 32, 1e-9)
    A = jop.A
    op = operator_from_numpy(A.D, A.U, A.V, A.ranks, device="cpu")
    jr = jop.round(1e-5, impl="ref", batching="flat")
    pr = op.round(1e-5)
    np.testing.assert_array_equal(pr.ranks.numpy(), np.asarray(jr.ranks))
    assert (pr.ranks.numpy() <= op.ranks.numpy()).all()
    np.testing.assert_allclose(pr.to_dense().numpy(),
                               np.asarray(jr.to_dense()), atol=1e-10)
    # the rounded operator still applies K to eps accuracy
    x = np.random.default_rng(0).standard_normal(256)
    y = pr.matvec(torch.from_numpy(x)).numpy()
    assert np.linalg.norm(y - np.asarray(K) @ x) / \
        np.linalg.norm(np.asarray(K) @ x) < 1e-4


def test_round_densify_branch_and_unported_options():
    """A TLRMatrix wider than its tile takes the densify branch of
    ``tlr_round`` (rank-masked by ``A.ranks``) and matches the JAX
    package's, flat, ranked (densify buckets) and auto alike; an unknown
    ``batching`` raises."""
    _, K = covariance_problem(128, 2, 16)
    jop = JOperator.compress(jnp.asarray(K), 16, 16, 1e-9)
    A = jop.A
    from repro.core.algebra import tlr_round as jax_round
    from repro.core.tlr import TLRMatrix
    wide = TLRMatrix(D=A.D, U=jnp.concatenate([A.U, 0.5 * A.U], axis=-1),
                     V=jnp.concatenate([A.V, A.V], axis=-1),
                     ranks=A.ranks + 16)
    jr = jax_round(wide, 1e-7, impl="ref", batching="flat")
    op = operator_from_numpy(wide.D, wide.U, wide.V, wide.ranks, device="cpu")
    pr = tlr_round(op.A, 1e-7)
    assert pr.r_max == 16
    np.testing.assert_array_equal(pr.ranks.numpy(), np.asarray(jr.ranks))
    np.testing.assert_allclose(pr.to_dense().numpy(),
                               np.asarray(jr.to_dense()), atol=1e-10)
    for batching in ("ranked", "auto"):
        rr = op.round(1e-7, batching=batching)
        np.testing.assert_array_equal(rr.ranks.numpy(), np.asarray(jr.ranks))
        np.testing.assert_allclose(rr.to_dense().numpy(),
                                   np.asarray(jr.to_dense()), atol=1e-10)
    with pytest.raises(ValueError, match="batching"):
        op.round(1e-6, batching="bucketed")
