"""Batched TLR tile algebra: rounding, structured ops, GEMM / SYRK.

Port of ``repro/core/algebra.py`` (:63-761, :764-1000):

* ``TLRTiles`` -- the general (nonsymmetric) tile grid with all
  ``nb (nb - 1)`` off-diagonal tiles stored, the result type of
  ``tlr_gemm``; ``generalize`` mirrors a symmetric ``TLRMatrix`` onto it
  and ``symmetrize`` projects back onto ``0.5 (G + G^T)``.
* ``tlr_round_tiles`` / ``tlr_round`` -- recompress stacks of accumulated
  tile factors ``U V^T`` in one batched pass: factored (``batched_qr`` of
  both sides, ``small_svd`` of the ``r x r`` core ``R_u R_v^T``) when the
  width is at most the tile size b, densify-then-compress
  (``batched_gemm`` to the ``b x b`` tile, ``batched_qr``, ``small_svd``
  of R) when it is wider. Singular values ``> eps`` (absolute, or
  ``> eps * s_max`` with ``rel``) are kept, so a zero tile has rank 0.
  ``batching="ranked"`` (or ``"auto"`` resolving to it) runs the pass once
  per rank bucket at the bucket's ladder width (``core/batching.py``).
* ``tlr_axpy`` / ``tlr_scale`` / ``tlr_transpose`` / ``tlr_add_diag`` --
  structured ops; addition is an exact low-rank concatenation (ranks add)
  with optional rounding.
* ``tlr_gemm`` -- TLR x TLR product on the general grid: each output
  tile's ``nb`` inner products are accumulated densely (batched low-rank
  chains, their K-reduction one wide ``batched_gemm`` over the
  concatenated factors), then one rounding pass compresses all output
  tiles. ``tlr_syrk`` -- the symmetric update ``A - L L^T``, its term
  counts padded up the power-of-two bucket ladder.
* ``tlr_syrk_column`` -- the right-looking factorization's trailing update
  for one factored column: every trailing tile receives the column's rank-r
  outer product as an appended factor pair (at one shared column, or at
  each tile's own content width under ranked batching), every trailing
  diagonal tile the dense product; ``part="head"`` / ``"tail"`` split it for
  the right-looking driver's lookahead schedule.

The JAX package gathers every output tile's term stacks in one piece; at
N = 8192, tile 128 (4032 output tiles, 62 terms each, width 128) each such
stack is 32.7 GB. Here the middle-term accumulation of ``tlr_gemm`` and
``tlr_syrk`` runs over chunks of output tiles, as many per chunk as fit in
``GEMM_CHUNK_BYTES`` of term workspace. Each output tile's arithmetic is
the same in every chunking; the chunks differ only in which tiles share a
launch.

The QR, SVD and GEMM work runs in the port's kernels (``kernels/ops``): the
CUDA kernels on the card, their plain versions on the CPU. ``_tiles_to_dense``
and the general-grid matvec are stock torch, as they are plain jnp in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .. import obs
from .batching import (bucket_width, bucketed_round_tiles, resolve_batching,
                       tile_batch_rows)
from .buckets import _bucket_ladder, _bucket_up, to_device
from .tlr import TLRMatrix, tril_index, tril_pairs
from ..kernels import ops

# Term workspace of one chunk of the GEMM / SYRK middle-term accumulation
# (gathered factor stacks, chain products and the concatenated K-reduction
# operands), in bytes.
GEMM_CHUNK_BYTES = 4 << 30


# -- general (nonsymmetric) tile grid -----------------------------------------


def offd_index(i: int, j: int, nb: int) -> int:
    """Flat index of off-diagonal tile (i, j), i != j, row-major skipping
    the diagonal: tile (i, j) lives at ``i*(nb-1) + (j - (j > i))``."""
    if i == j:
        raise ValueError(f"offd_index requires i != j, got ({i}, {j})")
    return i * (nb - 1) + (j if j < i else j - 1)


def _offd_index_np(i, j, nb: int):
    """:func:`offd_index` over arrays (no i == j check)."""
    return i * (nb - 1) + np.where(j < i, j, j - 1)


@lru_cache(maxsize=None)
def offd_pairs(nb: int) -> np.ndarray:
    """(no, 2) array of all off-diagonal (i, j) pairs in packed order."""
    i, j = np.nonzero(~np.eye(nb, dtype=bool))   # row-major: packed order
    return np.stack([i, j], axis=1).astype(np.int64)


@dataclasses.dataclass
class TLRTiles:
    """General (nonsymmetric) TLR matrix: the result type of ``tlr_gemm``
    and an operand type of the operator arithmetic.

    Same storage discipline as ``TLRMatrix`` but with *all* ``nb*(nb-1)``
    off-diagonal tiles stored explicitly (packed per ``offd_index``):

      D:     (nb, b, b)      dense diagonal tiles.
      U, V:  (no, b, r_max)  low-rank factors, zero-padded past ``ranks``.
      ranks: (no,) int32     leading meaningful columns per tile.
    """

    D: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    ranks: torch.Tensor

    @property
    def nb(self) -> int:
        return self.D.shape[0]

    @property
    def b(self) -> int:
        return self.D.shape[1]

    @property
    def n(self) -> int:
        return self.nb * self.b

    @property
    def r_max(self) -> int:
        return self.U.shape[2]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.D.dtype

    @property
    def device(self) -> torch.device:
        return self.D.device

    def to_dense(self) -> torch.Tensor:
        return _tiles_to_dense(self.D, self.U, self.V, self.nb, self.b)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x; x is (n,) or batched (n, m)."""
        xb = x.reshape(self.nb, self.b, *x.shape[1:])
        return _gen_matvec(self.D, self.U, self.V, xb, self.nb) \
            .reshape(x.shape)

    def __matmul__(self, x):
        if isinstance(x, torch.Tensor):
            return self.matvec(x)
        return NotImplemented

    def transpose(self) -> "TLRTiles":
        return tlr_transpose(self)

    def symmetrize(self, eps=None, r_max_out=None) -> TLRMatrix:
        return symmetrize(self, eps, r_max_out)

    def round(self, eps, r_max_out=None) -> "TLRTiles":
        return tlr_round(self, eps, r_max_out)


@lru_cache(maxsize=32)
def _offd_rows_cols(nb: int, device: torch.device):
    pairs = torch.as_tensor(offd_pairs(nb), device=device)
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()


def _tiles_to_dense(D, U, V, nb: int, b: int) -> torch.Tensor:
    out = torch.zeros((nb, b, nb, b), dtype=D.dtype, device=D.device)
    ar = torch.arange(nb, device=D.device)
    out[ar, :, ar, :] = D
    if nb > 1:
        rows, cols = _offd_rows_cols(nb, D.device)
        out[rows, :, cols, :] = U @ V.transpose(1, 2)
    return out.reshape(nb * b, nb * b)


def _gen_matvec(D, U, V, xb, nb: int) -> torch.Tensor:
    yb = torch.einsum("kbc,kc...->kb...", D, xb)
    if nb == 1:
        return yb
    rows, cols = _offd_rows_cols(nb, xb.device)
    y = torch.einsum("tbr,tr...->tb...", U,
                     torch.einsum("tbr,tb...->tr...", V, xb[cols]))
    return yb.index_add_(0, rows, y)


# -- symmetric <-> general conversion -----------------------------------------


@lru_cache(maxsize=None)
def _generalize_indices(nb: int):
    """For each general pair (i, j): its packed-lower index and whether the
    stored tile is the transpose (i < j, so the U/V roles swap)."""
    pairs = offd_pairs(nb)
    i, j = pairs[:, 0], pairs[:, 1]
    flip = i < j
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    return hi * (hi - 1) // 2 + lo, flip


def generalize(A: TLRMatrix) -> TLRTiles:
    """Mirror a symmetric TLR matrix onto the full general tile grid."""
    idx_h, flip_h = _generalize_indices(A.nb)
    idx = torch.as_tensor(idx_h, device=A.device)
    f = torch.as_tensor(flip_h, device=A.device)[:, None, None]
    U0, V0 = A.U[idx], A.V[idx]
    return TLRTiles(D=A.D, U=torch.where(f, V0, U0),
                    V=torch.where(f, U0, V0), ranks=A.ranks[idx])


@lru_cache(maxsize=None)
def _symmetrize_indices(nb: int):
    """(low, up) general-grid slots of each packed-lower pair (i, j)."""
    pairs = tril_pairs(nb)
    i, j = pairs[:, 0], pairs[:, 1]
    return _offd_index_np(i, j, nb), _offd_index_np(j, i, nb)


def symmetrize(G: TLRTiles, eps=None, r_max_out=None, *,
               batching: str = "flat") -> TLRMatrix:
    """Project onto the symmetric part, 0.5 (G + G^T), as a ``TLRMatrix``.

    Each lower tile is the exact rank-2r concatenation
    ``[G(i,j)/2 | G(j,i)^T/2]``; pass ``eps`` to recompress. The ``ranks``
    of the unrounded concat follow the axpy convention (see ``tlr_axpy``).
    """
    low_h, up_h = _symmetrize_indices(G.nb)
    low = torch.as_tensor(low_h, device=G.device)
    up = torch.as_tensor(up_h, device=G.device)
    Ul, Vl = G.U[low], G.V[low]
    Uu, Vu = G.U[up], G.V[up]
    out = TLRMatrix(
        D=0.5 * (G.D + G.D.transpose(1, 2)),
        U=torch.cat([0.5 * Ul, 0.5 * Vu], dim=-1),
        V=torch.cat([Vl, Uu], dim=-1),
        ranks=(G.r_max + G.ranks[up]).to(torch.int32),
    )
    if eps is not None:
        out = tlr_round(out, eps, r_max_out, batching=batching)
    return out


# -- the batched rounding pass ------------------------------------------------


def _full(n: int, width: int, device) -> torch.Tensor:
    return torch.full((n,), width, dtype=torch.int32, device=device)


def _truncate_svd(W, s, Z, Q_left, Q_right, eps: float, r_out: int,
                  rel: bool):
    """Truncation tail shared by both branches: given the core SVD
    ``W s Z^T`` and the orthonormal bases it lives in, build zero-padded
    ``(U, V, ranks, err)``. ``err`` is each tile's Frobenius norm of the
    dropped singular values (the bases are orthonormal)."""
    N, _, kin = W.shape
    cut = eps * (s[:, :1] if rel else torch.ones_like(s[:, :1]))
    ranks = (s > cut).sum(dim=1).clamp(0, r_out).to(torch.int32)
    k = min(r_out, kin)
    keep = torch.arange(kin, device=s.device)[None, :] < ranks[:, None]
    mask = keep[:, :k].to(W.dtype)
    err = torch.where(keep, torch.zeros_like(s), s).square().sum(dim=1).sqrt()
    full = _full(N, Q_left.shape[2], W.device)
    U = ops.batched_gemm(
        Q_left, (W[:, :, :k] * (s[:, None, :k] * mask[:, None, :]))
        .contiguous(), full)
    Zk = (Z[:, :, :k] * mask[:, None, :]).contiguous()
    V = Zk if Q_right is None else ops.batched_gemm(Q_right, Zk, full)
    if r_out > k:
        pad = (0, r_out - k)
        U = torch.nn.functional.pad(U, pad)
        V = torch.nn.functional.pad(V, pad)
    return U, V, ranks, err


def _round_factors_impl(U, V, eps: float, *, r_out: int, rel: bool):
    """Recompress (U, V) factor stacks, width <= b: batched QR of both
    sides, SVD of the ``r_in x r_in`` core ``R_u R_v^T``, truncate."""
    N, _, r_in = U.shape
    Qu, Ru = ops.batched_qr(U)
    Qv, Rv = ops.batched_qr(V)
    core = ops.batched_gemm(Ru, Rv.transpose(1, 2).contiguous(),
                            _full(N, r_in, U.device))
    W, s, Z = ops.small_svd(core)
    return _truncate_svd(W, s, Z, Qu, Qv, eps, r_out, rel)


def _compress_dense_impl(T, eps: float, *, r_out: int, rel: bool):
    """Compress dense (N, b, b) tiles: QR, then SVD of the b x b R."""
    Q, R = ops.batched_qr(T)
    W, s, Z = ops.small_svd(R)
    return _truncate_svd(W, s, Z, Q, None, eps, r_out, rel)


@obs.traced("algebra.round_tiles", cat="algebra")
def tlr_round_tiles(U: torch.Tensor, V: torch.Tensor, eps: float,
                    r_out: int | None = None, *, rel: bool = False,
                    ranks=None, batching: str = "flat"):
    """Round a raw stack of accumulated tile factors ``U V^T``.

    ``U`` / ``V`` are ``(N, b, W)`` concatenated factor stacks (zero
    columns are inert); returns ``(U, V, ranks, err)`` at width ``r_out``
    (default ``min(W, b)``), ranks allowed to truncate to 0, ``err`` the
    per-tile Frobenius norm of the dropped singular values. ``W > b``
    takes the densify-then-compress branch (exact for b x b tiles),
    ``W <= b`` the factored QR + core-SVD branch.

    With ``batching="ranked"`` and a per-tile ``ranks`` (content-width)
    bound, the pass runs through the rank buckets of ``core/batching.py``
    (``ranks[t]`` must bound tile ``t``'s nonzero columns).
    """
    batching = resolve_batching(batching, ranks, U.shape[2])
    N, b, w_in = U.shape
    r_out = r_out or min(w_in, b)
    if batching == "ranked":
        if ranks is None:
            raise ValueError(
                "tlr_round_tiles(batching='ranked') needs the per-tile "
                "``ranks`` content-width bounds to build the buckets")
        return bucketed_round_tiles(U, V, ranks, eps, r_out=r_out, rel=rel)
    if N == 0:
        z = U.new_zeros((0, b, r_out))
        return (z, z.clone(), torch.zeros((0,), dtype=torch.int32,
                                          device=U.device), U.new_zeros((0,)))
    if w_in <= b:
        return _round_factors_impl(U.contiguous(), V.contiguous(), eps,
                                   r_out=r_out, rel=rel)
    dense = ops.batched_gemm(U.contiguous(), V.transpose(1, 2).contiguous(),
                             _full(N, w_in, U.device))
    return _compress_dense_impl(dense, eps, r_out=r_out, rel=rel)


@obs.traced("algebra.round", cat="algebra")
def tlr_round(A, eps: float, r_max_out: int | None = None, *,
              rel: bool = False, batching: str = "flat"):
    """Recompress every off-diagonal tile of ``A`` (a ``TLRMatrix`` or
    ``TLRTiles``, of the same type out) at threshold ``eps``.

    One batched pass: factored QR + core SVD when ``A.r_max <= b``,
    densify-then-compress otherwise (rank-masked by ``A.ranks``). Ranks
    are monotone non-increasing in ``eps``; the output width is
    ``r_max_out`` (default ``min(A.r_max, b)``). ``batching="ranked"``
    recompresses each rank bucket at its own ladder width instead of
    ``r_max`` (rank-0 tiles skip the kernels); ``"auto"`` lets the rank
    histogram decide."""
    batching = resolve_batching(batching, A.ranks, A.r_max)
    b, r_in = A.b, A.r_max
    r_out = r_max_out or min(r_in, b)
    N = A.U.shape[0]
    if N == 0:
        z = A.U.new_zeros((0, b, r_out))
        return dataclasses.replace(A, U=z, V=z.clone(), ranks=torch.zeros(
            (0,), dtype=torch.int32, device=A.device))
    if batching == "ranked":
        U, V, ranks, _ = bucketed_round_tiles(A.U, A.V, A.ranks, eps,
                                              r_out=r_out, rel=rel)
        return dataclasses.replace(A, U=U, V=V, ranks=ranks)
    if r_in <= b:
        U, V, ranks, _ = _round_factors_impl(A.U, A.V, eps, r_out=r_out,
                                             rel=rel)
    else:
        dense = ops.batched_gemm(A.U, A.V.transpose(1, 2).contiguous(),
                                 A.ranks.contiguous())
        U, V, ranks, _ = _compress_dense_impl(dense, eps, r_out=r_out,
                                              rel=rel)
    return dataclasses.replace(A, U=U, V=V, ranks=ranks)


# -- structured ops -----------------------------------------------------------


def tlr_scale(alpha, A):
    """alpha * A (exact; scales diagonal tiles and left factors)."""
    alpha = alpha if isinstance(alpha, torch.Tensor) else float(alpha)
    return dataclasses.replace(A, D=alpha * A.D, U=alpha * A.U)


def tlr_axpy(alpha, A, B, eps=None, r_max_out=None, *,
             batching: str = "flat"):
    """alpha * A + B by low-rank concatenation, optionally rounded.

    Exact when ``eps`` is None: each tile becomes ``[alpha*U_A | U_B]
    [V_A | V_B]^T`` (r_max adds). The combined ``ranks`` are
    ``A.r_max + B.ranks``: the A-part's zero tail between ``rank_A`` and
    ``A.r_max`` sits *inside* the counted prefix, which is sound (zero
    columns are inert in every product) and keeps the "columns past ranks
    are zero" layout invariant; the next rounding pass compacts it away,
    and its rank buckets are built from these counts.
    ``A`` and ``B`` must share structure type, nb, and b.
    """
    if type(A) is not type(B) or A.nb != B.nb or A.b != B.b:
        raise ValueError(
            f"tlr_axpy needs matching structures, got {type(A).__name__}"
            f"(nb={A.nb}, b={A.b}) and {type(B).__name__}"
            f"(nb={B.nb}, b={B.b})")
    alpha = alpha if isinstance(alpha, torch.Tensor) else float(alpha)
    out = dataclasses.replace(
        A,
        D=alpha * A.D + B.D,
        U=torch.cat([alpha * A.U, B.U], dim=-1),
        V=torch.cat([A.V, B.V], dim=-1),
        ranks=(A.r_max + B.ranks).to(torch.int32),
    )
    if eps is not None:
        out = tlr_round(out, eps, r_max_out, batching=batching)
    return out


@lru_cache(maxsize=None)
def _transpose_perm(nb: int) -> np.ndarray:
    pairs = offd_pairs(nb)
    return _offd_index_np(pairs[:, 1], pairs[:, 0], nb)


def tlr_transpose(A):
    """A^T (exact). Identity for the symmetric ``TLRMatrix``; for
    ``TLRTiles`` the U/V roles swap and tiles move to mirrored slots."""
    if isinstance(A, TLRMatrix):
        return A
    perm = torch.as_tensor(_transpose_perm(A.nb), device=A.device)
    return TLRTiles(D=A.D.transpose(1, 2).contiguous(), U=A.V[perm],
                    V=A.U[perm], ranks=A.ranks[perm])


def tlr_add_diag(A, diag):
    """Dense add onto the diagonal tiles: ``diag`` is a scalar (alpha * I)
    or a (nb, b, b) stack of dense tiles."""
    diag = torch.as_tensor(diag, dtype=A.dtype, device=A.device)
    if diag.dim() == 0:
        add = diag * torch.eye(A.b, dtype=A.dtype, device=A.device)[None]
    elif diag.shape == A.D.shape:
        add = diag
    else:
        raise ValueError(
            f"diag must be scalar or shape {tuple(A.D.shape)}, got "
            f"{tuple(diag.shape)}")
    return dataclasses.replace(A, D=A.D + add)


# -- low-rank x low-rank term sums (shared by GEMM and SYRK) ------------------


def _lrlr_dense_sum(Ua, Va, Ub, Vb, ranks_a) -> torch.Tensor:
    """sum_k Ua_k (Va_k^T Ub_k) Vb_k^T as dense (N, b, b), fully batched.

    Inputs are (N, K, b, r*) term stacks. The per-term chains are flat
    batched GEMMs; the K-reduction is one wide GEMM over the concatenated
    width K*rb (the "concat the factors, multiply once" form).
    """
    N, K, b, ra = Ua.shape
    rb = Ub.shape[-1]
    if K == 0 or N == 0:
        return Ua.new_zeros((N, b, b))
    NK = N * K
    dev = Ua.device
    W = ops.batched_gemm(Va.reshape(NK, b, ra).transpose(1, 2).contiguous(),
                         Ub.reshape(NK, b, rb).contiguous(),
                         _full(NK, b, dev))                  # (NK, ra, rb)
    P = ops.batched_gemm(Ua.reshape(NK, b, ra).contiguous(), W,
                         ranks_a.reshape(NK).to(torch.int32).contiguous())
    # (reshape copies here, but returns a view where the strides allow it,
    # as with rb = 1; the kernel takes contiguous operands)
    Pc = P.reshape(N, K, b, rb).transpose(1, 2).reshape(N, b, K * rb)
    Vct = Vb.transpose(2, 3).reshape(N, K * rb, b)           # Vc^T
    return ops.batched_gemm(Pc.contiguous(), Vct.contiguous(),
                            _full(N, K * rb, dev))


def _chunk_tiles(K: int, b: int, ra: int, rb: int, itemsize: int) -> int:
    """Output tiles per chunk of a K-term accumulation: as many as the
    term workspace of :func:`_lrlr_dense_sum` (four gathered stacks, the
    transposed V stack, W, P and the two concatenated operands) fits in
    ``GEMM_CHUNK_BYTES``; at least one."""
    per_tile = (K * (3 * b * ra + 2 * b * rb + ra * rb + 3 * b * rb)
                + b * b) * itemsize
    return max(1, GEMM_CHUNK_BYTES // per_tile)


def _add_lrlr_chunked(out, slots, gather, K: int, ra: int, rb: int,
                      alpha: float = 1.0) -> None:
    """``out[slots[t]] += alpha * sum_k`` of output ``t``'s K low-rank
    terms, over chunks of output tiles; ``gather(t0, t1)`` returns the
    term stacks ``(Ua, Va, Ub, Vb, ranks_a)`` of outputs ``t0 .. t1 - 1``.
    (``alpha = -1`` subtracts exactly: ``a + (-1) s`` is ``a - s``.)"""
    N = slots.shape[0]
    step = _chunk_tiles(K, out.shape[1], ra, rb, out.element_size())
    for t0 in range(0, N, step):
        t1 = min(t0 + step, N)
        out.index_add_(0, slots[t0:t1], _lrlr_dense_sum(*gather(t0, t1)),
                       alpha=alpha)


def gemm_chunks(nb: int, b: int, wa: int, wb: int,
                dtype=torch.float64) -> int:
    """Chunks of ``tlr_gemm``'s off-diagonal middle-term accumulation for
    an ``nb``-tile grid at operand widths ``wa`` / ``wb``."""
    if nb < 3:
        return 0
    itemsize = torch.empty((), dtype=dtype).element_size()
    no = nb * (nb - 1)
    return -(-no // _chunk_tiles(nb - 2, b, wa, wb, itemsize))


# -- TLR x TLR GEMM -----------------------------------------------------------


@lru_cache(maxsize=None)
def _gemm_indices(nb: int):
    """Gather grids for the GEMM accumulation (host side, once per nb).

    For off-diagonal output (i, j): the ``nb - 2`` middle slots
    ``A(i, m), B(m, j)`` for m not in {i, j} (its own slot in A and B is
    its own index: the packed order is the same). For diagonal output i:
    the ``nb - 1`` middle slots ``A(i, m), B(m, i)``.
    """
    pairs = offd_pairs(nb)
    oi, oj = pairs[:, 0], pairs[:, 1]
    m = np.broadcast_to(np.arange(nb), (len(pairs), nb))
    mids = m[(m != oi[:, None]) & (m != oj[:, None])].reshape(
        len(pairs), max(nb - 2, 0))
    mid_a = _offd_index_np(oi[:, None], mids, nb)
    mid_b = _offd_index_np(mids, oj[:, None], nb)
    d = np.arange(nb)[:, None]
    dm = np.broadcast_to(np.arange(nb), (nb, nb))
    dmids = dm[dm != d].reshape(nb, nb - 1)
    dmid_a = _offd_index_np(d, dmids, nb)
    dmid_b = _offd_index_np(dmids, d, nb)
    return oi, oj, mid_a, mid_b, dmid_a, dmid_b


@lru_cache(maxsize=16)
def _gemm_indices_on(nb: int, device: torch.device):
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device)
                 for x in _gemm_indices(nb))


def _gemm_core(Da, Ua, Va, ranks_a, Db, Ub, Vb, eps: float, *, nb: int,
               r_out: int, rel: bool):
    """The whole TLR x TLR product: dense accumulation of every output
    tile, then one compression pass over all off-diagonal tiles."""
    b, dev = Da.shape[1], Da.device
    oi, oj, mid_a, mid_b, dmid_a, dmid_b = _gemm_indices_on(nb, dev)
    no = oi.shape[0]
    wa, wb = Ua.shape[-1], Ub.shape[-1]

    def terms(ia, ib):
        return lambda t0, t1: (Ua[ia[t0:t1]], Va[ia[t0:t1]], Ub[ib[t0:t1]],
                               Vb[ib[t0:t1]], ranks_a[ia[t0:t1]])

    # dense diagonal of C: D_A(i) D_B(i) + sum_{m != i} lr x lr
    Dc = ops.batched_gemm(Da, Db, _full(nb, b, dev))
    if nb > 1:
        _add_lrlr_chunked(Dc, torch.arange(nb, device=dev),
                          terms(dmid_a, dmid_b), nb - 1, wa, wb)
    if no == 0:
        z = Da.new_zeros((0, b, r_out))
        return Dc, z, z.clone(), torch.zeros((0,), dtype=torch.int32,
                                             device=dev)

    # off-diagonal C(i, j), dense-accumulated from its nb inner products:
    #   k == i : D_A(i) B(i,j)           k == j : A(i,j) D_B(j)
    #   else   : A(i,k) B(k,j) low-rank chains, concatenated K-reduction
    Udl = ops.batched_gemm(Da[oi], Ub, _full(no, b, dev))
    Vld = ops.batched_gemm(Db[oj].transpose(1, 2).contiguous(), Va,
                           _full(no, b, dev))
    C = ops.batched_gemm(torch.cat([Udl, Ua], dim=-1),
                         torch.cat([Vb, Vld], dim=-1).transpose(1, 2)
                         .contiguous(), _full(no, wb + wa, dev))
    del Udl, Vld
    if nb > 2:
        _add_lrlr_chunked(C, torch.arange(no, device=dev),
                          terms(mid_a, mid_b), nb - 2, wa, wb)
    U, V, ranks, _ = _compress_dense_impl(C, eps, r_out=r_out, rel=rel)
    return Dc, U, V, ranks


def _as_tiles(X) -> TLRTiles:
    if isinstance(X, TLRTiles):
        return X
    if isinstance(X, TLRMatrix):
        return generalize(X)
    A = getattr(X, "A", None)  # TLROperator facade
    if isinstance(A, TLRMatrix):
        return generalize(A)
    raise TypeError(f"expected TLRMatrix / TLRTiles / TLROperator, "
                    f"got {type(X).__name__}")


@obs.traced("algebra.gemm", cat="algebra")
def tlr_gemm(A, B, eps: float, r_max_out: int | None = None, *,
             rel: bool = False, batching: str = "flat") -> TLRTiles:
    """C = A @ B for TLR operands, compressed at ``eps``.

    ``A`` / ``B`` are ``TLRMatrix`` (mirrored onto the general grid),
    ``TLRTiles`` or ``TLROperator``. Every output tile accumulates its
    ``nb`` inner products as batched low-rank chains (middle terms in
    chunks of output tiles, ``GEMM_CHUNK_BYTES``), then a single rounding
    pass compresses all ``nb*(nb-1)`` output tiles at
    ``r_max_out`` (default ``min(max r_max, b)``).

    ``batching="ranked"``: each operand's factor stacks are sliced to the
    rank-ladder width covering its *actual* ranks before the accumulation
    (exact -- columns past each rank are zero), so every chain and the
    concatenated K-reduction run at the bucketed width instead of
    ``r_max``.
    """
    Ga, Gb = _as_tiles(A), _as_tiles(B)
    if Ga.nb != Gb.nb or Ga.b != Gb.b:
        raise ValueError(f"tlr_gemm needs matching grids, got "
                         f"(nb={Ga.nb}, b={Ga.b}) and (nb={Gb.nb}, b={Gb.b})")
    batching = resolve_batching(
        batching, torch.cat([Ga.ranks.reshape(-1), Gb.ranks.reshape(-1)]),
        max(Ga.r_max, Gb.r_max))
    r_out = r_max_out or min(max(Ga.r_max, Gb.r_max), Ga.b)
    Ua, Va, Ub, Vb = Ga.U, Ga.V, Gb.U, Gb.V
    if batching == "ranked" and Ua.shape[0]:
        wa = bucket_width(Ga.ranks, Ga.r_max)
        wb = bucket_width(Gb.ranks, Gb.r_max)
        Ua, Va = Ua[:, :, :wa], Va[:, :, :wa]
        Ub, Vb = Ub[:, :, :wb], Vb[:, :, :wb]
    # Factors stored in a lower precision are promoted to the working one.
    Ua, Va, Ub, Vb = (x.to(Ga.D.dtype).contiguous()
                      for x in (Ua, Va, Ub, Vb))
    # Under a tile mesh every rank computes the whole product (each output
    # tile reads a whole row and column of the operands), so of the JAX
    # package's sharding of the generalized factors only the mesh's
    # indivisibility mode applies: "error" raises, and "pad"'s zero tiles
    # would never be read.
    tile_batch_rows(Ua.shape[0])
    Dc, U, V, ranks = _gemm_core(
        Ga.D.contiguous(), Ua, Va, Ga.ranks, Gb.D.contiguous(), Ub, Vb,
        eps, nb=Ga.nb, r_out=r_out, rel=rel)
    return TLRTiles(D=Dc, U=U, V=V, ranks=ranks)


# -- symmetric SYRK update  C = A - L L^T -------------------------------------


@lru_cache(maxsize=None)
def _syrk_buckets(nb: int):
    """Bucket the symmetric-update accumulation on the power-of-two ladder.

    Output tiles are all (i, j) with i >= j (packed lower first, then the
    nb diagonal slots appended at offset nt). Tile (i, j) sums ``j``
    low-rank inner products L(i,k) L(j,k)^T, k < j; tiles are grouped by
    ``bucket_up(j)``, so ~log2(nb) term counts occur. Returns a list of
    (out_slots, a_idx (N, Kb), b_idx (N, Kb), valid (N, Kb)) groups.
    """
    nt = nb * (nb - 1) // 2
    outs = [(int(i), int(j)) for i, j in tril_pairs(nb)]
    outs += [(i, i) for i in range(nb)]
    slots = list(range(nt)) + [nt + i for i in range(nb)]
    ladder = _bucket_ladder(nb - 1)
    groups = {}
    for slot, (i, j) in zip(slots, outs):
        if j == 0:
            continue  # no k < j terms; handled by the uniform parts
        Kb = _bucket_up(j, ladder)
        groups.setdefault(Kb, []).append((slot, i, j))
    out = []
    for Kb, members in sorted(groups.items()):
        N = len(members)
        sl = np.asarray([m[0] for m in members], np.int64)
        a_idx = np.zeros((N, Kb), np.int64)
        b_idx = np.zeros((N, Kb), np.int64)
        valid = np.zeros((N, Kb), bool)
        for t, (_, i, j) in enumerate(members):
            for k in range(j):
                a_idx[t, k] = tril_index(i, k)
                b_idx[t, k] = tril_index(j, k)
            valid[t, :j] = True
        out.append((sl, a_idx, b_idx, valid))
    return out


@obs.traced("algebra.syrk", cat="algebra")
def tlr_syrk(A: TLRMatrix, L: TLRMatrix, eps: float,
             r_max_out: int | None = None, *, rel: bool = False,
             batching: str = "flat") -> TLRMatrix:
    """Symmetric Schur update ``C = A - L L^T`` (lower-triangular TLR L).

    Each output tile (i, j), i >= j, subtracts ``j`` low-rank inner
    products (term counts on the bucket ladder, accumulated in chunks of
    output tiles) plus the ``k == j`` diagonal-block term; all nt
    off-diagonal results are compressed in one rounding pass. ``L.D``
    holds the dense diagonal blocks L(k, k).

    ``batching="ranked"``: L's factor stacks are sliced to the rank-ladder
    width covering its actual ranks (exact).
    """
    if A.nb != L.nb or A.b != L.b:
        raise ValueError(f"tlr_syrk needs matching grids, got "
                         f"(nb={A.nb}, b={A.b}) and (nb={L.nb}, b={L.b})")
    batching = resolve_batching(
        batching, torch.cat([A.ranks.reshape(-1), L.ranks.reshape(-1)]),
        max(A.r_max, L.r_max))
    nb, b, dev = A.nb, A.b, A.device
    nt = nb * (nb - 1) // 2
    r_out = r_max_out or min(max(A.r_max, L.r_max), b)
    UL, VL = L.U, L.V
    if batching == "ranked" and nt:
        wl = bucket_width(L.ranks, L.r_max)
        UL, VL = UL[:, :, :wl].contiguous(), VL[:, :, :wl].contiguous()
    wl = UL.shape[-1]

    # dense accumulation buffer: packed lower tiles, then the nb diagonals
    acc = A.D.new_zeros((nt + nb, b, b))
    if nt:
        acc[:nt] = ops.batched_gemm(A.U.to(A.dtype),
                                    A.V.transpose(1, 2).to(A.dtype)
                                    .contiguous(),
                                    A.ranks)
    acc[nt:] = A.D

    # k == j terms, uniform across outputs: off-diag L(i,j) D_j^T (one
    # batched chain over all nt lower tiles), diagonal D_i D_i^T
    if nt:
        jj = torch.as_tensor(tril_pairs(nb)[:, 1], device=dev)
        DV = ops.batched_gemm(L.D[jj], VL, _full(nt, b, dev))
        acc[:nt] -= ops.batched_gemm(UL, DV.transpose(1, 2).contiguous(),
                                     L.ranks)
    acc[nt:] -= ops.batched_gemm(L.D, L.D.transpose(1, 2).contiguous(),
                                 _full(nb, b, dev))

    # k < j terms: bucket-laddered accumulation (term = U_ik (V_ik^T V_jk)
    # U_jk^T), subtracted
    for sl, a_h, b_h, valid_h in _syrk_buckets(nb):
        a_idx, b_idx, valid = (torch.as_tensor(x, device=dev)
                               for x in (a_h, b_h, valid_h))

        def gather(t0, t1, a_idx=a_idx, b_idx=b_idx, valid=valid):
            a, bb = a_idx[t0:t1], b_idx[t0:t1]
            return (UL[a] * valid[t0:t1, :, None, None], VL[a], VL[bb],
                    UL[bb], L.ranks[a])
        _add_lrlr_chunked(acc, torch.as_tensor(sl, device=dev), gather,
                          a_h.shape[1], wl, wl, alpha=-1.0)

    if nt:
        U, V, ranks, _ = _compress_dense_impl(acc[:nt].contiguous(), eps,
                                              r_out=r_out, rel=rel)
    else:
        U = A.U.new_zeros((0, b, r_out))
        V = U.clone()
        ranks = torch.zeros((0,), dtype=torch.int32, device=dev)
    return TLRMatrix(D=acc[nt:].contiguous(), U=U, V=V, ranks=ranks)


# -- column-scoped SYRK: the right-looking trailing update ---------------------


@lru_cache(maxsize=None)
def _syrk_column_pairs(nb: int, k: int):
    """Column ``k``'s trailing pairs: local rows ``(a, c)``, a > c (rows
    ``k+1+a`` and ``k+1+c``), and the packed-lower index of each pair's
    tile, in packed order."""
    pairs = tril_pairs(nb - 1 - k)
    a, c = pairs[:, 0], pairs[:, 1]
    i, j = k + 1 + a, k + 1 + c
    return i * (i - 1) // 2 + j, a, c


@obs.traced("algebra.syrk_column", cat="algebra")
def tlr_syrk_column(accU: torch.Tensor, accV: torch.Tensor, used,
                    D: torch.Tensor, Up: torch.Tensor, Vn: torch.Tensor,
                    ranks: torch.Tensor, dk, k: int, *,
                    part: str = "all", rows: range | None = None) -> None:
    """Column-scoped SYRK: apply factor column ``k``'s trailing Schur
    update ``A(i,j) -= L(i,k) D_k L(j,k)^T`` for all i >= j > k, in place.

    Off-diagonal trailing tiles get ``-U_i (Vn_i^T D_k Vn_j) U_j^T`` as the
    factor pair ``(-U_i G, U_j)`` appended at each tile's write offset of
    the ``(nt, b, W)`` accumulation buffers ``accU`` / ``accV``; the
    trailing diagonal tiles of ``D`` (nb, b, b) subtract their dense
    ``L(j,k) D_k L(j,k)^T``. ``Up`` / ``Vn`` / ``ranks`` are column k's
    factored panel, row i at slot ``i - k - 1``; ``dk`` is column k's
    LDL^T diagonal (b,) or None for Cholesky.

    ``used`` is the write offset: a scalar first-free column (flat
    batching: uniform over the live trailing tiles) or a per-tile (nt,)
    host array of content widths (ranked batching: each tile's
    concatenation stays compact, and its append lands at its own width).

    ``part`` splits the update for the lookahead schedule: ``"head"``
    applies only the tiles ``(i, k+1)`` and ``D[k+1]`` (what column ``k+1``
    needs before its own panel can factor), ``"tail"`` the rest (tiles
    ``(i, j)`` with ``j > k+1`` and the trailing diagonals past ``k+1``);
    ``"head"`` then ``"tail"`` is exactly one ``"all"`` call -- each
    trailing tile receives its single term from exactly one of the two, at
    the same offset, by the same arithmetic. Each part writes only its own
    tiles, so a ``"tail"`` on a second CUDA stream can run beside a reader
    of column ``k+1``'s tiles.

    The JAX package returns new arrays (a donated jit that adds a rolled,
    zero-padded block at each tile's offset). Here a scalar offset is an
    ``index_add_`` into the ``[used, used + r)`` column window; per-tile
    offsets add into each live tile's own window (every live trailing tile
    appears once in the pair grid, so the indexed add is exact); the
    diagonal update is an ``index_add_`` into ``D``. All in place, on the
    current CUDA stream, with one host-to-device copy of the indices that
    does not block the host.

    ``rows`` is the block of global tiles that ``accU`` / ``accV`` hold
    (a tile mesh's local rows, from the right driver): only those tiles
    get their appends, while ``D`` is updated whole on every rank. Without
    it the buffers hold every tile, under the installed mesh's
    indivisibility mode.

    The scalar branch stays because it is the faster of the two for a flat
    offset: over the 63 appends of the flat right driver at N = 8192, tile
    128, it takes 0.104 s against 0.181 s for the same offset as a per-tile
    array (the indexed add gathers, adds and scatters each window), with
    bitwise-equal buffers (``tools/syrk_append.py``, NVIDIA H100 80GB
    HBM3, 700 W).
    """
    if part not in ("all", "head", "tail"):
        raise ValueError(f"part must be 'all', 'head' or 'tail', got "
                         f"{part!r}")
    nb = D.shape[0]
    T = nb - 1 - k
    if T <= 0:
        return
    r_p = Up.shape[-1]
    b, w_acc = accU.shape[1], accU.shape[-1]
    o, a, c = _syrk_column_pairs(nb, k)
    dslots = np.arange(T)
    if part != "all":
        sel = (c == 0) if part == "head" else (c >= 1)
        o, a, c = o[sel], a[sel], c[sel]
        dslots = dslots[:1] if part == "head" else dslots[1:]
    # The overflow check sees only the tiles this part appends to (after a
    # "head" call bumped its tiles' widths, the full-grid max would
    # spuriously overflow for the following "tail").
    per_tile = np.ndim(used) != 0
    if per_tile:
        u = np.asarray(used)
        high = int(u[o].max()) if o.size else 0
        cols = (u[o][:, None] + np.arange(r_p)[None, :]).reshape(-1)
    else:
        high = int(used)
        cols = np.zeros(0, np.int64)
    if high + r_p > w_acc:
        raise ValueError(
            f"no room for a rank-{r_p} append at column {high} of the "
            f"width-{w_acc} accumulation buffers; round first "
            f"(tlr_round_tiles)")
    if rows is None:
        tile_batch_rows(accU.shape[0], preserve_shape=True)
    else:
        mine = (o >= rows.start) & (o < rows.stop)
        o, a, c = o[mine] - rows.start, a[mine], c[mine]
        if per_tile:
            cols = cols.reshape(-1, r_p)[mine].reshape(-1)
    n, nd = len(o), len(dslots)
    if n + nd == 0:
        return
    idx = to_device(np.concatenate([o, a, c, dslots, cols]).astype(
        np.int64), D.device)
    ot, at, ct = idx[:n], idx[n:2 * n], idx[2 * n:3 * n]
    dt = idx[3 * n:3 * n + nd]
    Vs = Vn if dk is None else Vn * dk[None, :, None]
    if n:
        G = Vs[at].transpose(1, 2) @ Vn[ct]                     # (n, r, r)
        left = -ops.batched_gemm(Up[at], G.contiguous(),
                                 ranks[at].contiguous())
        right = Up[ct]
        if per_tile:
            cw = idx[3 * n + nd:].view(n, 1, r_p)
            rows = torch.arange(b, device=D.device)[None, :, None]
            accU[ot[:, None, None], rows, cw] += left
            accV[ot[:, None, None], rows, cw] += right
        else:
            used = int(used)
            accU[:, :, used:used + r_p].index_add_(0, ot, left)
            accV[:, :, used:used + r_p].index_add_(0, ot, right)
    Ud = Up[dt]
    upd = (Ud @ (Vs[dt].transpose(1, 2) @ Vn[dt])) @ Ud.transpose(1, 2)
    D.index_add_(0, dt + (k + 1), -upd)
