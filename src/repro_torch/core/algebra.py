"""The rounding pass and the column-scoped SYRK of the TLR tile algebra.

Port of the rounding core of ``repro/core/algebra.py`` (:254-420) and its
column-scoped SYRK (:764-1000):

* ``tlr_round_tiles`` -- recompress a stack of accumulated tile factors
  ``U V^T`` in one batched pass: factored (``batched_qr`` of both sides,
  ``small_svd`` of the ``r x r`` core ``R_u R_v^T``) when the width is at
  most the tile size b, densify-then-compress (``batched_gemm`` to the
  ``b x b`` tile, ``batched_qr``, ``small_svd`` of R) when it is wider.
  Singular values ``> eps`` (absolute, or ``> eps * s_max`` with ``rel``)
  are kept, so a zero tile has rank 0. ``batching="ranked"`` (or ``"auto"``
  resolving to it) runs the pass once per rank bucket at the bucket's
  ladder width (``core/batching.py``).
* ``tlr_round`` -- the same pass over every off-diagonal tile of a
  ``TLRMatrix``.
* ``tlr_syrk_column`` -- the right-looking factorization's trailing update
  for one factored column: every trailing tile receives the column's rank-r
  outer product as an appended factor pair (at one shared column, or at
  each tile's own content width under ranked batching), every trailing
  diagonal tile the dense product.

The QR, SVD and GEMM work runs in the port's kernels (``kernels/ops``): the
CUDA kernels on the card, their plain versions on the CPU. Not ported yet:
the ``head`` / ``tail`` split of the SYRK (lookahead; raises
``NotImplementedError``), ``TLRTiles`` and the rest of the algebra (GEMM,
SYRK, axpy, Newton-Schulz).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .batching import bucketed_round_tiles, resolve_batching
from .buckets import _bucket_ladder, _bucket_up, _pad_axis
from .tlr import TLRMatrix, tril_pairs
from ..kernels import ops


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


def tlr_round(A: TLRMatrix, eps: float, r_max_out: int | None = None, *,
              rel: bool = False, batching: str = "flat") -> TLRMatrix:
    """Recompress every off-diagonal tile of ``A`` at threshold ``eps``.

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


# -- column-scoped SYRK: the right-looking trailing update ---------------------


@lru_cache(maxsize=None)
def _syrk_column_indices(nb: int, k: int, Tb: int):
    """Gather grids for column ``k``'s trailing update, padded to the
    ``Tb``-row bucket. Slots map local trailing-row pairs ``(a, c)``, a > c
    (rows ``k+1+a`` and ``k+1+c``), to packed-lower tile indices; padded
    slots carry ``valid=False`` and point at tile / block 0, where the
    update adds exact zeros."""
    T = nb - 1 - k
    pairs = tril_pairs(Tb)
    a, c = pairs[:, 0], pairs[:, 1]
    valid = a < T
    i, j = k + 1 + a, k + 1 + c
    oidx = np.where(valid, i * (i - 1) // 2 + j, 0)
    ar = np.arange(Tb)
    didx = np.where(ar < T, k + 1 + ar, 0)
    return oidx, a, c, valid, didx, ar < T


def tlr_syrk_column(accU: torch.Tensor, accV: torch.Tensor, used,
                    D: torch.Tensor, Up: torch.Tensor, Vn: torch.Tensor,
                    ranks: torch.Tensor, dk, k: int, *,
                    part: str = "all") -> None:
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

    The JAX package returns new arrays (a donated jit that adds a rolled,
    zero-padded block at each tile's offset). Here a scalar offset is an
    ``index_add_`` into the ``[used, used + r)`` column window; per-tile
    offsets add into each live tile's own window (every live trailing tile
    appears once in the pair grid, so the indexed add is exact); the
    diagonal update is an ``index_add_`` into ``D``. All in place.

    The scalar branch stays because it is the faster of the two for a flat
    offset: over the 63 appends of the flat right driver at N = 8192, tile
    128, it takes 0.104 s against 0.181 s for the same offset as a per-tile
    array (the indexed add gathers, adds and scatters each window), with
    bitwise-equal buffers (``tools/syrk_append.py``, NVIDIA H100 80GB
    HBM3, 700 W).
    """
    if part in ("head", "tail"):
        raise NotImplementedError(f"part={part!r} (the lookahead split) is "
                                  "not ported; use part='all'")
    if part != "all":
        raise ValueError(f"part must be 'all', 'head' or 'tail', got "
                         f"{part!r}")
    nb = D.shape[0]
    T = nb - 1 - k
    if T <= 0:
        return
    r_p = Up.shape[-1]
    w_acc = accU.shape[-1]
    Tb = _bucket_up(T, _bucket_ladder(nb - 1))
    oidx_h, aidx_h, cidx_h, valid_h, didx_h, dvalid_h = \
        _syrk_column_indices(nb, k, Tb)
    per_tile = np.ndim(used) != 0
    if per_tile:
        u = np.asarray(used)
        live = oidx_h[valid_h]
        high = int(u[live].max()) if live.size else 0
    else:
        high = int(used)
    if high + r_p > w_acc:
        raise ValueError(
            f"no room for a rank-{r_p} append at column {high} of the "
            f"width-{w_acc} accumulation buffers; round first "
            f"(tlr_round_tiles)")
    oidx, aidx, cidx, valid, didx, dvalid = (
        torch.as_tensor(x, device=D.device)
        for x in (oidx_h, aidx_h, cidx_h, valid_h, didx_h, dvalid_h))
    Up, Vn, ranks = (_pad_axis(x, Tb) for x in (Up, Vn, ranks))
    Vs = Vn if dk is None else Vn * dk[None, :, None]
    G = torch.einsum("tbr,tbq->trq", Vs[aidx], Vn[cidx])
    left = -ops.batched_gemm(Up[aidx], G.contiguous(), ranks[aidx].contiguous())
    m = valid[:, None, None]
    left = torch.where(m, left, torch.zeros_like(left))
    right = torch.where(m, Up[cidx], torch.zeros_like(left))
    if per_tile:
        sel = np.nonzero(valid_h)[0]
        o = oidx_h[sel]
        dev = D.device
        cols = (torch.as_tensor(u[o], device=dev)[:, None, None]
                + torch.arange(r_p, device=dev)[None, None, :])
        rows = torch.arange(accU.shape[1], device=dev)[None, :, None]
        ot = torch.as_tensor(o, device=dev)[:, None, None]
        st = torch.as_tensor(sel, device=dev)
        accU[ot, rows, cols] += left[st]
        accV[ot, rows, cols] += right[st]
    else:
        used = int(used)
        accU[:, :, used:used + r_p].index_add_(0, oidx, left)
        accV[:, :, used:used + r_p].index_add_(0, oidx, right)
    Gd = torch.einsum("tbr,tbq->trq", Vs, Vn)
    upd = torch.einsum("tbr,trq,tcq->tbc", Up, Gd, Up)
    upd = torch.where(dvalid[:, None, None], upd, torch.zeros_like(upd))
    D.index_add_(0, didx, -upd)
