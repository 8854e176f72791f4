"""TLR matrix-vector products and triangular solves (section 4.4, Alg. 7),
log-determinant, MVN sampling and preconditioned conjugate gradients.

Port of the read paths of ``repro/core/solve.py`` (:47-390, :443-478),
its ``pcg`` (:492-648) and the batched-RHS engine ``BatchedPCG`` behind
``pcg``'s 2-D route and the server (:651-941).
Every read path dispatches through the :class:`~.batching.TilePlan` layer:
the matvec marshals the off-diagonal tiles into batched two-product chains
``U (V^T x)`` plus a segment reduction (``index_add_``), either as one flat
r_max-wide batch (``batching="flat"``) or once per rank bucket at the
bucket's ladder width (``batching="ranked"``); ``"auto"`` (the default, as
in the JAX package) lets the plan's rank histogram decide.

The triangular solve is the blocked TRSM of the JAX package: each column
step solves the diagonal block and updates the remaining blocks through a
batched low-rank chain whose row batch is zero-padded up to the
power-of-two bucket ladder, so only ~log2(nb) step shapes occur. Under
ranked batching each step also slices its U/V gathers to the plan width of
its row-bucket interval. Right-hand sides may be single vectors ``(n,)`` or
batched ``(n, m)``. The chains are stock torch products: in the JAX
package they are einsums outside any Pallas kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import obs
from ..device import numpy_dtype, resolve_device
from .batching import plan_memo, resolve_batching, tile_plan
from .buckets import _bucket_ladder, _bucket_up, trace_event
from .tlr import TLRMatrix, tril_index, tril_pairs


@lru_cache(maxsize=32)
def _pair_index(nb: int, device: torch.device):
    pairs = torch.as_tensor(tril_pairs(nb), device=device)
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()


def _chain(U, V, x):
    """``U (V^T x)`` per tile; x is (t, b) or (t, b, m). Factors stored
    in a lower precision (``compress(store_dtype=)``) are promoted to the
    product's precision first (no copy when they already have it)."""
    dt = torch.promote_types(U.dtype, x.dtype)
    U, V = U.to(dt), V.to(dt)
    if x.dim() == 2:
        return (U @ (V.transpose(1, 2) @ x[..., None]))[..., 0]
    return U @ (V.transpose(1, 2) @ x)


def _diag_apply(D, xb, trans: bool = False):
    Dt = D.transpose(1, 2) if trans else D
    if xb.dim() == 2:
        return (Dt @ xb[..., None])[..., 0]
    return Dt @ xb


# -- rank-bucketed read-path chains (TilePlan consumers) ------------------------


def _plan_trace(U, xb, idx, w: int) -> None:
    trace_event("plan", (tuple(U.shape), tuple(xb.shape), idx.shape[0], w,
                         str(U.dtype), U.device.type))


def _plan_chain(U, V, xb, yb, idx, src, dst, valid, w: int) -> None:
    """One rank bucket of a one-sided product, in place on ``yb``:
    ``y[dst] += U (V^T x[src])`` at the bucket's ladder width ``w`` (exact:
    factor columns past each tile's rank are zero). Padded slots gather
    tile 0 / block 0 and are masked to an exact zero."""
    _plan_trace(U, xb, idx, w)
    y = _chain(U[:, :, :w][idx], V[:, :, :w][idx], xb[src])
    m = valid.reshape((-1,) + (1,) * (y.dim() - 1))
    yb.index_add_(0, dst, torch.where(m, y, torch.zeros_like(y)))


def _plan_chain_sym(U, V, xb, yb, idx, rows, cols, valid, w: int) -> None:
    """One rank bucket of the symmetric product, in place on ``yb``: the
    lower chain ``y_i += U (V^T x_j)`` and its mirror ``y_j += V (U^T x_i)``
    share one gather of the bucket's factors."""
    _plan_trace(U, xb, idx, w)
    Ut, Vt = U[:, :, :w][idx], V[:, :, :w][idx]
    ylo = _chain(Ut, Vt, xb[cols])
    yup = _chain(Vt, Ut, xb[rows])
    m = valid.reshape((-1,) + (1,) * (ylo.dim() - 1))
    yb.index_add_(0, rows, torch.where(m, ylo, torch.zeros_like(ylo)))
    yb.index_add_(0, cols, torch.where(m, yup, torch.zeros_like(yup)))


def _bucket_index_arrays(bk, device, *gathers):
    """Pad a bucket's gather/scatter index vectors to its count-ladder slot
    count, plus the valid mask (padded slots point at index 0, masked), as
    device tensors."""
    out = []
    for g in gathers:
        full = np.zeros(bk.padded, np.int64)
        full[:bk.count] = g
        out.append(torch.as_tensor(full, device=device))
    valid = np.zeros(bk.padded, bool)
    valid[:bk.count] = True
    out.append(torch.as_tensor(valid, device=device))
    return tuple(out)


def _plan_gathers(plan, nb: int, device):
    """Per-bucket padded ``(idx, rows, cols, valid)`` device tensors,
    memoized on the plan (:func:`~.batching.plan_memo`)."""
    def make():
        pairs = tril_pairs(nb)
        return [_bucket_index_arrays(bk, device, bk.idx, pairs[bk.idx, 0],
                                     pairs[bk.idx, 1])
                for bk in plan.buckets]
    return plan_memo(plan, ("gathers", nb, torch.device(device)), make)


# -- symmetric TLR matvec ------------------------------------------------------


def tlr_matvec(A: TLRMatrix, x: torch.Tensor, *,
               batching: str | None = "auto") -> torch.Tensor:
    """y = A @ x for symmetric TLR A; x is (n,) or (n, m).

    ``batching="ranked"`` runs the two-product chains per rank bucket of
    the memoized :func:`~.batching.tile_plan` (each bucket at its own
    ladder width, rank-0 tiles skipped); ``"flat"`` is the single
    r_max-wide batch; ``"auto"`` (default) applies the rank-histogram
    policy."""
    nb, b = A.nb, A.b
    xb = x.reshape(nb, b, *x.shape[1:])
    yb = _diag_apply(A.D, xb)
    if nb == 1:
        return yb.reshape(x.shape)
    if resolve_batching(batching, A.ranks, A.r_max) == "ranked":
        plan = tile_plan(A.ranks, A.r_max)
        for bk, (idx, rows, cols, valid) in zip(
                plan.buckets, _plan_gathers(plan, nb, xb.device)):
            attrs = {}
            if obs.enabled():
                # Symmetric chain: both orientations per tile, 2 GEMMs each.
                attrs = _chain_span_attrs(plan, bk, b, xb, sym=True)
            with obs.span("matvec.bucket", cat="solve", **attrs):
                _plan_chain_sym(A.U, A.V, xb, yb, idx, rows, cols, valid,
                                bk.width)
    else:
        rows, cols = _pair_index(nb, xb.device)
        # lower tiles: y_i += U (V^T x_j);   mirrored upper: y_j += V (U^T x_i)
        yb.index_add_(0, rows, _chain(A.U, A.V, xb[cols]))
        yb.index_add_(0, cols, _chain(A.V, A.U, xb[rows]))
    return yb.reshape(x.shape)


def _chain_span_attrs(plan, bk, b: int, xb, sym: bool) -> dict:
    """Telemetry attributes for one bucket of a two-product read chain
    (enabled mode only): ``2 * 2*b*w*m`` FLOPs per dispatched tile-product
    slot (V^T x then U y, ``m`` rhs columns; doubled again for the
    symmetric chain's mirrored product), useful scaled by true rank mass."""
    m = 1
    for d in xb.shape[2:]:
        m *= int(d)
    per_col = (8 if sym else 4) * b * m
    return {"width": bk.width, "count": bk.count, "padded": bk.padded,
            "flops": float(per_col) * float(plan.ranks_host[bk.idx].sum()),
            "flops_padded": float(per_col) * float(bk.padded * bk.width)}


# -- lower-triangular TLR products / solves -------------------------------------


def tlr_tri_matvec(L: TLRMatrix, x: torch.Tensor, *, trans: bool = False,
                   batching: str | None = "auto") -> torch.Tensor:
    """y = L @ x (or L^T @ x) for lower-triangular TLR L. Same ``batching``
    dispatch as :func:`tlr_matvec` (the transposed product swaps the U/V
    roles inside each bucket chain)."""
    nb, b = L.nb, L.b
    xb = x.reshape(nb, b, *x.shape[1:])
    yb = _diag_apply(L.D, xb, trans)
    if nb == 1:
        return yb.reshape(x.shape)
    if resolve_batching(batching, L.ranks, L.r_max) == "ranked":
        plan = tile_plan(L.ranks, L.r_max)
        for bk, (idx, rows, cols, valid) in zip(
                plan.buckets, _plan_gathers(plan, nb, xb.device)):
            attrs = {}
            if obs.enabled():
                attrs = _chain_span_attrs(plan, bk, b, xb, sym=False)
            with obs.span("tri_matvec.bucket", cat="solve", **attrs):
                if not trans:
                    _plan_chain(L.U, L.V, xb, yb, idx, cols, rows, valid,
                                bk.width)
                else:
                    # (L^T)(j,i) = L(i,j)^T = V U^T: swap the factor roles.
                    _plan_chain(L.V, L.U, xb, yb, idx, rows, cols, valid,
                                bk.width)
        return yb.reshape(x.shape)
    rows, cols = _pair_index(nb, xb.device)
    if not trans:
        yb.index_add_(0, rows, _chain(L.U, L.V, xb[cols]))
    else:
        yb.index_add_(0, cols, _chain(L.V, L.U, xb[rows]))
    return yb.reshape(x.shape)


def _trsv_column_tiles(nb: int, k: int, trans: bool):
    """Packed tile indices and target block rows of solve column ``k``."""
    if not trans:
        tgt = np.arange(k + 1, nb)
        tiles = tgt * (tgt - 1) // 2 + k              # tril_index(i, k)
    else:
        tgt = np.arange(k)
        tiles = k * (k - 1) // 2 + tgt                # tril_index(k, j)
    return tiles, tgt


def _trsv_bucket_widths(plan, nb: int, trans: bool, ladder) -> dict[int, int]:
    """One plan width per row-bucket interval: the ladder width covering
    every rank any column in that Tb bucket touches, so one (Tb, w) step
    shape per ladder entry and direction -- the flat path's count -- while
    narrow intervals still run at their own narrow widths. Memoized on the
    plan, like :func:`_plan_gathers`."""
    def make():
        widths: dict[int, int] = {}
        for k in range(nb):
            tiles, tgt = _trsv_column_tiles(nb, k, trans)
            Tb = _bucket_up(max(len(tgt), 1), ladder)
            cw = int(plan.widths[tiles].max(initial=0)) if len(tiles) else 0
            widths[Tb] = max(widths.get(Tb, 1), cw, 1)
        cap = max(int(plan.cap), 1)
        return {Tb: min(w, cap) for Tb, w in widths.items()}
    return plan_memo(plan, ("trsv_widths", nb, trans), make)


@lru_cache(maxsize=64)
def _trsv_column_steps(nb: int, trans: bool, device: torch.device):
    """Bucket-padded index operands ``(Tb, k, tidx, ridx, valid)`` of every
    column step in sweep order, uploaded once per (nb, direction, device)."""
    ladder = _bucket_ladder(nb - 1)
    order = range(nb) if not trans else range(nb - 1, -1, -1)
    steps = []
    for k in order:
        tiles, tgt = _trsv_column_tiles(nb, k, trans)
        T = len(tgt)
        Tb = _bucket_up(max(T, 1), ladder)
        tidx = np.zeros(Tb, np.int64)
        ridx = np.zeros(Tb, np.int64)
        tidx[:T], ridx[:T] = tiles, tgt
        valid = np.zeros(Tb, bool)
        valid[:T] = True
        steps.append((Tb, k, torch.as_tensor(tidx, device=device),
                      torch.as_tensor(ridx, device=device),
                      torch.as_tensor(valid, device=device)))
    return tuple(steps)


def _trsm_step(L: TLRMatrix, xb, k, Tb, tidx, ridx, valid, trans: bool,
               w: int):
    """One blocked-TRSM column (in place on ``xb``, shape (nb, b, m)):
    solve the diagonal block, then subtract the low-rank update from the
    remaining blocks. ``w`` is the column's plan width (``r_max`` on the
    flat path): the U/V gathers take only that many columns. Padded slots
    carry a zero update into block 0."""
    trace_event("trsm", (tuple(xb.shape), Tb, w, trans, str(xb.dtype),
                         xb.device.type))
    Dk = L.D[k]
    if w < L.r_max:
        Ut, Vt = L.U[:, :, :w][tidx], L.V[:, :, :w][tidx]
    else:
        Ut, Vt = L.U[tidx], L.V[tidx]
    if trans:
        # (L^T)(j,k) = L(k,j)^T = V U^T: the U/V roles swap in the update.
        Dk = Dk.T
        Ut, Vt = Vt, Ut
    xk = torch.linalg.solve_triangular(Dk, xb[k], upper=trans)
    upd = Ut @ (Vt.transpose(1, 2) @ xk)
    upd = torch.where(valid[:, None, None], upd, torch.zeros_like(upd))
    xb[k] = xk
    xb.index_add_(0, ridx, -upd)


def tlr_trsv(L: TLRMatrix, y: torch.Tensor, *, trans: bool = False,
             batching: str | None = "auto") -> torch.Tensor:
    """Solve L x = y (trans=False) or L^T x = y (trans=True). Algorithm 7.
    ``y`` is a single right-hand side ``(n,)`` or a batch ``(n, m)``.

    ``batching="ranked"`` slices each column step's U/V gathers to the
    plan width of its row-bucket interval (:func:`_trsv_bucket_widths`);
    ``"flat"`` runs every step r_max-wide; ``"auto"`` (default) applies the
    rank-histogram policy."""
    nb, b = L.nb, L.b
    xb = y.reshape(nb, b, -1).clone()
    if nb == 1:
        xb[0] = torch.linalg.solve_triangular(
            L.D[0].T if trans else L.D[0], xb[0], upper=trans)
        return xb.reshape(y.shape)
    bucket_w = None
    mode = resolve_batching(batching, L.ranks, L.r_max)
    if mode == "ranked":
        bucket_w = _trsv_bucket_widths(tile_plan(L.ranks, L.r_max), nb,
                                       trans, _bucket_ladder(nb - 1))
    sweep_attrs = {"nb": nb, "trans": trans, "mode": mode} \
        if obs.enabled() else {}
    with obs.span("trsm.sweep", cat="solve", **sweep_attrs):
        for Tb, k, tidx, ridx, valid in _trsv_column_steps(nb, trans,
                                                           xb.device):
            w = bucket_w[Tb] if bucket_w is not None else L.r_max
            # Column steps run asynchronously on the card, so each child
            # span times the launch, not the device work; the profiler
            # range of the sweep carries the device alignment.
            with obs.span("trsm.column", cat="solve", Tb=Tb, w=w):
                _trsm_step(L, xb, k, Tb, tidx, ridx, valid, trans, w)
    return xb.reshape(y.shape)


def tlr_trsv_reference(L: TLRMatrix, y: torch.Tensor, *,
                       trans: bool = False) -> torch.Tensor:
    """Host-loop TRSV over per-block lists, the parity oracle of
    :func:`tlr_trsv` (the JAX package keeps the same oracle)."""
    nb, b = L.nb, L.b
    yb = y.reshape(nb, b, -1)
    xb = [yb[i].clone() for i in range(nb)]
    order = range(nb) if not trans else range(nb - 1, -1, -1)
    for k in order:
        Dk = L.D[k] if not trans else L.D[k].T
        xk = torch.linalg.solve_triangular(Dk, xb[k], upper=trans)
        xb[k] = xk
        targets = range(k + 1, nb) if not trans else range(k)
        for i in targets:
            t = tril_index(i, k) if not trans else tril_index(k, i)
            U, V = (L.U[t], L.V[t]) if not trans else (L.V[t], L.U[t])
            xb[i] = xb[i] - U @ (V.T @ xk)
    return torch.stack(xb).reshape(y.shape)


def tile_perm_to_element_perm(perm: np.ndarray, b: int) -> np.ndarray:
    return (np.asarray(perm)[:, None] * b + np.arange(b)[None, :]).reshape(-1)


# -- factorization application (implementations behind the handle methods) ----


def _permute_rows(x: torch.Tensor, eperm: np.ndarray) -> torch.Tensor:
    return x[torch.as_tensor(eperm, device=x.device)]


def _unpermute_rows(x: torch.Tensor, eperm: np.ndarray) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[torch.as_tensor(eperm, device=x.device)] = x
    return out


def _factor_solve_impl(fact, y: torch.Tensor) -> torch.Tensor:
    """Solve A x = y given a TLRFactorization (handles perm and LDL)."""
    eperm = tile_perm_to_element_perm(fact.perm, fact.L.b)
    z = tlr_trsv(fact.L, _permute_rows(y, eperm), trans=False)
    if fact.d is not None:
        dflat = fact.d.reshape(-1)
        z = z / dflat.reshape((-1,) + (1,) * (z.dim() - 1))
    z = tlr_trsv(fact.L, z, trans=True)
    return _unpermute_rows(z, eperm)


def _logdet_impl(fact) -> torch.Tensor:
    """log |det A| from the factorization diagonals."""
    if fact.d is not None:
        return torch.log(torch.abs(fact.d)).sum()
    diags = torch.diagonal(fact.L.D, dim1=1, dim2=2)
    return 2.0 * torch.log(torch.abs(diags)).sum()


def _mvn_sample_impl(fact, num: int = 1, *, generator=None,
                     z: torch.Tensor | None = None) -> torch.Tensor:
    """Sample x ~ N(0, A) via x = P^T L z (Cholesky factorizations only).
    ``z`` (n, num) may be given; otherwise it is drawn from ``generator``
    (a ``torch.Generator`` on the factor's device, or the default one)."""
    if fact.d is not None:
        raise ValueError("MVN sampling requires a Cholesky factorization")
    n = fact.L.n
    if z is None:
        z = torch.randn((n, num), generator=generator, dtype=fact.L.dtype,
                        device=fact.L.device)
    x = tlr_tri_matvec(fact.L, z)
    eperm = tile_perm_to_element_perm(fact.perm, fact.L.b)
    out = _unpermute_rows(x, eperm)
    return out[:, 0] if out.shape[1] == 1 else out


# -- preconditioned conjugate gradients -----------------------------------------


def _as_matvec(op):
    """Coerce an operator argument to a matvec callable: a bare callable,
    or any object with a ``.matvec`` (TLROperator; TLRFactorization, whose
    operator action is A^{-1})."""
    if op is None:
        return None
    if callable(op) and not hasattr(op, "matvec"):
        return op
    mv = getattr(op, "matvec", None)
    if mv is not None:
        return mv
    raise TypeError(
        f"expected a callable or an object with .matvec, got {type(op)!r}")


class PCGHistory(list):
    """Relative-residual history: a plain ``list`` of floats carrying
    breakdown diagnostics. ``breakdown`` is None on a clean run, or the
    condition that stopped the iteration early:

    * ``"indefinite_curvature"``      -- p^T A p <= 0 (A not SPD),
    * ``"indefinite_preconditioner"`` -- r^T M^{-1} r <= 0 (M not SPD),
    * ``"nonfinite"``                 -- a NaN/Inf appeared in the recurrence.

    On breakdown PCG returns the last finite iterate.
    """

    def __init__(self, *args):
        super().__init__(*args)
        self.breakdown: str | None = None


def pcg(A, b_rhs: torch.Tensor, *, precond=None, tol=1e-6,
        maxiter: int = 300, check_every: int = 1):
    """PCG with relative residual ||Ax-b||/||b|| stopping (section 6.2).

    ``A`` and ``precond`` are callables ``v -> Av`` (resp. ``r -> M^{-1}r``)
    or any object with a ``.matvec`` -- a ``TLROperator``, or a
    ``TLRFactorization`` used directly as the preconditioner. Host-driven
    loop on ``b_rhs``'s device; returns (x, iterations, history), where
    ``history`` is a :class:`PCGHistory` whose ``breakdown`` records an
    indefinite-operator / indefinite-preconditioner / non-finite breakdown
    (the iteration stops at the last finite iterate). A zero right-hand
    side returns x = 0 at once with an empty history.

    ``check_every`` batches the convergence and breakdown checks: the
    recurrence runs ``check_every`` iterations, then one host read
    (``.cpu()`` of the stacked ``(p^T A p, ||r||, r^T z)`` of the window)
    checks them all. The op sequence per iteration is the same for every
    ``check_every``, so the history is bit for bit that of
    ``check_every=1``; a window that trips a check part-way is replayed
    from its start up to the event. The window is clamped to the
    iterations remaining.

    A 2-D right-hand side ``(n, k)`` runs per-column CG through a
    :class:`BatchedPCG` of width k (``tol`` scalar or ``(k,)``) and returns
    ``(X, iters, histories)``: the ``(n, k)`` iterate block, a numpy
    ``(k,)`` iteration count and one :class:`PCGHistory` per column.
    """
    if b_rhs.dim() >= 2:
        return _pcg_batched(A, b_rhs, precond=precond, tol=tol,
                            maxiter=maxiter, check_every=check_every)
    tol = float(tol)
    matvec = _as_matvec(A)
    precond = _as_matvec(precond)
    check_every = max(1, int(check_every))
    bnorm = float(torch.linalg.norm(b_rhs))
    if bnorm == 0.0:
        return torch.zeros_like(b_rhs), 0, PCGHistory()
    x = torch.zeros_like(b_rhs)
    r = b_rhs - matvec(x)
    z = precond(r) if precond else r
    p_dir = z
    rz = torch.dot(r, z)
    history = PCGHistory([float(torch.linalg.norm(r)) / bnorm])
    rz_f = float(rz)
    if not np.isfinite(rz_f) or rz_f <= 0.0:
        history.breakdown = ("nonfinite" if not np.isfinite(rz_f)
                             else "indefinite_preconditioner")
        return x, 0, history

    def step(x, r, p_dir, rz):
        """One CG iteration: the new state and the check scalars (on the
        device, unread)."""
        Ap = matvec(p_dir)
        pAp = torch.dot(p_dir, Ap)
        alpha = rz / pAp
        x_new = x + alpha * p_dir
        r_new = r - alpha * Ap
        rnorm = torch.linalg.norm(r_new)
        z = precond(r_new) if precond else r_new
        rz_new = torch.dot(r_new, z)
        beta = rz_new / rz
        p_new = z + beta * p_dir
        return (x_new, r_new, p_new, rz_new), (pAp, rnorm, rz_new)

    it = 0
    state = (x, r, p_dir, rz)
    done = False
    while it < maxiter and not done:
        steps = min(check_every, maxiter - it)
        start = state
        scalars = []
        st = state
        for _ in range(steps):
            st, sc = step(*st)
            scalars.append(torch.stack(sc))
        # One host read for the whole window.
        vals = torch.stack(scalars).cpu().numpy()
        accepted = 0
        for s in range(steps):
            pAp, rnorm_raw, rz_new = (float(v) for v in vals[s])
            if not np.isfinite(pAp) or pAp <= 0.0:
                history.breakdown = ("nonfinite" if not np.isfinite(pAp)
                                     else "indefinite_curvature")
                done = True
                break                       # iterate s discarded
            rnorm = rnorm_raw / bnorm
            if not np.isfinite(rnorm):
                history.breakdown = "nonfinite"
                done = True
                break                       # iterate s discarded
            accepted = s + 1
            it += 1
            history.append(rnorm)
            if rnorm < tol:
                done = True
                break
            if not np.isfinite(rz_new) or rz_new <= 0.0:
                history.breakdown = ("nonfinite" if not np.isfinite(rz_new)
                                     else "indefinite_preconditioner")
                done = True
                break                       # iterate s kept
        if accepted == steps:
            state = st
        else:
            # Replay the window up to the last accepted iterate: the same
            # ops from the same inputs reproduce it exactly.
            st = start
            for _ in range(accepted):
                st, _ = step(*st)
            state = st
    return state[0], it, history


# -- batched-RHS PCG with per-column convergence masks --------------------------


def _pcg_block_step(matvec, precond, X, R, P, RZ, act):
    """One batched CG iteration over an ``(n, k)`` block with per-column
    alpha/beta and a per-column active mask ``act`` (a ``(k,)`` bool tensor
    on the block's device).

    Columns are independent: the matvec applies the operator to each
    column separately and every other op is columnwise, so masking a
    column freezes it exactly. Frozen columns keep their old state through
    explicit ``where`` selects (their lanes may compute garbage, even NaN
    from a broken-down neighbour's iterate; the select discards it)."""
    trace_event("pcg", (tuple(X.shape), str(X.dtype), X.device.type))
    AP = matvec(P)
    pAp = (P * AP).sum(0)
    alpha = torch.where(act, RZ / torch.where(pAp != 0, pAp, 1.0), 0.0)
    Xn = torch.where(act, X + alpha[None, :] * P, X)
    Rn = torch.where(act, R - alpha[None, :] * AP, R)
    rnorm = torch.linalg.norm(Rn, dim=0)
    Z = precond(Rn) if precond else Rn
    RZn = (Rn * Z).sum(0)
    beta = torch.where(act, RZn / torch.where(RZ != 0, RZ, 1.0), 0.0)
    Pn = torch.where(act, Z + beta[None, :] * P, P)
    RZk = torch.where(act, RZn, RZ)
    return (Xn, Rn, Pn, RZk), (pAp, rnorm, RZn)


def _host_column(b, dtype: np.dtype) -> np.ndarray:
    """A right-hand side (numpy, list or tensor on any device) as a flat
    host array of ``dtype``."""
    if isinstance(b, torch.Tensor):
        b = b.detach().cpu().numpy()
    return np.asarray(b, dtype).reshape(-1)


class BatchedPCG:
    """Incremental batched-RHS PCG over a fixed-width column block.

    The engine holds ``width`` right-hand-side *slots* of length ``n`` on
    ``device``. Columns are loaded with :meth:`load` (each with its own
    tolerance and iteration budget), advanced together in windows of
    ``check_every`` iterations by :meth:`advance`, and leave the block the
    moment they converge, break down or exhaust their budget: a per-column
    mask freezes finished columns while the rest iterate, so shapes never
    change and one slow column cannot stall the block (the iterative-solve
    mirror of the paper's Algorithm 5; the engine the ``TLRServer`` ticks
    drive).

    Stopping is exact per iteration: after each window one host read
    (``.cpu()``) pulls the window's ``(steps, 3, width)`` scalars, each
    column's stop is located on the host with the scalar :func:`pcg` rules,
    and if a column stopped mid-window the window is replayed with
    per-step masks, so a stopped column freezes at its last accepted
    iterate. The window length never depends on per-column budgets, so
    the block step's shape set is fixed after the first window.

    Statuses: ``"idle"`` (slot empty), ``"pending"`` (loaded, written to
    the device at the next :meth:`advance`), ``"active"`` (iterating),
    ``"done"`` (finished, result waiting for :meth:`evict`).

    ``device`` defaults to ``A``'s (or ``precond``'s) ``.device``, else the
    card; ``dtype`` to ``torch.float64``.
    """

    def __init__(self, A, n: int, width: int, *, precond=None,
                 maxiter: int = 300, check_every: int = 8,
                 dtype=None, device=None):
        self.matvec = _as_matvec(A)
        self.precond = _as_matvec(precond)
        self.n, self.width = int(n), int(width)
        self.check_every = max(1, int(check_every))
        self.default_maxiter = int(maxiter)
        self.dtype = dtype if dtype is not None else torch.float64
        self.np_dtype = numpy_dtype(self.dtype)
        if device is None:
            device = getattr(A, "device", None) or getattr(
                precond, "device", None)
        self.device = resolve_device(device)
        self._reset_state()

    def _reset_state(self):
        n, w = self.n, self.width
        kw = dict(dtype=self.dtype, device=self.device)
        self.X = torch.zeros((n, w), **kw)
        self.R = torch.zeros((n, w), **kw)
        self.P = torch.zeros((n, w), **kw)
        self.RZ = torch.zeros((w,), **kw)
        self.act = np.zeros(w, bool)
        self.status = ["idle"] * w
        self.converged = np.zeros(w, bool)
        self.bnorm = np.zeros(w)
        self.tol = np.full(w, 1e-6)
        self.maxiter = np.full(w, self.default_maxiter, np.int64)
        self.iters = np.zeros(w, np.int64)
        self.hist: list[PCGHistory] = [PCGHistory() for _ in range(w)]
        self._pending: dict[int, np.ndarray] = {}

    def reset(self):
        """Clear every slot (after a warmup pass)."""
        self._reset_state()

    # -- slot lifecycle ----------------------------------------------------

    def load(self, j: int, b_col, *, tol: float = 1e-6,
             maxiter: int | None = None) -> None:
        """Stage right-hand side ``b_col`` into column ``j``. The device
        write happens at the next :meth:`advance`, as one masked block
        update over all staged columns."""
        j = int(j)
        if self.status[j] == "active":
            raise ValueError(f"column {j} is still active; evict it first")
        col = _host_column(b_col, self.np_dtype)
        if col.shape[0] != self.n:
            raise ValueError(
                f"rhs length {col.shape[0]} != operator size {self.n}")
        self.hist[j] = PCGHistory()
        self.iters[j] = 0
        self.converged[j] = False
        self.act[j] = False
        self.tol[j] = float(tol)
        self.maxiter[j] = int(maxiter if maxiter is not None
                              else self.default_maxiter)
        self.bnorm[j] = float(np.linalg.norm(col))
        if self.bnorm[j] == 0.0:
            # x = 0 exactly; empty history, converged (scalar-pcg contract)
            self._pending.pop(j, None)
            self.status[j] = "done"
            self.converged[j] = True
            return
        self.status[j] = "pending"
        self._pending[j] = col

    def evict(self, j: int) -> tuple[np.ndarray, int, PCGHistory, bool]:
        """Pull column ``j``'s result to the host and free the slot.
        Returns ``(x, iterations, history, converged)``."""
        j = int(j)
        if self.status[j] != "done":
            raise ValueError(f"column {j} is {self.status[j]!r}, not done")
        x = self.X[:, j].cpu().numpy().copy()
        out = (x, int(self.iters[j]), self.hist[j], bool(self.converged[j]))
        self.status[j] = "idle"
        self.act[j] = False
        return out

    def cancel(self, j: int) -> None:
        """Abandon column ``j`` in whatever state it is in and free the
        slot (a timeout eviction). Its device lanes keep their stale
        values until the column is loaded again; nothing reads them."""
        j = int(j)
        self.status[j] = "idle"
        self.act[j] = False
        self._pending.pop(j, None)

    def solution(self) -> torch.Tensor:
        """The current iterate block (on the device, ``(n, width)``)."""
        return self.X

    @property
    def active_columns(self) -> list[int]:
        return [j for j, s in enumerate(self.status)
                if s in ("active", "pending")]

    @property
    def done_columns(self) -> list[int]:
        return [j for j, s in enumerate(self.status) if s == "done"]

    # -- the window --------------------------------------------------------

    def _flush_pending(self) -> list[int]:
        """Materialize staged columns: one masked block write (x = 0,
        r = b), one batched preconditioner application for p / rz, and the
        per-column initial-residual bookkeeping. Returns the columns that
        finished at init (rz <= 0 or non-finite: immediate breakdown)."""
        if not self._pending:
            return []
        cols = sorted(self._pending)
        B = np.zeros((self.n, self.width), self.np_dtype)
        sel = np.zeros(self.width, bool)
        for j in cols:
            B[:, j] = self._pending[j]
            sel[j] = True
        Bd = torch.as_tensor(B).to(self.device)
        m = torch.as_tensor(sel).to(self.device)
        self.R = torch.where(m[None, :], Bd, self.R)
        self.X = torch.where(m[None, :], 0.0, self.X)
        Z = self.precond(self.R) if self.precond else self.R
        RZ_all = (self.R * Z).sum(0)
        self.P = torch.where(m[None, :], Z, self.P)
        self.RZ = torch.where(m, RZ_all, self.RZ)
        rz_host = RZ_all.cpu().numpy()[cols]
        finished = []
        for j, rz in zip(cols, rz_host):
            rz = float(rz)
            self.hist[j].append(1.0)      # ||r||/||b|| = 1 at x = 0
            if not np.isfinite(rz) or rz <= 0.0:
                self.hist[j].breakdown = (
                    "nonfinite" if not np.isfinite(rz)
                    else "indefinite_preconditioner")
                self.status[j] = "done"
                finished.append(j)
            else:
                self.status[j] = "active"
                self.act[j] = True
        self._pending.clear()
        return finished

    def _scan_column(self, j: int, vals: np.ndarray, steps: int) -> int:
        """Walk column ``j`` through the window's pulled scalars with the
        scalar-pcg acceptance rules; returns the number of accepted
        iterates (``steps`` when the column ran the whole window)."""
        accepted = 0
        for s in range(steps):
            pAp, rnorm_raw, rz_new = (float(vals[s, i, j]) for i in range(3))
            if not np.isfinite(pAp) or pAp <= 0.0:
                self.hist[j].breakdown = (
                    "nonfinite" if not np.isfinite(pAp)
                    else "indefinite_curvature")
                return accepted               # iterate s discarded
            rel = rnorm_raw / self.bnorm[j]
            if not np.isfinite(rel):
                self.hist[j].breakdown = "nonfinite"
                return accepted               # iterate s discarded
            accepted = s + 1
            self.iters[j] += 1
            self.hist[j].append(rel)
            if rel < self.tol[j]:
                self.converged[j] = True
                return accepted               # iterate s kept
            if not np.isfinite(rz_new) or rz_new <= 0.0:
                self.hist[j].breakdown = (
                    "nonfinite" if not np.isfinite(rz_new)
                    else "indefinite_preconditioner")
                return accepted               # iterate s kept
            if self.iters[j] >= self.maxiter[j]:
                return accepted               # budget exhausted, no flag
        return accepted

    def advance(self, steps: int | None = None) -> list[int]:
        """Run one window of ``steps`` (default ``check_every``) batched
        iterations, then settle per-column outcomes; returns the columns
        that finished during this call (converged, broke down, or hit
        their budget). Idle and done columns are inert."""
        finished = self._flush_pending()
        act_idx = np.nonzero(self.act)[0]
        if act_idx.size == 0:
            return finished
        steps = max(1, int(steps if steps is not None else self.check_every))
        start = (self.X, self.R, self.P, self.RZ)
        act = torch.as_tensor(self.act).to(self.device)
        st, scal = start, []
        for _ in range(steps):
            st, sc = _pcg_block_step(self.matvec, self.precond, *st, act)
            scal.append(torch.stack(sc))
        vals = torch.stack(scal).cpu().numpy()   # (steps, 3, width): one read
        stop_at = np.full(self.width, steps)
        for j in act_idx:
            stop_at[j] = self._scan_column(j, vals, steps)
            if (stop_at[j] < steps or self.converged[j]
                    or self.hist[j].breakdown is not None
                    or self.iters[j] >= self.maxiter[j]):
                self.act[j] = False
                self.status[j] = "done"
                finished.append(int(j))
        if np.all(stop_at[act_idx] == steps):
            # every column accepted the whole window (finishing exactly at
            # its last step is fine: the state is the accepted iterate)
            self.X, self.R, self.P, self.RZ = st
            return finished
        # Replay with per-step masks: a column that accepted stop_at[j]
        # iterates runs steps 0 .. stop_at[j] - 1 and is frozen after; the
        # same ops from the same inputs reproduce the accepted prefix.
        base_act = np.zeros(self.width, bool)
        base_act[act_idx] = True
        st = start
        for s in range(steps):
            mask = torch.as_tensor(base_act & (stop_at > s)).to(self.device)
            st, _ = _pcg_block_step(self.matvec, self.precond, *st, mask)
        self.X, self.R, self.P, self.RZ = st
        return finished

    def run(self) -> None:
        """Advance until every loaded column is finished."""
        while self.active_columns:
            self.advance()


def _pcg_batched(A, B: torch.Tensor, *, precond=None, tol=1e-6,
                 maxiter: int = 300, check_every: int = 1):
    """Per-column PCG over an ``(n, k)`` block (the ``pcg`` 2-D route):
    loads every column into a :class:`BatchedPCG` of width k on ``B``'s
    device and drains it. ``tol`` may be scalar or ``(k,)``. Returns
    ``(X, iters, histories)``."""
    n, k = B.shape
    tols = np.broadcast_to(np.asarray(tol, np.float64), (k,))
    eng = BatchedPCG(A, n, k, precond=precond, maxiter=maxiter,
                     check_every=check_every, dtype=B.dtype,
                     device=B.device)
    Bh = B.detach().cpu().numpy()
    for j in range(k):
        eng.load(j, Bh[:, j], tol=float(tols[j]))
    eng.run()
    return eng.solution(), eng.iters.copy(), list(eng.hist)
