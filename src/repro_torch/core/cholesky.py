"""TLR Cholesky / LDL^T: the left-looking ARA driver (Algorithms 4-6, 9,
10) and the right-looking driver.

Port of ``repro/core/cholesky.py`` (:86-142, :147-443, :446-760,
:795-1142 left; :1148-1658 right). ``CholOptions.algo`` picks the driver.

Left-looking (default). Per block column ``k`` (host-driven):

  1. with inter-tile pivoting (``pivot="frobenius"|"power"``, Algorithm 9),
     pick the remaining logical row whose updated diagonal tile has the
     largest norm (the running sums ``sum_j L(i,j) L(i,j)^T`` of every
     remaining row are kept on the card) and swap it to position ``k``,
  2. dense diagonal update  A(k,k) -= sum_j L(k,j) D_j L(k,j)^T
     (Schur-compensated by default, section 5.1.1),
  3. dense Cholesky (or LDL^T) of the diagonal tile, with the
     eigenvalue-clamp fallback (section 5.1.2),
  4. ARA compression of every updated tile in the column: the expression
     ``A(i,k) - sum_j L(i,j) D_j L(k,j)^T`` is sampled through the product
     chain of Eq. 2 / Eq. 3, whose GEMMs are the port's CUDA kernels
     (``batched_gemm``, ``tile_chain``, ``lr_sample``) on the card,
  5. batched triangular solve  V(i,k) = L(k,k)^{-1} B_i  (+ D^{-1} for
     LDL^T), and an in-place ``index_add_`` of the panel into the factor.

``mode="dynamic"`` is Algorithm 5: tiles sorted by their rank in A
(descending) flow through a fixed set of slots, converged tiles are evicted
and their slots refilled. Each column's batch is zero-padded up to a
(T, J) bucket pair of a power-of-two ladder, as in the JAX package, so both
packages run the same padded batches.

Right-looking (``algo="right"``). Per column: dense-factor the diagonal
tile (already fully updated), round the column's accumulated tiles and TRSM
them (``core/algebra.py``: ``batched_qr`` + ``small_svd`` +
``batched_gemm``), then push the column's rank-r Schur update onto every
trailing tile as an appended factor pair (``tlr_syrk_column``); a rounding
pass compacts the accumulation buffers whenever the next append would
overflow them. ``lookahead=True`` splits the trailing update into a head
(column k+1's tiles and D[k+1]) and a tail (the rest) and runs the
``LookaheadSchedule``: each tail after the next column's panel, on a second
CUDA stream on the card.

``batching`` (default ``"auto"``, resolved by the rank-histogram policy of
``core/batching.py`` and recorded in ``stats["policy"]``): under
``"ranked"`` the left driver gathers A tiles at the ladder width ``wA``
covering A's ranks and L tiles at the running ladder width ``wL`` of the
factor's ranks, and projects at the width ``wQ`` covering each column's
detected ranks; the right driver tracks each tile's content width, appends
at the panel's ladder width and rounds per rank bucket.

``check=True`` (``core/health.py``) validates every stage boundary and
applies ``CholOptions.retry``'s bounded remedies: jitter on an SPD
breakdown, an eps-loosened ARA re-pass and then densify on a rank overflow
(left), an accept-or-raise rule on a rank overflow (right); what cannot be
repaired raises ``FactorizationBreakdown``. A clean run's factors are the
unchecked run's, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .. import faults, obs
from .algebra import tlr_round_tiles, tlr_syrk_column
from .ara import (ARAParams, ara_compress_dense, ara_iteration, init_state,
                  rank_overflow, run_ara_fused, torch_probes)
from .batching import (batching_trace_count, bucket_width,
                       bucketed_round_tiles, pad_tile_batch, resolve_policy,
                       tile_batch_rows, tile_mesh, tile_plan)
from .buckets import _bucket_ladder, _bucket_up, _column_buckets, _pad_axis
from .health import HealthMonitor, RetryPolicy, column_flags
from .operator import TLRFactorization
from .stages import LookaheadSchedule, SequentialSchedule, Stage, run_graph
from .tlr import TLRMatrix, tril_index, tril_pairs, zeros_like_structure
from ..kernels import ops
from ..launch.sharding import gather_rows

Probes = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CholOptions:
    eps: float = 1e-6
    bs: int = 16
    r_max_out: int = 0            # 0 => A.r_max
    algo: str = "left"            # "left" (ARA sampling) | "right" (eager
                                  # updates)
    mode: str = "dynamic"         # "dynamic" | "fused" (left-looking only)
    bucket: int = 0               # 0 => whole column in one batch
    share_omega: bool = True      # share Omega across the column
    schur: Optional[str] = "diag" # None | "diag" | "full"
    modified_chol: bool = True
    pivot: Optional[str] = None   # None | "frobenius" | "power" (inter-tile
                                  # pivoting, Algorithm 9; left-looking
                                  # Cholesky only)
    ldl: bool = False
    calib: float = 1.0
    gs_passes: int = 2
    max_iters: int = 0            # ARA iteration cap; 0 => r_max // bs
    right_flush: int = 0          # algo="right": columns of rank-r appends
                                  # accumulated between trailing rounding
                                  # passes; 0 => the auto policy picks the
                                  # cadence from the rank histogram
    batching: str = "auto"        # "auto" (rank-histogram policy) | "flat"
                                  # (r_max-wide batches) | "ranked"
                                  # (rank-bucketed batches)
    seed: int = 0
    lookahead: bool = False       # algo="right": run column k+1's diag +
                                  # panel between the head and the tail of
                                  # column k's trailing update (the tail on
                                  # a second CUDA stream on the card);
                                  # recorded but ignored by algo="left"
    check: bool = False           # breakdown detection + bounded recovery
                                  # at stage boundaries (core/health.py);
                                  # a clean run is bitwise the unchecked one
    retry: RetryPolicy = RetryPolicy()
                                  # the remedy schedule ``check`` applies
    probes: Optional[Probes] = None
                                  # probes(k, it, shape, dtype, device): the
                                  # Omega of block iteration ``it`` in column
                                  # ``k`` (panel ARA and Schur compensation
                                  # alike). The rank-overflow re-pass calls
                                  # it with stream=(7000 + attempt,), power
                                  # pivoting with it=None (see
                                  # ara.torch_probes); None =>
                                  # torch_probes(seed)

    def ara_params(self, r_max: int) -> ARAParams:
        return ARAParams(bs=self.bs, r_max=r_max, eps=self.eps,
                         calib=self.calib, gs_passes=self.gs_passes,
                         max_iters=self.max_iters)


def _validate(opts: CholOptions) -> None:
    if opts.algo not in ("left", "right"):
        raise ValueError(f"algo must be 'left' or 'right', got {opts.algo!r}")
    if opts.pivot is not None:
        if opts.algo == "right":
            raise ValueError(
                "inter-tile pivoting (Algorithm 9) needs the left-looking "
                "driver's running diagonal-update sums and is not supported "
                f"with algo='right'; use algo='left' (got "
                f"pivot={opts.pivot!r})")
        if opts.pivot not in ("frobenius", "power"):
            raise ValueError(f"pivot must be None, 'frobenius' or 'power', "
                             f"got {opts.pivot!r}")
    if opts.mode not in ("dynamic", "fused"):
        raise ValueError(f"mode must be 'dynamic' or 'fused', got {opts.mode!r}")


# -- tile gathers -------------------------------------------------------------


# ``w`` (ranked batching) is the rank-ladder width covering the gathered
# tiles' ranks: a tile's factor columns past its rank are zero, so gathering
# only the first ``w`` columns is exact. The gathers index the ``[..., :w]``
# view, so each copies only those columns into a contiguous stack that the
# kernels take as it is. L tiles are addressed by logical position (a pivot
# swap moves the written L rows); A tiles by original position, through the
# pivot permutation.


def _gather_L(L: TLRMatrix, rows, k: int, Tb: int, Jb: int,
              w: int | None = None):
    """L tiles (i, j) for i in rows, j < k, zero-padded to (Tb, Jb, b, w)."""
    T, b, w = len(rows), L.b, w or L.r_max
    Ui = L.U.new_zeros((Tb, Jb, b, w))
    Vi = L.V.new_zeros((Tb, Jb, b, w))
    if T and k:
        idx = torch.as_tensor(
            [[tril_index(int(i), j) for j in range(k)] for i in rows],
            device=L.device)
        Ui[:T, :k] = L.U[:, :, :w][idx]
        Vi[:T, :k] = L.V[:, :, :w][idx]
    return Ui, Vi


def _gather_L_row(L: TLRMatrix, i: int, k: int, Jb: int,
                  w: int | None = None):
    """L tiles (i, j), j < k, zero-padded to (Jb, b, w)."""
    w = w or L.r_max
    idx = torch.as_tensor([tril_index(i, j) for j in range(k)],
                          dtype=torch.long, device=L.device)
    return (_pad_axis(L.U[:, :, :w][idx], Jb),
            _pad_axis(L.V[:, :, :w][idx], Jb))


def _gather_A_tiles(A: TLRMatrix, rows, k: int, perm: np.ndarray, Tb: int,
                    w: int | None = None):
    """Original-A tiles for the logical tiles (i, k), i in rows, at width
    ``w``, and their ranks, zero-padded to Tb slots.

    A logical tile (i, k) is the original (perm[i], perm[k]); when
    perm[i] < perm[k] the stored tile is its transpose, so U and V swap.
    """
    w = w or A.r_max
    oi = perm[np.asarray(rows, np.int64)]
    ok = int(perm[k])
    low = oi > ok
    idx_h = np.where(low, oi * (oi - 1) // 2 + ok, ok * (ok - 1) // 2 + oi)
    idx = torch.as_tensor(idx_h, dtype=torch.long, device=A.device)
    # Factors stored in a lower precision (``compress(store_dtype=)``) are
    # promoted here: the A-term kernel takes one dtype for all operands.
    U0 = A.U[:, :, :w][idx].to(A.dtype)
    V0 = A.V[:, :, :w][idx].to(A.dtype)
    if not low.all():
        f = torch.as_tensor(~low, device=A.device)[:, None, None]
        U0, V0 = torch.where(f, V0, U0), torch.where(f, U0, V0)
    return _pad_axis(U0, Tb), _pad_axis(V0, Tb), _pad_axis(A.ranks[idx], Tb)


# -- sampling closures (Eq. 2 / Eq. 3) ----------------------------------------


def make_column_samplers(ldl: bool):
    """Samplers for the column expression A(i,k) - sum_j L(i,j) D_j L(k,j)^T.

    data = dict(Uk, Vk: (J,b,r) row-k tiles of L;  Ui, Vi: (T,J,b,r) row-i
    tiles;  Ua, Va: (T,b,rA) original A(i,k);  ranksA: (T,) A-tile ranks;
    dk: (J,b) LDL diagonals or None). Omega is (b,s) when shared across the
    column, else (T,b,s). Padded tiles are zero, hence inert.

    The A-term runs through the rank-masked ``batched_gemm``, the per-j
    intermediate ``W2 = V(k,j) (U(k,j)^T Omega)`` through ``tile_chain``,
    and the j-reduction through ``lr_sample`` (shared Omega) or a flattened
    ``tile_chain`` (per-tile Omega): the CUDA kernels on the card, their
    plain versions on the CPU.
    """

    def _dk_flat(dk, T, J, b):
        return dk[None].expand(T, J, b).reshape(T * J, b)

    # reshape() of an expanded tensor is a stride-0 view when T or J is 1;
    # the kernels take contiguous operands, hence the .contiguous() calls.
    def _tiled(X, T, J):
        """(J, b, r) -> (T*J, b, r), X repeated for every row tile."""
        return X[None].expand(T, *X.shape).reshape(T * J, *X.shape[1:]) \
            .contiguous()

    def sample(data, Omega):
        Ua, Va, Uk, Vk, Ui, Vi = (data["Ua"], data["Va"], data["Uk"],
                                  data["Vk"], data["Ui"], data["Vi"])
        T, b = Ua.shape[0], Ua.shape[1]
        J, r = Uk.shape[0], Uk.shape[2]
        s = Omega.shape[-1]
        shared = Omega.dim() == 2
        # A-term: Ya[t] = Ua[t][:, :rank_t] @ (Va[t]^T Omega_t)
        VtOm = (Va.transpose(1, 2) @ Omega).contiguous()
        Ya = ops.batched_gemm(Ua, VtOm, data["ranksA"])
        if shared:
            # Hoisted per-column intermediate, then the fused j-reduction.
            OmJ = Omega.expand(J, b, s).contiguous()
            W2 = ops.tile_chain(Vk, Uk, OmJ)                    # (J, b, s)
            if ldl:
                W2 = W2 * data["dk"][:, :, None]
            Yu = ops.lr_sample(Ui, Vi, W2)
        else:
            Om_r = Omega[:, None].expand(T, J, b, s).reshape(T * J, b, s) \
                .contiguous()
            W2 = ops.tile_chain(_tiled(Vk, T, J), _tiled(Uk, T, J), Om_r)
            if ldl:
                W2 = W2 * _dk_flat(data["dk"], T, J, b)[:, :, None]
            Yu = ops.tile_chain(Ui.reshape(T * J, b, r),
                                Vi.reshape(T * J, b, r), W2)
            Yu = Yu.reshape(T, J, b, s).sum(dim=1)
        return Ya - Yu

    def sample_t(data, Q):
        Ua, Va, Uk, Vk, Ui, Vi = (data["Ua"], data["Va"], data["Uk"],
                                  data["Vk"], data["Ui"], data["Vi"])
        T, b = Ua.shape[0], Ua.shape[1]
        J, r = Uk.shape[0], Uk.shape[2]
        R = Q.shape[-1]
        UtQ = (Ua.transpose(1, 2) @ Q).contiguous()
        Ba = ops.batched_gemm(Va, UtQ, data["ranksA"])
        # S2[t,j] = Vi[t,j] (Ui[t,j]^T Q[t]);  Bu[t] = sum_j Uk[j] (Vk[j]^T S2)
        Q_r = Q[:, None].expand(T, J, b, R).reshape(T * J, b, R).contiguous()
        S2 = ops.tile_chain(Vi.reshape(T * J, b, r),
                            Ui.reshape(T * J, b, r), Q_r)
        if ldl:
            S2 = S2 * _dk_flat(data["dk"], T, J, b)[:, :, None]
        Bu = ops.tile_chain(_tiled(Uk, T, J), _tiled(Vk, T, J), S2)
        Bu = Bu.reshape(T, J, b, R).sum(dim=1)
        return Ba - Bu

    return sample, sample_t


# -- diagonal machinery --------------------------------------------------------


def _diag_update_sum(Uk, Vk, dk=None):
    """sum_j L(k,j) D_j L(k,j)^T as a dense (b, b) block."""
    Vs = Vk if dk is None else Vk * dk[:, :, None]
    G = Vs.transpose(1, 2) @ Vk                      # (J, r, r)
    M = Uk @ G                                       # (J, b, r)
    J, b, r = M.shape
    return (M.transpose(0, 1).reshape(b, J * r)
            @ Uk.transpose(0, 1).reshape(b, J * r).T)


def _schur_compensate(Akk, Dsum, mode: str, eps: float, bs: int, draw):
    """Section 5.1.1: subtract a *compressed* update / diagonal-compensate."""
    b = Akk.shape[0]
    p = ARAParams(bs=min(bs, b), r_max=b, eps=eps)
    Q, B, _, _ = ara_compress_dense(Dsum[None], draw, p)
    Dbar = Q[0] @ B[0].T
    Dbar = 0.5 * (Dbar + Dbar.T)
    if mode == "full":
        return Akk - Dbar
    # "diag": A - D + diag(rowsum |D - Dbar|)   (diagonal compensation [8])
    comp = (Dsum - Dbar).abs().sum(dim=1)
    return Akk - Dsum + torch.diag(comp)


def robust_cholesky(Akk, delta):
    """Dense Cholesky with eigenvalue-clamp fallback (Algorithm 8 analogue):
    where the tile is not numerically SPD, clamp its eigenvalues to
    ``delta`` and factor that. Returns (L, modified?). A non-finite tile
    has no eigenvalues to clamp: its factor is NaN (flagged as modified),
    as the JAX package's fallback returns, so a ``check=True`` run sees it
    as an SPD breakdown."""
    L, info = torch.linalg.cholesky_ex(Akk)
    bad = bool(info.item() != 0)
    if not bad:
        return L, False
    if not bool(torch.isfinite(Akk).all()):
        return torch.full_like(Akk, float("nan")), True
    w, W = torch.linalg.eigh(Akk)
    w = w.clamp(min=delta)
    Amod = (W * w) @ W.T
    Amod = 0.5 * (Amod + Amod.T)
    return torch.linalg.cholesky(Amod), True


def dense_ldlt_tile(Akk):
    """Unpivoted dense LDL^T of one tile: returns unit-lower L and d (b,)."""
    b = Akk.shape[0]
    L = torch.zeros_like(Akk)
    d = Akk.new_zeros((b,))
    ar = torch.arange(b, device=Akk.device)
    tiny = 1e-30
    for j in range(b):
        w = torch.where(ar < j, d * L[j, :], 0.0)
        c = Akk[:, j] - L @ w
        dj = c[j]
        dj = torch.where(dj.abs() < tiny, torch.full_like(dj, tiny), dj)
        col = torch.where(ar > j, c / dj, 0.0)
        col[j] = 1.0
        L[:, j] = col
        d[j] = dj
    return L, d


def _factor_diag_tile(Akk, opts: CholOptions, stats: dict):
    """Dense-factor one (fully updated) diagonal tile. Returns ``(Lkk, dk)``
    with ``dk`` None for Cholesky. Without the modified fallback a tile that
    is not SPD factors to NaN (no host sync), as ``jnp.linalg.cholesky``
    does."""
    if opts.ldl:
        return dense_ldlt_tile(Akk)
    if opts.modified_chol:
        delta = opts.eps * Akk.diagonal().abs().max().clamp(min=1.0)
        Lkk, bad = robust_cholesky(Akk, delta)
        stats["modified_chol"] += int(bad)
        return Lkk, None
    L, info = torch.linalg.cholesky_ex(Akk)
    return torch.where(info == 0, L, torch.full_like(L, float("nan"))), None


# -- health hooks (check=True) -------------------------------------------------


def _jittered(Akk, shift: float):
    """``Akk + shift * scale * I`` -- the escalating-jitter remedy for an
    SPD breakdown. ``scale`` is the tile's max |diag| entry (floored at 1),
    so the shift schedule is relative to the tile's magnitude."""
    scale = Akk.diagonal().abs().max().clamp(min=1.0)
    eye = torch.eye(Akk.shape[-1], dtype=Akk.dtype, device=Akk.device)
    return Akk + shift * scale * eye


def _spd_shift(Akk, rp: RetryPolicy, attempt: int) -> float:
    """Relative jitter for retry ``attempt``: enough to clear the tile's
    most negative eigenvalue (one b x b eigvalsh, failure path only), plus
    the policy's base shift, escalated by ``growth``. A non-finite tile
    gets the bare policy schedule -- no shift fixes a NaN, and the bounded
    ladder is what turns that into a structured breakdown."""
    base = 0.0
    if bool(torch.isfinite(Akk).all()):
        scale = float(Akk.diagonal().abs().max().clamp(min=1.0))
        lam = float(torch.linalg.eigvalsh(Akk).min())
        base = max(0.0, -lam) / scale
    return (base + rp.shift(0)) * rp.growth ** attempt


def _pivots(c: dict, ldl: bool) -> torch.Tensor:
    return c["dk"] if ldl else torch.diagonal(c["Lkk"])


def _diag_steps(col: list, L: TLRMatrix, dvec, opts: CholOptions,
                stats: dict, health: Optional[HealthMonitor]):
    """The diagonal-tile step both drivers share: ``set_diag(k, Lkk, dk)``
    writes a factored tile into the factor and the column state, and
    ``factor_diag(k, Akk)`` factors an updated tile (after the armed
    ``"chol.diag"`` faults), stashing the tile for the jitter retries of
    ``check=True``, where an eigenvalue-clamp repair is itself a health
    event."""

    def set_diag(k: int, Lkk, dk_new) -> None:
        if opts.ldl:
            dvec[k] = dk_new
        L.D[k] = Lkk
        col[k].update(Lkk=Lkk, dk=dk_new)

    def factor_diag(k: int, Akk) -> None:
        if faults.active():
            Akk = faults.corrupt_diag(Akk, k)
        mc0 = stats["modified_chol"]
        set_diag(k, *_factor_diag_tile(Akk, opts, stats))
        if health is not None:
            col[k]["Akk"] = Akk
            if stats["modified_chol"] > mc0:
                health.record("spd_breakdown", k, "diag", remedy="clamp")

    return set_diag, factor_diag


def _diag_check_hook(k: int, col: list, set_diag, opts: CholOptions,
                     stats: dict, health: HealthMonitor):
    """Check hook for a diag stage with no panel after it (the last column
    in either driver): the panel hook elsewhere owns the jitter ladder, so
    the last diagonal gets its own. Retries re-factor the stashed updated
    tile ``col[k]["Akk"]``; exhaustion raises with the column's full remedy
    history."""

    def check():
        c = col[k]
        rp = health.policy
        for attempt in range(rp.max_retries + 1):
            flags = column_flags(_pivots(c, opts.ldl))
            if not (flags[1] > 0 or (not opts.ldl and flags[2] <= 0.0)):
                break
            if attempt >= rp.max_retries:
                health.fail(k, "diag", "spd_breakdown",
                            pivot_index=int(flags[3]),
                            min_pivot=float(flags[2]),
                            nonfinite_pivots=int(flags[1]))
            shift = _spd_shift(c["Akk"], rp, attempt)
            health.record("spd_breakdown", k, "diag", remedy="jitter",
                          attempt=attempt + 1, shift=shift)
            set_diag(k, *_factor_diag_tile(_jittered(c["Akk"], shift),
                                           opts, stats))
        health.columns_checked += 1

    return check


def _final_gate(L: TLRMatrix, dvec, opts: CholOptions,
                health: HealthMonitor):
    """The returned-factors guarantee: one scan over every factor array and
    every pivot before the driver returns. Nothing that reaches the caller
    is non-finite (or non-positive, for Cholesky) -- a failure here is a
    breakdown, never a silently poisoned factorization."""
    if opts.ldl:
        pivots, arrays = dvec.reshape(-1), (L.D, L.U, L.V)
    else:
        pivots = torch.diagonal(L.D, dim1=1, dim2=2).reshape(-1)
        arrays = (L.U, L.V)
    flags = column_flags(pivots, arrays)
    if flags[0] > 0 or flags[1] > 0:
        health.fail(-1, "final", "nonfinite_factor",
                    nonfinite=int(flags[0]), nonfinite_pivots=int(flags[1]))
    if not opts.ldl and flags[2] <= 0.0:
        health.fail(int(flags[3]) // L.b, "final", "spd_breakdown",
                    pivot_index=int(flags[3]) % L.b,
                    min_pivot=float(flags[2]))


# -- inter-tile pivoting (Algorithm 9) -------------------------------------------


def _power_norms(tiles: torch.Tensor, iters: int,
                 x0: torch.Tensor) -> torch.Tensor:
    """Batched power-iteration 2-norm estimates for (T, b, b) symmetric
    tiles, from the (T, b) start vectors ``x0``."""
    x = x0 / torch.linalg.vector_norm(x0, dim=1, keepdim=True)
    for _ in range(iters):
        y = (tiles @ x[:, :, None])[:, :, 0]
        x = y / torch.linalg.vector_norm(y, dim=1,
                                         keepdim=True).clamp(min=1e-300)
    return torch.linalg.vector_norm((tiles @ x[:, :, None])[:, :, 0], dim=1)


def _swap_L_rows(L: TLRMatrix, k: int, pidx: int) -> None:
    """Swap the written L tiles of logical rows k <-> pidx (columns j < k),
    in place: a swap only permutes slots that are already written, so the
    panel's ``index_add_`` into never-written slots stays exact."""
    if k == 0:
        return
    ik = [tril_index(k, j) for j in range(k)]
    ip = [tril_index(pidx, j) for j in range(k)]
    both = torch.as_tensor(ik + ip, device=L.device)
    swapped = torch.as_tensor(ip + ik, device=L.device)
    for X in (L.U, L.V, L.ranks):
        X[both] = X[swapped]


# -- column processing ---------------------------------------------------------


def _build_column_data(A, L, rows, k, perm, dvec, ldl, Tb: int, Jb: int,
                       wA: int | None = None, wL: int | None = None):
    """Operand gather for one column, zero-padded up to bucket sizes;
    ``valid`` marks the real row slots. ``wA`` / ``wL`` (ranked batching)
    are the A-tile and L-tile gather widths, so the sampling chains run at
    the bucketed width instead of ``r_max``."""
    T = len(rows)
    Ui, Vi = _gather_L(L, rows, k, Tb, Jb, wL)
    Uk, Vk = _gather_L_row(L, k, k, Jb, wL)
    Ua, Va, ra = _gather_A_tiles(A, rows, k, perm, Tb, wA)
    return {
        "Ua": Ua, "Va": Va, "ranksA": ra.contiguous(),
        "Uk": Uk, "Vk": Vk, "Ui": Ui, "Vi": Vi,
        "valid": torch.arange(Tb, device=A.device) < T,
        "dk": _pad_axis(dvec[:k], Jb) if ldl else None,
    }


def _trsm(Lkk, dk_new, B, ldl: bool):
    """V(i,k) = L(k,k)^{-1} B_i (paper: batchTrsm); LDL adds D^{-1}."""
    Vnew = torch.linalg.solve_triangular(Lkk, B, upper=False)
    if ldl:
        # L(i,k) = Q B^T (L D)^{-T}  =>  V(i,k) = D^{-1} L^{-1} B
        Vnew = Vnew / dk_new[None, :, None]
    return Vnew


class _ColumnPipeline:
    """The column steps of one factorization: fused column, dynamic ARA
    step, projection and diagonal update. ``shapes`` records the distinct
    operand shapes each step ran at (the JAX package's ``traces`` count
    compiled variants, which are one per shape).

    ``ranked`` picks the sample-then-project fused column (ranked
    batching); ``stream`` is the probe stream the ARA draws from (empty
    for the panel ARA, ``(7000 + attempt,)`` for a rank-overflow re-pass).
    """

    def __init__(self, opts: CholOptions, p: ARAParams, probes: Probes, *,
                 ranked: bool = False, stream: tuple = ()):
        self.opts = opts
        self.p = p
        self.probes = probes
        self.ranked = ranked
        self.stream = stream
        self.sample, self.sample_t = make_column_samplers(opts.ldl)
        self.shapes = {"column": set(), "project": set(), "diag": set()}
        self._column_new = False

    def _mark(self, kind: str, key) -> None:
        if key not in self.shapes[kind]:
            self.shapes[kind].add(key)
            if kind == "column":
                self._column_new = True

    def begin_column(self) -> None:
        self._column_new = False

    @property
    def column_traced(self) -> bool:
        """Did the current column run the ARA step at a new shape?"""
        return self._column_new

    def draw(self, k: int):
        if self.stream:
            return lambda it, shape, dtype, device: self.probes(
                k, it, shape, dtype, device, stream=self.stream)
        return lambda it, shape, dtype, device: self.probes(
            k, it, shape, dtype, device)

    @staticmethod
    def _key(data, *extra):
        """A column step's operand shape: (Tb, Jb, A width, L width)."""
        return (data["Ua"].shape[0], data["Uk"].shape[0],
                data["Ua"].shape[2], data["Uk"].shape[2]) + extra

    def fused_col(self, data, Lkk, dk_new, k: int):
        Tb, b = data["Ua"].shape[0], data["Ua"].shape[1]
        self._mark("column", self._key(data))
        Q, B, ranks, state = run_ara_fused(
            self.sample, self.sample_t, data, self.draw(k), T=Tb, b=b,
            p=self.p, dtype=data["Ua"].dtype, device=data["Ua"].device,
            share_omega=self.opts.share_omega, valid=data["valid"])
        return Q, _trsm(Lkk, dk_new, B, self.opts.ldl), ranks, state

    def fused_sample(self, data, k: int):
        """Ranked batching: sampling only; the projection runs once the
        detected ranks are on the host, against Q at their ladder width."""
        Tb, b = data["Ua"].shape[0], data["Ua"].shape[1]
        self._mark("column", self._key(data, "sample"))
        Q, _, ranks, state = run_ara_fused(
            self.sample, self.sample_t, data, self.draw(k), T=Tb, b=b,
            p=self.p, dtype=data["Ua"].dtype, device=data["Ua"].device,
            share_omega=self.opts.share_omega, valid=data["valid"],
            project=False)
        return Q, ranks, state

    def dyn_step(self, data, state, k: int):
        Tb, b = state.Q.shape[0], state.Q.shape[1]
        self._mark("column", self._key(data))
        return ara_iteration(self.sample, data, state, self.draw(k), self.p,
                             share_omega=self.opts.share_omega, T=Tb, b=b)

    def project(self, data, Q, Lkk, dk_new):
        self._mark("project", self._key(data, Q.shape[0], Q.shape[2]))
        return _trsm(Lkk, dk_new, self.sample_t(data, Q), self.opts.ldl)

    def diag_update(self, Uk, Vk, dk):
        self._mark("diag", (Uk.shape[0], Uk.shape[2]))
        return _diag_update_sum(Uk, Vk, dk)


def _column_ara_fused(pipe: _ColumnPipeline, A, L, rows, k, perm, dvec, Lkk,
                      dk_new, ladder, widths=(None, None)):
    T = len(rows)
    Tb, Jb = _column_buckets(A.nb, k, ladder)
    wA, wL = widths
    data = _build_column_data(A, L, rows, k, perm, dvec, pipe.opts.ldl, Tb,
                              Jb, wA, wL)
    if pipe.ranked:
        # Sample-then-project: the projection chain runs at the rank-ladder
        # width covering the detected ranks, not at r_max (exact -- columns
        # of Q past each tile's rank are zero).
        Q, ranks, state = pipe.fused_sample(data, k)
        wq = bucket_width(ranks[:T], pipe.p.r_max)
        Vnew = pipe.project(data, Q[:, :, :wq].contiguous(), Lkk, dk_new)
        Vnew = _pad_axis(Vnew, pipe.p.r_max, axis=2)
    else:
        wq = None
        Q, Vnew, ranks, state = pipe.fused_col(data, Lkk, dk_new, k)
    info = {"iters": state.it, "err": state.err[:T].cpu().numpy(), "T": T,
            "Tb": Tb, "Jb": Jb, "safety_valve": False, "wQ": wq}
    return Q[:T], Vnew[:T], ranks[:T], info


def _column_ara_dynamic(pipe: _ColumnPipeline, A, L, rows, k, perm, dvec,
                        Lkk, dk_new, ladder, widths=(None, None)):
    """Algorithm 5: rank-sorted subset with converged-tile eviction/refill."""
    opts, p = pipe.opts, pipe.p
    wA, wL = widths
    T_col = len(rows)
    requested = opts.bucket if opts.bucket > 0 else T_col
    requested = min(requested, T_col)
    Tb_col, Jb = _column_buckets(A.nb, k, ladder)
    Tb = _bucket_up(requested, ladder)
    n_slots = min(Tb, T_col)

    # Sort rows by the rank of the original A tile, descending (section 4.2):
    # big tiles stay in the batch longest, so they enter first.
    a_ranks = A.ranks.cpu().numpy()
    pk = int(perm[k])
    key_rank = np.array([a_ranks[tril_index(max(int(perm[i]), pk),
                                            min(int(perm[i]), pk))]
                         for i in rows])
    order = np.argsort(-key_rank, kind="stable")
    queue = [int(rows[o]) for o in order]

    # Slot state: each slot hosts one tile's ARA run; slots past n_slots are
    # permanent padding (pre-converged via the validity mask).
    slot_rows = queue[:n_slots]
    queue = queue[n_slots:]
    data = _build_column_data(A, L, np.asarray(slot_rows), k, perm, dvec,
                              opts.ldl, Tb, Jb, wA, wL)
    state = init_state(Tb, A.b, p, A.dtype, A.device, valid=data["valid"])

    done_Q, done_rank, done_err = {}, {}, {}
    total_iters = 0
    safety_valve = False
    slot_live = [True] * len(slot_rows)

    def record(s, rank_h, err_h):
        done_Q[slot_rows[s]] = state.Q[s]
        done_rank[slot_rows[s]] = int(rank_h[s])
        done_err[slot_rows[s]] = float(err_h[s])

    while any(slot_live):
        state = pipe.dyn_step(data, state, k)
        total_iters += 1
        # One host sync per block iteration: the eviction decisions below
        # need the converged flags (the JAX package syncs here too).
        conv, rank_h, err_h = (t.cpu().numpy() for t in
                               (state.converged, state.rank, state.err))
        # Evict converged tiles; refill their slots from the queue.
        refills = []
        for s, live in enumerate(slot_live):
            if live and conv[s]:
                record(s, rank_h, err_h)
                if queue:
                    slot_rows[s] = queue.pop(0)
                    refills.append(s)
                else:
                    slot_live[s] = False
        if refills:
            sr = torch.as_tensor(refills, dtype=torch.long, device=A.device)
            new_rows = np.asarray([slot_rows[s] for s in refills])
            nd = _build_column_data(A, L, new_rows, k, perm, dvec, opts.ldl,
                                    len(refills), Jb, wA, wL)
            for name in ("Ua", "Va", "ranksA", "Ui", "Vi"):
                data[name].index_copy_(0, sr, nd[name])
            state = dataclasses.replace(
                state,
                Q=state.Q.index_fill(0, sr, 0.0),
                rank=state.rank.index_fill(0, sr, 0),
                converged=state.converged.index_fill(0, sr, False),
                err=state.err.index_fill(0, sr, float("inf")))
        if any(slot_live) and total_iters > p.iters * max(1, T_col):
            # Safety valve: the column's iteration budget is exhausted.
            # Flush the still-live slots with their current partial bases;
            # rows still queued are recorded at rank 0 with an infinite
            # error estimate.
            safety_valve = True
            n_live, n_queued = sum(slot_live), len(queue)
            rank_h, err_h = state.rank.cpu().numpy(), state.err.cpu().numpy()
            for s, live in enumerate(slot_live):
                if live:
                    record(s, rank_h, err_h)
                    slot_live[s] = False
            for i in queue:
                done_Q[i] = torch.zeros_like(state.Q[0])
                done_rank[i] = 0
                done_err[i] = float("inf")
            warnings.warn(
                f"TLR column {k}: ARA safety valve tripped after "
                f"{total_iters} iterations; {n_live} tile(s) kept their "
                f"partial bases and {n_queued} queued tile(s) were "
                f"recorded at rank 0 -- the factorization is degraded "
                f"(raise max_iters/r_max or loosen eps; see "
                f"stats['safety_valve'])", RuntimeWarning, stacklevel=4)
            queue = []
            break

    # Assemble per-row results in the original row order, then project once
    # (batched, bucket-padded full column) into the bases.
    Q_all = torch.stack([done_Q[int(i)] for i in rows])
    ranks_h = np.asarray([done_rank[int(i)] for i in rows], np.int32)
    ranks = torch.as_tensor(ranks_h, device=A.device)
    full_data = _build_column_data(A, L, rows, k, perm, dvec, opts.ldl,
                                   Tb_col, Jb, wA, wL)
    if pipe.ranked:
        # Project at the rank-ladder width covering the detected ranks.
        wq = bucket_width(ranks_h, p.r_max)
        Vnew = pipe.project(full_data, _pad_axis(Q_all[:, :, :wq], Tb_col),
                            Lkk, dk_new)
        Vnew = _pad_axis(Vnew, p.r_max, axis=2)
    else:
        wq = None
        Vnew = pipe.project(full_data, _pad_axis(Q_all, Tb_col), Lkk, dk_new)
    info = {"iters": total_iters, "T": T_col, "Tb": Tb, "Jb": Jb,
            "err": np.asarray([done_err[int(i)] for i in rows]),
            "safety_valve": safety_valve, "wQ": wq}
    return Q_all, Vnew[:T_col], ranks, info


# -- main drivers ---------------------------------------------------------------


def tlr_cholesky(A: TLRMatrix, opts: CholOptions) -> TLRFactorization:
    """TLR Cholesky: left-looking (Algorithm 6; Algorithm 9 when pivoting)
    or, with ``opts.algo="right"``, right-looking."""
    return _dispatch(A, dataclasses.replace(opts, ldl=False))


def tlr_ldlt(A: TLRMatrix, opts: CholOptions) -> TLRFactorization:
    """TLR LDL^T (Algorithm 10; right-looking with ``opts.algo="right"``).
    Pivoting is undefined for LDL^T (paper 5.3) and Schur compensation is
    off."""
    if opts.pivot is not None:
        raise ValueError("inter-tile pivoting is not defined for LDL^T "
                         "(section 5.3)")
    return _dispatch(A, dataclasses.replace(opts, ldl=True, schur=None))


def _dispatch(A: TLRMatrix, opts: CholOptions) -> TLRFactorization:
    _validate(opts)
    driver = _factorize_right if opts.algo == "right" else _factorize
    if not obs.enabled():
        return driver(A, opts)
    # Telemetry: one root span per factorization; its subtree becomes the
    # ``stats["telemetry"]`` metrics snapshot (per-phase FLOP/s,
    # padded-vs-useful ratios), with the plan-level analytic ratio from
    # ``stats["policy"]`` copied alongside for parity checks, and the
    # dispatch-shape registry folded in as a counter sample.
    mesh = tile_mesh()
    sched = "lookahead" if (opts.lookahead and opts.algo == "right") \
        else "sequential"
    with obs.span("chol.factorize", cat="factor", algo=opts.algo,
                  nb=A.nb, b=A.b, schedule=sched,
                  devices=(mesh.size() if mesh is not None else 1),
                  mesh=(str(dict(zip(mesh.mesh_dim_names, mesh.shape)))
                        if mesh is not None else "")) as root:
        fact = driver(A, opts)
    obs.record_retraces()
    snap = obs.metrics_snapshot(root=root)
    snap["padded_flop_ratio_plan"] = fact.stats["policy"]["padded_flop_ratio"]
    fact.stats["telemetry"] = snap
    return fact


def _factorize(A: TLRMatrix, opts: CholOptions) -> TLRFactorization:
    nb, b = A.nb, A.b
    r_out = opts.r_max_out or A.r_max
    p = opts.ara_params(r_out)
    probes = opts.probes or torch_probes(opts.seed)
    policy = resolve_policy(opts.batching, tile_plan(A.ranks, A.r_max),
                            b=b, dtype=A.dtype, right_flush=opts.right_flush)
    batching = policy["batching"]
    ranked = batching == "ranked"

    Lout = zeros_like_structure(nb, b, r_out, A.dtype, A.device)
    # Under a tile mesh the left driver runs replicated on every rank; of
    # the JAX package's sharding of Lout's stacks (``preserve_shape``) only
    # the mesh's indivisibility mode applies.
    tile_batch_rows(Lout.U.shape[0], preserve_shape=True)
    dvec = A.D.new_zeros((nb, b)) if opts.ldl else None
    perm = np.arange(nb)
    ladder = _bucket_ladder(nb - 1)
    pipe = _ColumnPipeline(opts, p, probes, ranked=ranked)
    # Ranked batching: the A-tile gather width is fixed by A's ranks; the
    # L-tile gather width follows the running max of the written factor
    # ranks (monotone up the ladder, so it changes at most ~log2(r_max)
    # times over the whole factorization).
    wA = bucket_width(tile_plan(A.ranks, A.r_max).ranks_host, A.r_max) \
        if ranked else None
    wL = [1 if ranked else None]
    # Pivoting keeps every remaining logical row's running diagonal-update
    # sum sum_j L(i,j) L(i,j)^T (section 5.2): (nb, b, b) on the device.
    Dsum_all = A.D.new_zeros((nb, b, b)) if opts.pivot else None
    stats = {
        "column_iters": [], "column_ranks": [], "modified_chol": 0,
        "pivots": [], "mode": opts.mode,
        "impl": "cuda" if A.D.is_cuda else "plain", "algo": "left",
        "bucket_ladder": list(ladder), "column_events": [],
        "column_traces": 0, "project_traces": 0, "diag_traces": 0,
        "safety_valve": False, "batching": batching, "policy": policy,
    }
    health = HealthMonitor(opts.retry, "left", nb) if opts.check else None
    # Rank-overflow remedies re-run the failing rows' ARA pass, fused and
    # flat, at a loosened eps, one pipeline per escalation level.
    retry_pipes: dict[int, _ColumnPipeline] = {}

    def _retry_pipe(attempt: int) -> _ColumnPipeline:
        if attempt not in retry_pipes:
            o2 = dataclasses.replace(
                opts, eps=opts.retry.eps_at(opts.eps, attempt),
                mode="fused", batching="flat", check=False)
            retry_pipes[attempt] = _ColumnPipeline(
                o2, o2.ara_params(r_out), probes, stream=(7000 + attempt,))
        return retry_pipes[attempt]

    # Column state the stage closures share; the factor stacks are written
    # in place (``index_add_`` of each panel, ``copy_`` of each diagonal
    # tile). The column graph is a serial chain -- diag(k) and panel(k)
    # both gather every previously written L column -- so only the
    # sequential schedule is legal (``opts.lookahead`` is recorded, as in
    # the JAX package).
    col = [{} for _ in range(nb)]

    set_diag, factor_diag = _diag_steps(col, Lout, dvec, opts, stats,
                                        health)

    def _diag_stage(k: int):
        def fn():
            if opts.pivot:
                # Pivot selection and swap (Algorithm 9 lines 11-14).
                rest = torch.as_tensor(perm[k:], device=A.device)
                cand = A.D[rest] - Dsum_all[k:]
                if opts.pivot == "frobenius":
                    norms = torch.linalg.matrix_norm(cand)
                else:
                    x0 = probes(k, None, (nb - k, b), A.dtype, A.device)
                    norms = _power_norms(cand, 10, x0)
                pidx = k + int(torch.argmax(norms))
                stats["pivots"].append(pidx)
                if pidx != k:
                    perm[[k, pidx]] = perm[[pidx, k]]
                    Dsum_all[[k, pidx]] = Dsum_all[[pidx, k]]
                    _swap_L_rows(Lout, k, pidx)
            with obs.span("chol.diag", cat="factor", k=k):
                Akk = A.D[int(perm[k])]
                if k > 0:
                    Uk, Vk = _gather_L_row(Lout, k, k, k, wL[0])
                    dk = dvec[:k] if opts.ldl else None
                    Dsum = pipe.diag_update(Uk, Vk, dk)
                    if opts.schur and not opts.ldl:
                        Akk = _schur_compensate(Akk, Dsum, opts.schur,
                                                opts.eps, opts.bs,
                                                pipe.draw(k))
                    else:
                        Akk = Akk - Dsum
                factor_diag(k, Akk)

        return fn

    def _densify_rows(rows_bad, k, Lkk, dk_new):
        """Last-resort rank-overflow remedy: exact tile expressions via an
        identity probe through the sampling chain, then the *optimal*
        rank-``r_out`` truncation (batched SVD). Factor columns past each
        tile's detected rank are zeroed (the storage invariant)."""
        _, Jb = _column_buckets(A.nb, k, ladder)
        Tb = _bucket_up(len(rows_bad), ladder)
        data = _build_column_data(A, Lout, rows_bad, k, perm, dvec, opts.ldl,
                                  Tb, Jb, wA, wL[0])
        eye = torch.eye(b, dtype=A.dtype, device=A.device)
        E = pipe.sample(data, eye)[:len(rows_bad)]
        Us, S, Vh = torch.linalg.svd(E, full_matrices=False)
        keep = min(r_out, b)
        Qd = Us[:, :, :keep]
        Bd = Vh[:, :keep, :].transpose(1, 2) * S[:, None, :keep]
        tol = S[:, :1] * torch.finfo(A.dtype).eps * b
        rd = (S > tol).sum(dim=1).clamp(max=keep).to(torch.int32)
        mask = torch.arange(keep, device=A.device)[None, None, :] \
            < rd[:, None, None]
        Qd = torch.where(mask, Qd, 0.0)
        Bd = torch.where(mask, Bd, 0.0)
        Vd = _trsm(Lkk, dk_new, Bd, opts.ldl)
        ed = S[:, keep].cpu().numpy().astype(float) if keep < b \
            else np.zeros(len(rows_bad))
        return (_pad_axis(Qd, r_out, axis=2), _pad_axis(Vd, r_out, axis=2),
                rd, ed)

    def _repair_column(k, rows, compute, Q, Vnew, ranks, ranks_h, info):
        """The panel-boundary decision tree: jitter escalation on SPD
        breakdown, hard failure on non-finite panel output, eps-loosen +
        densify on rank overflow."""
        rp = health.policy
        c = col[k]
        # -- SPD breakdown: escalate diagonal jitter, redo diag + panel --
        for attempt in range(rp.max_retries + 1):
            flags = column_flags(_pivots(c, opts.ldl), (Q, Vnew))
            if not (flags[1] > 0 or (not opts.ldl and flags[2] <= 0.0)):
                break
            if attempt >= rp.max_retries:
                health.fail(k, "panel", "spd_breakdown",
                            pivot_index=int(flags[3]),
                            min_pivot=float(flags[2]),
                            nonfinite_pivots=int(flags[1]))
            shift = _spd_shift(c["Akk"], rp, attempt)
            health.record("spd_breakdown", k, "panel", remedy="jitter",
                          attempt=attempt + 1, shift=shift)
            set_diag(k, *_factor_diag_tile(_jittered(c["Akk"], shift),
                                           opts, stats))
            Q, Vnew, ranks, ranks_h, info = compute()
        # -- non-finite panel output with healthy pivots: unrecoverable --
        if flags[0] > 0:
            health.fail(k, "panel", "nonfinite_panel",
                        nonfinite=int(flags[0]))
        # -- rank overflow: eps-loosened re-pass, then densify -----------
        err_h = np.asarray(info["err"], float).copy()
        over = rank_overflow(ranks_h, err_h, p)
        for attempt in range(1, rp.max_retries + 1):
            if not over.any():
                break
            eps_a = rp.eps_at(opts.eps, attempt)
            pos = np.nonzero(over)[0]
            health.record("rank_overflow", k, "panel",
                          remedy="eps_loosen", attempt=attempt,
                          rows=[int(rows[i]) for i in pos], eps=eps_a)
            Qb, Vb, rb, ib = _column_ara_fused(
                _retry_pipe(attempt), A, Lout, rows[pos], k, perm, dvec,
                c["Lkk"], c["dk"], ladder, widths=(wA, wL[0]))
            posj = torch.as_tensor(pos, device=A.device)
            Q = Q.index_copy(0, posj, Qb)
            Vnew = Vnew.index_copy(0, posj, Vb)
            ranks = ranks.index_copy(0, posj, rb.to(ranks.dtype))
            ranks_h = ranks.cpu().numpy()
            err_h[pos] = np.asarray(ib["err"], float)
            over[:] = False
            over[pos] = rank_overflow(ranks_h[pos], err_h[pos],
                                      dataclasses.replace(p, eps=eps_a))
        if over.any() and rp.densify:
            pos = np.nonzero(over)[0]
            health.record("rank_overflow", k, "panel", remedy="densify",
                          rows=[int(rows[i]) for i in pos])
            Qd, Vd, rd, ed = _densify_rows(rows[pos], k, c["Lkk"], c["dk"])
            posj = torch.as_tensor(pos, device=A.device)
            Q = Q.index_copy(0, posj, Qd)
            Vnew = Vnew.index_copy(0, posj, Vd)
            ranks = ranks.index_copy(0, posj, rd.to(ranks.dtype))
            ranks_h = ranks.cpu().numpy()
            err_h[pos] = ed
            over[:] = False
            over[pos] = ~(ed <= rp.eps_floor(opts.eps))
        if over.any():
            pos = np.nonzero(over)[0]
            health.fail(k, "panel", "rank_overflow",
                        rows=[int(rows[i]) for i in pos],
                        err=[float(err_h[i]) for i in pos],
                        eps_floor=rp.eps_floor(opts.eps))
        info = dict(info, err=err_h)
        return Q, Vnew, ranks, ranks_h, info

    def _panel_stage(k: int):
        rows = np.arange(k + 1, nb)
        tidx = torch.as_tensor(rows * (rows - 1) // 2 + k, device=A.device)

        def compute():
            Lkk, dk_new = col[k]["Lkk"], col[k]["dk"]
            pipe.begin_column()
            run = _column_ara_fused if opts.mode == "fused" \
                else _column_ara_dynamic
            with obs.span("chol.panel", cat="factor", k=k) as psp:
                Q, Vnew, ranks, info = run(pipe, A, Lout, rows, k, perm,
                                           dvec, Lkk, dk_new, ladder,
                                           (wA, wL[0]))
                if faults.active():
                    Q = faults.corrupt_panel(Q, k)
                info["wL"] = wL[0]
                ranks_h = ranks.cpu().numpy()
                if obs.enabled():
                    psp.set(T=info["T"], Tb=info["Tb"], Jb=info["Jb"],
                            iters=info["iters"],
                            rank_hist=obs.rank_hist(ranks_h, r_out))
            return Q, Vnew, ranks, ranks_h, info

        def commit(Q, Vnew, ranks, ranks_h, info, t0):
            if ranked:
                wL[0] = max(wL[0], bucket_width(ranks_h, r_out))
            stats["column_iters"].append(info["iters"])
            stats["column_ranks"].append(ranks_h)
            stats["safety_valve"] |= info["safety_valve"]
            stats["column_events"].append({
                "k": k, "T": info["T"], "Tb": info["Tb"], "Jb": info["Jb"],
                "seconds": time.perf_counter() - t0,
                "traced": pipe.column_traced,
                "err": np.asarray(info["err"]), "wQ": info["wQ"],
                "wA": wA, "wL": info["wL"],
            })
            # Panel scatter: every packed-lower slot is written exactly once
            # across the factorization (a pivot swap only permutes written
            # slots), so adding into the zero stacks is a write.
            Lout.U.index_add_(0, tidx, Q)
            Lout.V.index_add_(0, tidx, Vnew)
            Lout.ranks.index_add_(0, tidx, ranks.to(Lout.ranks.dtype))
            if opts.pivot:
                # Dsum_all[i] += L(i,k) L(i,k)^T for the remaining rows.
                G = Vnew.transpose(1, 2) @ Vnew
                Dsum_all[k + 1:] += (Q @ G) @ Q.transpose(1, 2)

        def fn():
            t0 = time.perf_counter()
            out = compute()
            if health is None:
                commit(*out, t0)
            else:
                # Defer the commit to the check hook: the scatter is an
                # add, so it must run exactly once -- after validation has
                # settled the panel's final content.
                col[k]["pending"] = (out, t0)

        def check():
            out, t0 = col[k].pop("pending")
            commit(*_repair_column(k, rows, compute, *out), t0)
            health.columns_checked += 1

        return fn, (check if health is not None else None)

    stages = []
    for k in range(nb):
        # The last column has no panel stage, so its pivots get their own
        # boundary check; every other diag is validated by the following
        # panel's hook (which owns the jitter + recompute ladder).
        dcheck = _diag_check_hook(k, col, set_diag, opts, stats, health) \
            if health is not None and k + 1 >= nb else None
        stages.append(Stage(
            name=f"diag:{k}", kind="diag", k=k, fn=_diag_stage(k),
            check=dcheck,
            reads=(("L", k - 1),) if k else (), writes=(("Lkk", k),),
            seq=len(stages)))
        if k + 1 < nb:
            pfn, pcheck = _panel_stage(k)
            stages.append(Stage(
                name=f"panel:{k}", kind="panel", k=k, fn=pfn, check=pcheck,
                reads=(("L", k - 1), ("Lkk", k)), writes=(("L", k),),
                seq=len(stages)))
    sched = run_graph(stages, SequentialSchedule())
    sched["requested_lookahead"] = bool(opts.lookahead)
    stats["schedule"] = sched
    stats["column_traces"] = len(pipe.shapes["column"])
    stats["project_traces"] = len(pipe.shapes["project"])
    stats["diag_traces"] = len(pipe.shapes["diag"])
    if health is not None:
        _final_gate(Lout, dvec, opts, health)
        stats["health"] = health.summary()
    return TLRFactorization(L=Lout, d=dvec, perm=perm, stats=stats)


# -- right-looking driver ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The lookahead schedule's second CUDA stream, one per device for the
    process: the caching allocator keeps its blocks per stream, so a new
    stream per factorization would allocate its tails' memory anew."""
    return torch.cuda.Stream(device=device)


def _factorize_right(A: TLRMatrix, opts: CholOptions) -> TLRFactorization:
    """Right-looking TLR Cholesky / LDL^T on the batched tile algebra (port
    of ``repro/core/cholesky.py:1204-1623``).

    Per column: factor the (already fully updated) dense diagonal tile,
    round + TRSM the column's accumulated panel, then push the column's
    rank-r Schur update onto the trailing matrix (``tlr_syrk_column``).
    Trailing tiles carry growing concatenated factors; a rounding pass over
    the whole grid compacts them whenever the next append would overflow
    the accumulation width. No sampling chain, no ARA: ``mode`` / ``bs`` /
    ``share_omega`` / ``schur`` are left-looking knobs and are ignored
    here.

    Flat batching tracks one uniform first-free column ``used`` (every
    tile (i, j) with j > k receives one rank-r_p append per factored
    column). Ranked batching tracks each tile's content width ``tile_w``
    on the host: appends land at the tile's own width, at the panel's
    bucketed rank ``wk <= r_p`` (0 for a rank-0 panel, whose update is
    skipped), so the window fills ~r_max / wk times slower, and the panel
    and flush roundings run per rank bucket (``core/batching.py``).

    ``lookahead`` splits each column's update into ``update_head`` (column
    k+1's tiles and D[k+1]) and ``update_tail`` (the rest) and runs the
    ``LookaheadSchedule``. The parts write disjoint tiles, so on the card
    every tail runs on a second CUDA stream: it waits for its head's event,
    and the next head (and any flush) waits for the tail's event, because
    both write column k+2's tiles and D[k+2]. The panel reads nothing back
    to the host (its ranks and error estimates are read at the column's
    first update, and index copies to the card do not block), so tail(k)
    is enqueued while panel(k+1) still runs and overlaps it. On the CPU the
    order is the whole change.
    """
    nb, b = A.nb, A.b
    nt = A.U.shape[0]
    r_p = opts.r_max_out or A.r_max
    policy = resolve_policy(opts.batching, tile_plan(A.ranks, A.r_max),
                            b=b, dtype=A.dtype, right_flush=opts.right_flush)
    batching = policy["batching"]
    ranked = batching == "ranked"
    flush_cols = policy["right_flush"]
    w_acc = max(b, A.r_max) + flush_cols * r_p
    lookahead = bool(opts.lookahead) and nb > 1
    side = _side_stream(A.device) if lookahead and A.D.is_cuda else None

    # Accumulation buffers: every off-diagonal tile's running low-rank
    # concatenation, seeded with A's factors and updated in place.
    # In the working precision even when A's factors are stored lower.
    # Under a tile mesh the tile axis is padded to the mesh's sharding
    # quantum (``pad_tile_batch``; the pad tiles are zero, of width 0, and
    # nothing indexes them) and each rank holds only its block ``held``:
    # the flushes round local rows, the SYRK appends to local tiles, and a
    # panel gathers its column's tiles across the ranks. The diagonal
    # tiles, the panels and the factor stay replicated.
    mesh = tile_mesh()
    nt_p = pad_tile_batch(nt)
    _, held = tile_batch_rows(nt_p)
    sharded = len(held) < nt_p
    syrk_rows = held if sharded else None
    # D and the factor stay replicated, under the mesh's indivisibility
    # mode all the same (the JAX package shards them when they divide).
    tile_batch_rows(nb, preserve_shape=True)
    tile_batch_rows(nt, preserve_shape=True)
    accU = A.D.new_zeros((len(held), b, w_acc))
    accV = A.D.new_zeros((len(held), b, w_acc))
    seed = slice(held.start, min(held.stop, nt))
    accU[:seed.stop - seed.start, :, :A.r_max] = A.U[seed]
    accV[:seed.stop - seed.start, :, :A.r_max] = A.V[seed]
    if ranked:
        tile_w = np.zeros(nt_p, np.int64)
        tile_w[:nt] = tile_plan(A.ranks, A.r_max).ranks_host
    else:
        tile_w = None
    pairs_np = tril_pairs(nb)
    Lout = zeros_like_structure(nb, b, r_p, A.dtype, A.device)
    dvec = A.D.new_zeros((nb, b)) if opts.ldl else None
    ladder = _bucket_ladder(nb - 1)
    stats = {
        "column_iters": [], "column_ranks": [], "modified_chol": 0,
        "pivots": [], "mode": opts.mode,
        "impl": "cuda" if A.D.is_cuda else "plain", "algo": "right",
        "bucket_ladder": list(ladder), "column_events": [],
        "column_traces": 0, "project_traces": 0, "diag_traces": 0,
        "safety_valve": False, "flushes": 0, "acc_width": w_acc,
        "batching": batching, "append_widths": [], "policy": policy,
        # this rank's accumulator bytes, per buffer (accU; accV the same)
        "acc_bytes": accU.numel() * accU.element_size(),
        "tile_rows": [held.start, held.stop, nt_p],
    }
    health = HealthMonitor(opts.retry, "right", nb) if opts.check else None
    # The trailing diagonal tiles are updated in place: work on a copy so
    # the caller's operator stays as it was.
    D = A.D.clone()
    st = {"used": A.r_max, "tile_w": tile_w}
    col = [{} for _ in range(nb)]
    panel_shapes: set[int] = set()

    set_diag, factor_diag = _diag_steps(col, Lout, dvec, opts, stats,
                                        health)

    def _diag_stage(k: int):
        def fn():
            with obs.span("chol.diag", cat="factor", k=k):
                factor_diag(k, D[k])

        return fn

    def _host_panel(c: dict) -> None:
        """The panel's ranks and error estimates on the host, and its
        append width ``wk`` (read once, at the column's first update)."""
        if "ranks_h" in c:
            return
        ranks_h = c["ranks"].cpu().numpy()
        psp = c.pop("psp")
        if obs.enabled():
            # The panel span closed before this read; its args are the
            # recorded span's, so the histogram still lands on it.
            psp.set(rank_hist=obs.rank_hist(ranks_h, r_p))
        # A rank-0 panel contributes an exactly-zero Schur update, so the
        # ranked trailing update skips it: no append, no growth.
        wk = (bucket_width(ranks_h, r_p) if int(ranks_h.max(initial=0))
              else 0) if ranked else r_p
        c.update(ranks_h=ranks_h, err_h=c["err"].cpu().numpy(), wk=wk)

    def _column_tiles(tidx_np: np.ndarray, tidx: torch.Tensor, width: int):
        """Column tiles ``tidx`` of both accumulators at full width. Under a
        tile mesh, gathered across the ranks at the live ``width`` and
        zero-extended, so the panel rounds the same input as on one
        device."""
        if not sharded:
            return accU[tidx], accV[tidx]
        return tuple(
            torch.nn.functional.pad(
                gather_rows(acc[:, :, :width], held, tidx_np, mesh),
                (0, w_acc - width))
            for acc in (accU, accV))

    def _panel_stage(k: int):
        # One rounding pass over the column's accumulated tiles (row batch
        # padded up the bucket ladder, as in the JAX package; per rank
        # bucket under ranked batching), batched TRSM, then the in-place
        # scatter of the panel into the factor.
        rows = np.arange(k + 1, nb)
        T = len(rows)
        Tb = _bucket_up(T, ladder)
        tidx_np = rows * (rows - 1) // 2 + k
        tidx = torch.as_tensor(tidx_np, device=A.device)
        c = col[k]

        def compute():
            with obs.span("chol.panel", cat="factor", k=k, T=T,
                          Tb=Tb) as psp:
                if ranked:
                    tw = st["tile_w"][tidx_np]
                    aU, aV = _column_tiles(tidx_np, tidx,
                                           int(tw.max(initial=0)))
                    Q, B, ranks, err = bucketed_round_tiles(
                        aU, aV, tw, opts.eps, r_out=r_p)
                else:
                    # Under lookahead the previous column's head has
                    # appended past ``used``, which its tail advances.
                    aU, aV = _column_tiles(
                        tidx_np, tidx,
                        min(st["used"] + (r_p if lookahead else 0), w_acc))
                    Q, B, ranks, err = tlr_round_tiles(
                        _pad_axis(aU, Tb), _pad_axis(aV, Tb), opts.eps,
                        r_out=r_p)
                Vn = _trsm(c["Lkk"], c["dk"], B, opts.ldl)
                Qs = Q[:T]
                if faults.active():
                    Qs = faults.corrupt_panel(Qs, k)
            # The ranks reach the host at the column's first update
            # (``_host_panel``), which sets the span's rank histogram.
            c["psp"] = psp
            return Qs, Vn[:T], ranks[:T], err[:T]

        def commit(Qs, Vns, ranks, err):
            Lout.U.index_add_(0, tidx, Qs)
            Lout.V.index_add_(0, tidx, Vns)
            Lout.ranks.index_add_(0, tidx, ranks)
            c.update(Qs=Qs, Vns=Vns, ranks=ranks, err=err, T=T, Tb=Tb)

        def repair(Qs, Vns, ranks, err):
            rp = health.policy
            # -- SPD breakdown: jitter the stashed diagonal, redo the panel
            # (its accumulated tiles are not written again before the
            # next update stage, which runs after this hook).
            for attempt in range(rp.max_retries + 1):
                flags = column_flags(_pivots(c, opts.ldl), (Qs, Vns),
                                     ranks=ranks, err=err, r_cap=r_p,
                                     eps=opts.eps)
                if not (flags[1] > 0 or (not opts.ldl and flags[2] <= 0.0)):
                    break
                if attempt >= rp.max_retries:
                    health.fail(k, "panel", "spd_breakdown",
                                pivot_index=int(flags[3]),
                                min_pivot=float(flags[2]),
                                nonfinite_pivots=int(flags[1]))
                shift = _spd_shift(c["Akk"], rp, attempt)
                health.record("spd_breakdown", k, "panel", remedy="jitter",
                              attempt=attempt + 1, shift=shift)
                set_diag(k, *_factor_diag_tile(_jittered(c["Akk"], shift),
                                               opts, stats))
                Qs, Vns, ranks, err = compute()
            if flags[0] > 0:
                health.fail(k, "panel", "nonfinite_panel",
                            nonfinite=int(flags[0]))
            if flags[4] > 0:
                # Rank overflow. Unlike the left driver there is no looser
                # re-pass worth making: the rounding pass *is* the optimal
                # rank-r_p truncation of the accumulated column (batched
                # SVD), so a tile over the cap is accepted at its achieved
                # error if that error clears the policy's eps floor, and is
                # a breakdown otherwise.
                ranks_h = ranks.cpu().numpy()
                err_h = err.cpu().numpy().astype(float)
                over = rank_overflow(ranks_h, err_h,
                                     ARAParams(r_max=r_p, eps=opts.eps))
                pos = np.nonzero(over)[0]
                floor = rp.eps_floor(opts.eps)
                health.record("rank_overflow", k, "panel", remedy="accept",
                              rows=[int(rows[i]) for i in pos],
                              err=[float(err_h[i]) for i in pos])
                hard = [i for i in pos if not (err_h[i] <= floor)]
                if hard:
                    health.fail(k, "panel", "rank_overflow",
                                rows=[int(rows[i]) for i in hard],
                                err=[float(err_h[i]) for i in hard],
                                eps_floor=floor)
            return Qs, Vns, ranks, err

        def fn():
            c["t0"] = time.perf_counter()
            c["bt0"] = batching_trace_count()
            c["traced"] = Tb not in panel_shapes
            panel_shapes.add(Tb)
            out = compute()
            if health is None:
                commit(*out)
            else:
                # Defer the scatter (an add) to the check hook so it runs
                # exactly once, on the panel's settled content.
                c["pending"] = out

        def check():
            commit(*repair(*c.pop("pending")))
            health.columns_checked += 1

        return fn, (check if health is not None else None)

    def _flush(k: int) -> None:
        # Recompress every tile's accumulated concatenation back to width b
        # in one rounding pass over the whole grid (tiles of factored
        # columns are dead; rounding them too keeps one batch shape, as in
        # the JAX package): one r_max-wide batch, or one per rank bucket
        # of the tracked content widths. Under a tile mesh each rank rounds
        # its own rows, and the ranked widths are gathered so that every
        # rank keeps the whole host array.
        with obs.span("chol.flush", cat="factor", k=k):
            if ranked:
                Uc, Vc, rc, _ = bucketed_round_tiles(
                    accU, accV, st["tile_w"][held.start:held.stop],
                    opts.eps, r_out=b)
                if sharded:
                    rc = gather_rows(rc, held, np.arange(nt_p), mesh)
                st["tile_w"] = rc.cpu().numpy().astype(np.int64)
            else:
                Uc, Vc, _, _ = tlr_round_tiles(accU, accV, opts.eps,
                                               r_out=b)
                st["used"] = b
            accU.zero_()
            accV.zero_()
            accU[:, :, :b] = Uc
            accV[:, :, :b] = Vc
        stats["flushes"] += 1

    def _update_stage(k: int, part: str):
        # ``part="all"`` is the sequential schedule's single node; "head" /
        # "tail" split it for the lookahead schedule (head: column k+1's
        # tiles + D[k+1]; tail: the pair-grid rest).
        c = col[k]
        trail = np.nonzero(pairs_np[:, 1] > k)[0]
        bump = {"all": trail,
                "head": np.nonzero(pairs_np[:, 1] == k + 1)[0],
                "tail": np.nonzero(pairs_np[:, 1] > k + 1)[0]}[part]
        on_side = part == "tail" and side is not None

        def fn():
            if part != "tail":
                _host_panel(c)
                if side is not None and k > 0:
                    # Column k-1's tail writes column k+1's tiles and
                    # D[k+1] too: this head (and its flush) follows it.
                    torch.cuda.current_stream(A.device).wait_event(
                        col[k - 1].pop("tail_done"))
            wk, T = c["wk"], c["T"]
            Qs, Vns, ranks, dk = c["Qs"], c["Vns"], c["ranks"], c["dk"]
            ctx = contextlib.nullcontext()
            if on_side:
                side.wait_event(c.pop("head_done"))
                # The panel's tensors were made on the main stream: keep
                # their memory from being reused before the tail is done.
                for t in (Qs, Vns, ranks, dk):
                    if t is not None:
                        t.record_stream(side)
                ctx = torch.cuda.stream(side)
            with ctx:
                if ranked:
                    if wk and part != "tail":
                        # Flush before the column's first append when it
                        # would overflow the widest trailing tile's window
                        # (head and tail append wk to disjoint tiles, so
                        # one check covers both).
                        tw = st["tile_w"]
                        high = int(tw[trail].max()) if trail.size else 0
                        if high + wk > w_acc:
                            _flush(k)
                    if wk:
                        with obs.span("chol.syrk", cat="factor", k=k, wk=wk,
                                      T=T, part=part):
                            tlr_syrk_column(accU, accV, st["tile_w"], D,
                                            Qs[:, :, :wk], Vns[:, :, :wk],
                                            ranks, dk, k, part=part,
                                            rows=syrk_rows)
                        st["tile_w"][bump] += wk
                else:
                    if part != "tail" and st["used"] + r_p > w_acc:
                        _flush(k)
                    with obs.span("chol.syrk", cat="factor", k=k, wk=wk,
                                  T=T, part=part):
                        tlr_syrk_column(accU, accV, st["used"], D, Qs, Vns,
                                        ranks, dk, k, part=part,
                                        rows=syrk_rows)
                    if part != "head":
                        st["used"] += r_p
            if side is not None:
                ev = torch.cuda.Event()
                ev.record(side if on_side
                          else torch.cuda.current_stream(A.device))
                c["tail_done" if on_side else "head_done"] = ev
            if part == "head":
                return
            if part == "all":
                # Drain the column's work before timing it (the JAX
                # sequential driver blocks here too); the lookahead
                # schedule syncs once, after the graph. The span makes the
                # host-sync gap visible.
                with obs.span("chol.sync", cat="factor", k=k):
                    if D.is_cuda:
                        torch.cuda.synchronize(D.device)
            if ranked:
                stats["append_widths"].append(wk)
            stats["column_iters"].append(1)
            stats["column_ranks"].append(c["ranks_h"])
            stats["column_events"].append({
                "k": k, "T": T, "Tb": c["Tb"], "Jb": 0,
                "seconds": time.perf_counter() - c["t0"],
                "traced": c["traced"] or batching_trace_count() > c["bt0"],
                "err": c["err_h"], "wQ": wk if ranked else None,
            })
            for key in ("Qs", "Vns", "ranks", "err"):
                c.pop(key)

        return fn

    def _update_check_hook(k: int):
        # Sequential schedule only: the "all" update already drains the
        # column's work, so the trailing-diagonal scan rides that sync.
        # Under lookahead the updates stay unchecked to keep the overlap --
        # the next panel's hook and the final gate keep the no-NaN
        # guarantee.
        def check():
            flags = column_flags(torch.diagonal(D, dim1=1, dim2=2)
                                 .reshape(-1))
            if flags[1] > 0:
                health.fail(k, "update", "nonfinite_update",
                            nonfinite=int(flags[1]))

        return check

    # Stage graph of the JAX package's right-looking driver. Tokens are
    # versioned values: ("acc", k) / ("Dv", k) is the accumulation /
    # diagonal state after column k's full trailing update, ("acch", k) /
    # ("Dh", k) the state after its head only. The update stages overwrite
    # the buffers in place (``destroys``), which orders them after every
    # other reader -- under lookahead exactly what lets panel(k+1) read
    # column k+1's tiles before update_tail(k) writes the others.
    stages = []

    def add(name, kind, k, fn, reads=(), writes=(), destroys=(),
            check=None):
        stages.append(Stage(name=name, kind=kind, k=k, fn=fn, check=check,
                            reads=tuple(reads), writes=tuple(writes),
                            destroys=tuple(destroys), seq=len(stages)))

    for k in range(nb):
        dtok = ("Dh", k - 1) if lookahead else ("Dv", k - 1)
        add(f"diag:{k}", "diag", k, _diag_stage(k),
            reads=[dtok] if k else [], writes=[("Lkk", k)],
            check=_diag_check_hook(k, col, set_diag, opts, stats, health)
            if health is not None and k + 1 >= nb else None)
        if k + 1 >= nb:
            continue
        atok = ("acch", k - 1) if lookahead else ("acc", k - 1)
        pfn, pcheck = _panel_stage(k)
        add(f"panel:{k}", "panel", k, pfn,
            reads=([atok] if k else []) + [("Lkk", k)],
            writes=[("panel", k)], check=pcheck)
        prev = [("acc", k - 1), ("Dv", k - 1)] if k else []
        if lookahead:
            add(f"update_head:{k}", "update_head", k,
                _update_stage(k, "head"), reads=[("panel", k)],
                destroys=prev, writes=[("acch", k), ("Dh", k)])
            add(f"update_tail:{k}", "update_tail", k,
                _update_stage(k, "tail"), reads=[("panel", k)],
                destroys=[("acch", k), ("Dh", k)],
                writes=[("acc", k), ("Dv", k)])
        else:
            add(f"update:{k}", "update", k, _update_stage(k, "all"),
                reads=[("panel", k)], destroys=prev,
                writes=[("acc", k), ("Dv", k)],
                check=_update_check_hook(k) if health is not None else None)
    sched = run_graph(stages,
                      LookaheadSchedule() if lookahead
                      else SequentialSchedule())
    if lookahead:
        with obs.span("chol.sync", cat="factor", k=nb - 1):
            if side is not None:
                torch.cuda.current_stream(A.device).wait_stream(side)
            if D.is_cuda:
                torch.cuda.synchronize(D.device)
    sched["requested_lookahead"] = bool(opts.lookahead)
    sched["streams"] = 2 if side is not None else 1
    stats["schedule"] = sched
    stats["column_traces"] = len(panel_shapes)
    stats["batching_traces"] = batching_trace_count()
    if health is not None:
        _final_gate(Lout, dvec, opts, health)
        stats["health"] = health.summary()
    return TLRFactorization(L=Lout, d=dvec, perm=np.arange(nb), stats=stats)
