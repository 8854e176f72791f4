"""TLR Cholesky / LDL^T: the left-looking ARA driver (Algorithms 4-6, 10)
and the right-looking driver.

Port of ``repro/core/cholesky.py`` (:86-142, :147-358, :443-760,
:795-1142 left; :1148-1623 right). ``CholOptions.algo`` picks the driver.

Left-looking (default). Per block column ``k`` (host-driven):

  1. dense diagonal update  A(k,k) -= sum_j L(k,j) D_j L(k,j)^T
     (Schur-compensated by default, section 5.1.1),
  2. dense Cholesky (or LDL^T) of the diagonal tile, with the
     eigenvalue-clamp fallback (section 5.1.2),
  3. ARA compression of every updated tile in the column: the expression
     ``A(i,k) - sum_j L(i,j) D_j L(k,j)^T`` is sampled through the product
     chain of Eq. 2 / Eq. 3, whose GEMMs are the port's CUDA kernels
     (``batched_gemm``, ``tile_chain``, ``lr_sample``) on the card,
  4. batched triangular solve  V(i,k) = L(k,k)^{-1} B_i  (+ D^{-1} for
     LDL^T), and an in-place ``index_add_`` of the panel into the factor.

``mode="dynamic"`` is Algorithm 5: tiles sorted by their rank in A
(descending) flow through a fixed set of slots, converged tiles are evicted
and their slots refilled. Each column's batch is zero-padded up to a
(T, J) bucket pair of a power-of-two ladder, as in the JAX package, so both
packages run the same padded batches.

Right-looking (``algo="right"``, sequential schedule). Per column:
dense-factor the diagonal tile (already fully updated), round the column's
accumulated tiles and TRSM them (``core/algebra.py``: ``batched_qr`` +
``small_svd`` + ``batched_gemm``), then push the column's rank-r Schur
update onto every trailing tile as an appended factor pair
(``tlr_syrk_column``); a rounding pass compacts the accumulation buffers
whenever the next append would overflow them.

``batching`` (default ``"auto"``, resolved by the rank-histogram policy of
``core/batching.py`` and recorded in ``stats["policy"]``): under
``"ranked"`` the left driver gathers A tiles at the ladder width ``wA``
covering A's ranks and L tiles at the running ladder width ``wL`` of the
factor's ranks, and projects at the width ``wQ`` covering each column's
detected ranks; the right driver tracks each tile's content width, appends
at the panel's ladder width and rounds per rank bucket.

Not in this port yet (each raises): pivoting, ``check=True`` and
``lookahead=True``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .algebra import tlr_round_tiles, tlr_syrk_column
from .ara import (ARAParams, ara_compress_dense, ara_iteration, init_state,
                  run_ara_fused, torch_probes)
from .batching import (batching_trace_count, bucket_width,
                       bucketed_round_tiles, resolve_policy, tile_plan)
from .buckets import _bucket_ladder, _bucket_up, _column_buckets, _pad_axis
from .operator import TLRFactorization
from .stages import SequentialSchedule, Stage, run_graph
from .tlr import TLRMatrix, tril_index, tril_pairs, zeros_like_structure
from ..kernels import ops

Probes = Callable[[int, int, tuple, torch.dtype, torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CholOptions:
    eps: float = 1e-6
    bs: int = 16
    r_max_out: int = 0            # 0 => A.r_max
    algo: str = "left"            # "left" (ARA sampling) | "right" (eager
                                  # updates; sequential)
    mode: str = "dynamic"         # "dynamic" | "fused" (left-looking only)
    bucket: int = 0               # 0 => whole column in one batch
    share_omega: bool = True      # share Omega across the column
    schur: Optional[str] = "diag" # None | "diag" | "full"
    modified_chol: bool = True
    pivot: Optional[str] = None   # not ported: must stay None
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
    lookahead: bool = False       # algo="right" lookahead schedule: not
                                  # ported, must stay False (ignored by
                                  # algo="left", as in the JAX package)
    check: bool = False           # not ported: must stay False
    probes: Optional[Probes] = None
                                  # probes(k, it, shape, dtype, device): the
                                  # Omega of block iteration ``it`` in column
                                  # ``k`` (panel ARA and Schur compensation
                                  # alike); None => torch_probes(seed)

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
        raise NotImplementedError("inter-tile pivoting is not ported")
    if opts.algo == "right" and opts.lookahead:
        raise NotImplementedError("lookahead=True (the right-looking "
                                  "LookaheadSchedule) is not ported; the "
                                  "port runs the sequential schedule")
    if opts.check:
        raise NotImplementedError("check=True (health/recovery) is not ported")
    if opts.mode not in ("dynamic", "fused"):
        raise ValueError(f"mode must be 'dynamic' or 'fused', got {opts.mode!r}")


# -- tile gathers -------------------------------------------------------------


# ``w`` (ranked batching) is the rank-ladder width covering the gathered
# tiles' ranks: a tile's factor columns past its rank are zero, so gathering
# only the first ``w`` columns is exact. The gathers index the ``[..., :w]``
# view, so each copies only those columns into a contiguous stack that the
# kernels take as it is.


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


def _gather_A_tiles(A: TLRMatrix, rows, k: int, Tb: int,
                    w: int | None = None):
    """A tiles (i, k) for i in rows (all i > k) at width ``w``, and their
    ranks, zero-padded to Tb slots."""
    w = w or A.r_max
    idx = torch.as_tensor([tril_index(int(i), k) for i in rows],
                          dtype=torch.long, device=A.device)
    return (_pad_axis(A.U[:, :, :w][idx], Tb),
            _pad_axis(A.V[:, :, :w][idx], Tb),
            _pad_axis(A.ranks[idx], Tb))


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
    ``delta`` and factor that. Returns (L, modified?)."""
    L, info = torch.linalg.cholesky_ex(Akk)
    bad = bool(info.item() != 0)
    if not bad:
        return L, False
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
    with ``dk`` None for Cholesky."""
    if opts.ldl:
        return dense_ldlt_tile(Akk)
    if opts.modified_chol:
        delta = opts.eps * Akk.diagonal().abs().max().clamp(min=1.0)
        Lkk, bad = robust_cholesky(Akk, delta)
        stats["modified_chol"] += int(bad)
    else:
        Lkk = torch.linalg.cholesky(Akk)
    return Lkk, None


# -- column processing ---------------------------------------------------------


def _build_column_data(A, L, rows, k, dvec, ldl, Tb: int, Jb: int,
                       wA: int | None = None, wL: int | None = None):
    """Operand gather for one column, zero-padded up to bucket sizes;
    ``valid`` marks the real row slots. ``wA`` / ``wL`` (ranked batching)
    are the A-tile and L-tile gather widths, so the sampling chains run at
    the bucketed width instead of ``r_max``."""
    T = len(rows)
    Ui, Vi = _gather_L(L, rows, k, Tb, Jb, wL)
    Uk, Vk = _gather_L_row(L, k, k, Jb, wL)
    Ua, Va, ra = _gather_A_tiles(A, rows, k, Tb, wA)
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
    compiled variants, which are one per shape)."""

    def __init__(self, opts: CholOptions, p: ARAParams, probes: Probes):
        self.opts = opts
        self.p = p
        self.probes = probes
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


def _column_ara_fused(pipe: _ColumnPipeline, A, L, rows, k, dvec, Lkk,
                      dk_new, ladder, widths=(None, None)):
    T = len(rows)
    Tb, Jb = _column_buckets(A.nb, k, ladder)
    wA, wL = widths
    data = _build_column_data(A, L, rows, k, dvec, pipe.opts.ldl, Tb, Jb,
                              wA, wL)
    if wA is not None:
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


def _column_ara_dynamic(pipe: _ColumnPipeline, A, L, rows, k, dvec, Lkk,
                        dk_new, ladder, widths=(None, None)):
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
    key_rank = np.array([a_ranks[tril_index(int(i), k)] for i in rows])
    order = np.argsort(-key_rank, kind="stable")
    queue = [int(rows[o]) for o in order]

    # Slot state: each slot hosts one tile's ARA run; slots past n_slots are
    # permanent padding (pre-converged via the validity mask).
    slot_rows = queue[:n_slots]
    queue = queue[n_slots:]
    data = _build_column_data(A, L, np.asarray(slot_rows), k, dvec, opts.ldl,
                              Tb, Jb, wA, wL)
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
            nd = _build_column_data(A, L, new_rows, k, dvec, opts.ldl,
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
    full_data = _build_column_data(A, L, rows, k, dvec, opts.ldl, Tb_col, Jb,
                                   wA, wL)
    if wA is not None:
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
    """TLR Cholesky: left-looking (Algorithm 6) or, with
    ``opts.algo="right"``, right-looking."""
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
    return _factorize_right(A, opts) if opts.algo == "right" \
        else _factorize(A, opts)


def _factorize(A: TLRMatrix, opts: CholOptions) -> TLRFactorization:
    nb, b = A.nb, A.b
    r_out = opts.r_max_out or A.r_max
    p = opts.ara_params(r_out)
    probes = opts.probes or torch_probes(opts.seed)
    policy = resolve_policy(opts.batching, tile_plan(A.ranks, A.r_max),
                            b=b, dtype=A.dtype, right_flush=opts.right_flush)
    batching = policy["batching"]

    Lout = zeros_like_structure(nb, b, r_out, A.dtype, A.device)
    dvec = A.D.new_zeros((nb, b)) if opts.ldl else None
    perm = np.arange(nb)
    ladder = _bucket_ladder(nb - 1)
    pipe = _ColumnPipeline(opts, p, probes)
    # Ranked batching: the A-tile gather width is fixed by A's ranks; the
    # L-tile gather width follows the running max of the written factor
    # ranks (monotone up the ladder, so it changes at most ~log2(r_max)
    # times over the whole factorization).
    wA = bucket_width(tile_plan(A.ranks, A.r_max).ranks_host, A.r_max) \
        if batching == "ranked" else None
    wL = [1 if batching == "ranked" else None]
    stats = {
        "column_iters": [], "column_ranks": [], "modified_chol": 0,
        "pivots": [], "mode": opts.mode,
        "impl": "cuda" if A.D.is_cuda else "plain", "algo": "left",
        "bucket_ladder": list(ladder), "column_events": [],
        "column_traces": 0, "project_traces": 0, "diag_traces": 0,
        "safety_valve": False, "batching": batching, "policy": policy,
    }
    # Column state the stage closures share; the factor stacks are
    # written in place (``index_add_`` of each panel, ``copy_`` of each
    # diagonal tile).
    col = [{} for _ in range(nb)]

    def _diag_stage(k: int):
        def fn():
            Akk = A.D[k]
            if k > 0:
                Uk, Vk = _gather_L_row(Lout, k, k, k, wL[0])
                dk = dvec[:k] if opts.ldl else None
                Dsum = pipe.diag_update(Uk, Vk, dk)
                if opts.schur and not opts.ldl:
                    Akk = _schur_compensate(Akk, Dsum, opts.schur, opts.eps,
                                            opts.bs, pipe.draw(k))
                else:
                    Akk = Akk - Dsum
            Lkk, dk_new = _factor_diag_tile(Akk, opts, stats)
            if opts.ldl:
                dvec[k] = dk_new
            Lout.D[k] = Lkk
            col[k].update(Lkk=Lkk, dk=dk_new)

        return fn

    def _panel_stage(k: int):
        rows = np.arange(k + 1, nb)
        T = len(rows)

        def fn():
            t0 = time.perf_counter()
            Lkk, dk_new = col[k]["Lkk"], col[k]["dk"]
            pipe.begin_column()
            run = _column_ara_fused if opts.mode == "fused" \
                else _column_ara_dynamic
            w_gather = wL[0]
            Q, Vnew, ranks, info = run(pipe, A, Lout, rows, k, dvec, Lkk,
                                       dk_new, ladder, (wA, w_gather))
            ranks_h = ranks.cpu().numpy()
            if batching == "ranked":
                wL[0] = max(wL[0], bucket_width(ranks_h, r_out))
            stats["column_iters"].append(info["iters"])
            stats["column_ranks"].append(ranks_h)
            stats["safety_valve"] |= info["safety_valve"]
            stats["column_events"].append({
                "k": k, "T": info["T"], "Tb": info["Tb"], "Jb": info["Jb"],
                "seconds": time.perf_counter() - t0,
                "traced": pipe.column_traced,
                "err": np.asarray(info["err"]), "wQ": info["wQ"],
                "wA": wA, "wL": w_gather,
            })
            # Panel scatter: every packed-lower slot is written exactly once
            # across the factorization, so adding into the zero stacks is a
            # write. Only the T real rows are added (no padded payload).
            idx = torch.as_tensor([tril_index(int(i), k) for i in rows],
                                  dtype=torch.long, device=A.device)
            Lout.U.index_add_(0, idx, Q)
            Lout.V.index_add_(0, idx, Vnew)
            Lout.ranks.index_add_(0, idx, ranks)

        return fn

    stages = []
    for k in range(nb):
        stages.append(Stage(
            name=f"diag:{k}", kind="diag", k=k, fn=_diag_stage(k),
            reads=(("L", k - 1),) if k else (), writes=(("Lkk", k),),
            seq=len(stages)))
        if k + 1 < nb:
            stages.append(Stage(
                name=f"panel:{k}", kind="panel", k=k, fn=_panel_stage(k),
                reads=(("L", k - 1), ("Lkk", k)), writes=(("L", k),),
                seq=len(stages)))
    sched = run_graph(stages, SequentialSchedule())
    sched["requested_lookahead"] = False
    stats["schedule"] = sched
    stats["column_traces"] = len(pipe.shapes["column"])
    stats["project_traces"] = len(pipe.shapes["project"])
    stats["diag_traces"] = len(pipe.shapes["diag"])
    return TLRFactorization(L=Lout, d=dvec, perm=perm, stats=stats)


# -- right-looking driver ----------------------------------------------------------


def _factorize_right(A: TLRMatrix, opts: CholOptions) -> TLRFactorization:
    """Right-looking TLR Cholesky / LDL^T on the batched tile algebra (port
    of ``repro/core/cholesky.py:1204-1623``, sequential schedule).

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

    # Accumulation buffers: every off-diagonal tile's running low-rank
    # concatenation, seeded with A's factors and updated in place.
    accU = A.U.new_zeros((nt, b, w_acc))
    accV = A.V.new_zeros((nt, b, w_acc))
    accU[:, :, :A.r_max] = A.U
    accV[:, :, :A.r_max] = A.V
    tile_w = tile_plan(A.ranks, A.r_max).ranks_host.copy() if ranked \
        else None
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
    }
    # The trailing diagonal tiles are updated in place: work on a copy so
    # the caller's operator stays as it was.
    D = A.D.clone()
    st = {"used": A.r_max, "tile_w": tile_w}
    col = [{} for _ in range(nb)]
    panel_shapes: set[int] = set()

    def _diag_stage(k: int):
        def fn():
            Lkk, dk_new = _factor_diag_tile(D[k], opts, stats)
            if opts.ldl:
                dvec[k] = dk_new
            Lout.D[k] = Lkk
            col[k].update(Lkk=Lkk, dk=dk_new)

        return fn

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

        def fn():
            c["t0"] = time.perf_counter()
            c["bt0"] = batching_trace_count()
            c["traced"] = Tb not in panel_shapes
            panel_shapes.add(Tb)
            if ranked:
                Q, B, ranks, err = bucketed_round_tiles(
                    accU[tidx], accV[tidx], st["tile_w"][tidx_np], opts.eps,
                    r_out=r_p)
            else:
                aU = _pad_axis(accU[tidx], Tb)
                aV = _pad_axis(accV[tidx], Tb)
                Q, B, ranks, err = tlr_round_tiles(aU, aV, opts.eps,
                                                   r_out=r_p)
            Vn = _trsm(c["Lkk"], c["dk"], B, opts.ldl)
            Qs, Vns, ranks = Q[:T], Vn[:T], ranks[:T]
            Lout.U.index_add_(0, tidx, Qs)
            Lout.V.index_add_(0, tidx, Vns)
            Lout.ranks.index_add_(0, tidx, ranks)
            ranks_h = ranks.cpu().numpy()
            # A rank-0 panel contributes an exactly-zero Schur update, so
            # the ranked trailing update skips it: no append, no growth.
            wk = (bucket_width(ranks_h, r_p) if int(ranks_h.max(initial=0))
                  else 0) if ranked else r_p
            c.update(Qs=Qs, Vns=Vns, ranks=ranks, err=err[:T], T=T, Tb=Tb,
                     ranks_h=ranks_h, wk=wk)

        return fn

    def _flush(k: int):
        # Recompress every tile's accumulated concatenation back to width b
        # in one rounding pass over the whole grid (tiles of factored
        # columns are dead; rounding them too keeps one batch shape, as in
        # the JAX package): one r_max-wide batch, or one per rank bucket
        # of the tracked content widths.
        if ranked:
            Uc, Vc, rc, _ = bucketed_round_tiles(accU, accV, st["tile_w"],
                                                 opts.eps, r_out=b)
            st["tile_w"] = rc.cpu().numpy().astype(np.int64)
        else:
            Uc, Vc, _, _ = tlr_round_tiles(accU, accV, opts.eps, r_out=b)
            st["used"] = b
        accU.zero_()
        accV.zero_()
        accU[:, :, :b] = Uc
        accV[:, :, :b] = Vc
        stats["flushes"] += 1

    def _update_stage(k: int):
        c = col[k]
        trail = np.nonzero(pairs_np[:, 1] > k)[0]

        def fn():
            wk = c["wk"]
            if ranked:
                if wk:
                    # Flush before the column's append when it would
                    # overflow the widest trailing tile's window.
                    tw = st["tile_w"]
                    high = int(tw[trail].max()) if trail.size else 0
                    if high + wk > w_acc:
                        _flush(k)
                    tlr_syrk_column(accU, accV, st["tile_w"], D,
                                    c["Qs"][:, :, :wk], c["Vns"][:, :, :wk],
                                    c["ranks"], c["dk"], k)
                    st["tile_w"][trail] += wk
                stats["append_widths"].append(wk)
            else:
                if st["used"] + r_p > w_acc:
                    _flush(k)
                tlr_syrk_column(accU, accV, st["used"], D, c["Qs"],
                                c["Vns"], c["ranks"], c["dk"], k)
                st["used"] += r_p
            if D.is_cuda:
                # Drain the column's work before timing it (the JAX
                # sequential driver blocks here too).
                torch.cuda.synchronize(D.device)
            stats["column_iters"].append(1)
            stats["column_ranks"].append(c["ranks_h"])
            stats["column_events"].append({
                "k": k, "T": c["T"], "Tb": c["Tb"], "Jb": 0,
                "seconds": time.perf_counter() - c["t0"],
                "traced": c["traced"] or batching_trace_count() > c["bt0"],
                "err": c["err"].cpu().numpy(),
                "wQ": wk if ranked else None,
            })
            for key in ("Qs", "Vns", "ranks", "err"):
                c.pop(key)

        return fn

    # Stage graph of the JAX package's sequential right-looking driver:
    # ("acc", k) / ("Dv", k) are the accumulation / diagonal state after
    # column k's trailing update; the update overwrites both in place.
    stages = []

    def add(name, kind, k, fn, reads=(), writes=(), destroys=()):
        stages.append(Stage(name=name, kind=kind, k=k, fn=fn,
                            reads=tuple(reads), writes=tuple(writes),
                            destroys=tuple(destroys), seq=len(stages)))

    for k in range(nb):
        add(f"diag:{k}", "diag", k, _diag_stage(k),
            reads=[("Dv", k - 1)] if k else [], writes=[("Lkk", k)])
        if k + 1 >= nb:
            continue
        add(f"panel:{k}", "panel", k, _panel_stage(k),
            reads=([("acc", k - 1)] if k else []) + [("Lkk", k)],
            writes=[("panel", k)])
        add(f"update:{k}", "update", k, _update_stage(k),
            reads=[("panel", k)],
            destroys=[("acc", k - 1), ("Dv", k - 1)] if k else [],
            writes=[("acc", k), ("Dv", k)])
    sched = run_graph(stages, SequentialSchedule())
    sched["requested_lookahead"] = False
    stats["schedule"] = sched
    stats["column_traces"] = len(panel_shapes)
    stats["batching_traces"] = batching_trace_count()
    return TLRFactorization(L=Lout, d=dvec, perm=np.arange(nb), stats=stats)
