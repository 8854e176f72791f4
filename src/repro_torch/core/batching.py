"""Rank-bucketed dynamic batching for the TLR hot paths.

Port of ``repro/core/batching.py:50-484``. Every batched path stores its
low-rank factors zero-padded to one global ``r_max``, so a matrix whose tile
ranks range 4-64 would pay QR / SVD / GEMM work and memory traffic as if
every tile were rank 64. Here tiles are gathered into rank-homogeneous
batches on a power-of-two *rank ladder*; each bucket runs the kernels at its
own, narrower ladder width, and the results scatter back into the padded
layout.

Shape discipline (as in ``core/buckets.py``): both the rank axis and the
count axis of every bucket are padded up power-of-two ladders, so the
number of distinct dispatch shapes stays ``~log2(r_max) * log2(nt)`` per
kernel family, never one per rank distribution
(``batching_trace_count()``).

Soundness rests on one storage invariant: factor columns past each tile's
rank are exactly zero, so slicing a tile's factors to any width >= its rank
is exact. Tiles of rank 0 are skipped outright: no QR, no SVD, no phantom
rank 1.

The tile-mesh hooks (``set_tile_mesh``, ``tile_mesh``, ``tile_dp_size``,
``pad_tile_batch``, ``shard_tile_batch``) split the tile batches over the
data axes of a ``torch.distributed`` device mesh; without a mesh they are
the identity.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from .. import obs
from .buckets import (_bucket_ladder, _bucket_up, _pad_axis, to_device,
                      trace_count, trace_event)
from ..kernels import ops
from ..launch.sharding import dp_size, tile_batch_sharding, tile_batch_spec

BATCHINGS = ("flat", "ranked", "auto")


def resolve_batching(batching: str | None, ranks=None, cap: int = 0) -> str:
    """Validate and resolve a ``batching`` knob up front.

    ``"flat"`` is one r_max-wide batch; ``"ranked"`` the rank buckets;
    ``"auto"`` asks the rank-histogram policy (:func:`choose_batching`)
    and therefore needs the per-tile ``ranks`` and their ``cap``.
    """
    batching = batching or "flat"
    if batching not in BATCHINGS:
        raise ValueError(
            f"batching must be one of {BATCHINGS}, got {batching!r}")
    if batching == "auto":
        if ranks is None:
            raise ValueError(
                "batching='auto' needs the per-tile ranks to inspect; this "
                "entry point has none -- pass 'flat' or 'ranked' explicitly")
        return choose_batching(tile_plan(ranks, cap))
    return batching


def batching_trace_count() -> int:
    """Distinct rank-bucket rounding-core dispatch shapes so far
    (process-wide): the counterpart of the JAX package's compile count."""
    return trace_count("batching")


# -- bucket planning (host side) -----------------------------------------------


def rank_ladder(cap: int) -> list[int]:
    """The power-of-two rank ladder [1, 2, 4, ..., cap]."""
    return _bucket_ladder(int(cap))


def _host_ranks(ranks) -> np.ndarray:
    if isinstance(ranks, torch.Tensor):
        ranks = ranks.detach().cpu().numpy()
    return np.asarray(ranks)


def bucket_width(ranks, cap: int, floor: int = 1) -> int:
    """Smallest ladder width covering every rank in ``ranks`` (host side);
    ``floor`` keeps an all-zero stack at a 1-wide batch."""
    if cap <= 0:
        return 0
    rk = _host_ranks(ranks)
    m = int(rk.max()) if rk.size else 0
    m = min(max(m, floor), int(cap))
    return _bucket_up(m, rank_ladder(cap))


@dataclasses.dataclass(frozen=True)
class RankBucket:
    """One rank-homogeneous batch: ``idx`` (host gather indices) of the
    tiles whose rank buckets up to ``width``; the batch count is padded up
    the count ladder to ``padded`` slots (trailing slots are zero tiles)."""

    width: int
    idx: np.ndarray
    count: int
    padded: int


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Host-side dispatch plan: rank buckets plus the skipped rank-0 set."""

    n: int
    cap: int
    buckets: tuple[RankBucket, ...]
    zero_idx: np.ndarray

    @property
    def zero_count(self) -> int:
        return int(self.zero_idx.shape[0])


def _jacobi_flops(m: int, n: int) -> float:
    """One-sided Jacobi SVD of one (m, n) core: 8 sweeps of n(n-1)/2
    rotations at 12 m + 6 n FLOPs each (PERF.md's count for small_svd)."""
    return 8.0 * n * (n - 1) / 2 * (12 * m + 6 * n)


def _round_core_flops(n: int, b: int, w: int, r_out: int) -> float:
    """Analytic FLOPs of the rounding core at one dispatch shape ``(n, b,
    w)``. Factored (w <= b): MGS2 QR of both factor stacks at 6 b w^2 a
    side, the w x w core product ``R_u R_v^T``, the Jacobi SVD of the core
    and the two truncation products. Densify (w > b): the b x b tile
    product over w columns, QR and Jacobi SVD of the b x b tile, one
    truncation product."""
    k = min(r_out, w, b)
    if w <= b:
        per = (2 * 6.0 * b * w * w + 2.0 * w ** 3 + _jacobi_flops(w, w)
               + 2 * 2.0 * b * w * k)
    else:
        per = (2.0 * b * b * w + 6.0 * b ** 3 + _jacobi_flops(b, b)
               + 2.0 * b * b * k)
    return float(n) * per


@dataclasses.dataclass(frozen=True)
class TilePlan(BatchPlan):
    """The reusable execution plan every batched path dispatches through.

    Extends :class:`BatchPlan` with a host snapshot of the ranks, the
    per-tile ladder width each rank buckets up to, and the rank-histogram
    summaries the auto policy decides from. Built once per rank generation
    through :func:`tile_plan`; ``cache`` holds what the bucket paths derive
    from it (:func:`plan_memo`).
    """

    ranks_host: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    widths: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    @property
    def max_rank(self) -> int:
        return int(self.ranks_host.max(initial=0))

    @property
    def median_rank(self) -> float:
        """Median over the *positive* ranks (rank-0 tiles never touch a
        kernel, so they say nothing about useful batch width)."""
        live = self.ranks_host[self.ranks_host > 0]
        return float(np.median(live)) if live.size else 0.0

    @property
    def rank_skew(self) -> float:
        """max/median rank, the statistic the auto policy thresholds on."""
        med = self.median_rank
        return float(self.max_rank) / med if med > 0 else 1.0

    @property
    def max_width(self) -> int:
        """Smallest ladder width covering every rank (0 for all-zero)."""
        return int(self.widths.max(initial=0))

    def padded_cols(self) -> int:
        """Factor columns the ranked dispatch touches: sum of bucket-padded
        count x bucket width (count-ladder zero tiles included)."""
        return sum(bk.padded * bk.width for bk in self.buckets)

    def useful_cols(self) -> int:
        """Factor columns that actually carry data: sum of the ranks."""
        return int(self.ranks_host.sum())

    def flat_cols(self) -> int:
        """Factor columns the flat r_max-wide dispatch touches."""
        return self.n * self.cap

    def padded_flop_ratio(self) -> float:
        """Flat over ranked dispatched factor columns (>= 1; 1.0 means
        bucketing cannot help), for kernels linear in the columns."""
        ranked = self.padded_cols()
        return float(self.flat_cols()) / float(ranked) if ranked else 1.0

    def bucket_flops(self, b: int, r_out: int | None = None) -> list[float]:
        """Per-bucket FLOPs of the rounding core at each bucket's dispatch
        shape, one entry per ``self.buckets`` element. The JAX package takes
        these from XLA's ``cost_analysis``; PyTorch has none, so they are
        counted analytically (:func:`_round_core_flops`)."""
        return [_round_core_flops(bk.padded, b, bk.width,
                                  min(r_out or b, bk.width))
                for bk in self.buckets]

    def flat_flops(self, b: int, r_out: int | None = None) -> float:
        """The flat path's rounding-core FLOPs at the full (n, b, cap)
        dispatch shape, counted as :meth:`bucket_flops` counts."""
        if self.n == 0 or self.cap == 0:
            return 0.0
        return _round_core_flops(self.n, b, self.cap, min(r_out or b, b))


def plan_rank_buckets(ranks, cap: int) -> TilePlan:
    """Group tile indices by ``bucket_up(rank)`` on the rank ladder (host
    side). Rank-0 tiles land in ``zero_idx`` and never touch a kernel.
    Prefer :func:`tile_plan`, which memoizes the result."""
    rk = _host_ranks(ranks).astype(np.int64).reshape(-1)
    n = int(rk.shape[0])
    ladder = np.asarray(rank_ladder(cap), np.int64)
    cladder = _bucket_ladder(n)
    zero = rk <= 0
    zero_idx = np.nonzero(zero)[0].astype(np.int32)
    buckets = []
    widths = np.zeros(n, np.int64)
    if n and ladder.size:
        pos = np.searchsorted(ladder, np.clip(rk, 1, int(ladder[-1])))
        pos = np.minimum(pos, ladder.size - 1)
        widths = np.where(zero, 0, ladder[pos])
        for p in sorted(set(pos[~zero].tolist())):
            idx = np.nonzero((pos == p) & ~zero)[0].astype(np.int32)
            cnt = int(idx.shape[0])
            buckets.append(RankBucket(width=int(ladder[p]), idx=idx,
                                      count=cnt,
                                      padded=_bucket_up(cnt, cladder)))
    return TilePlan(n=n, cap=int(cap), buckets=tuple(buckets),
                    zero_idx=zero_idx, ranks_host=rk, widths=widths)


# -- plan memoization (one plan per rank generation) ---------------------------

_PLAN_CACHE: OrderedDict[tuple[int, int], tuple] = OrderedDict()
_PLAN_CACHE_SIZE = 32


def _ranks_fingerprint(ranks):
    """What makes a cached plan stale besides a new ranks object. JAX arrays
    are immutable, so the JAX package keys device ranks on identity alone;
    a torch tensor can be written in place (the drivers write ``L.ranks``),
    and every in-place write bumps its version counter. A host array (the
    right driver's ``tile_w``) gets a content checksum, as in the JAX
    package."""
    if isinstance(ranks, torch.Tensor):
        return ("tensor", ranks._version, ranks.data_ptr(),
                tuple(ranks.shape))
    if isinstance(ranks, np.ndarray):
        rk = ranks.reshape(-1)
        return (int(rk.shape[0]), int(rk.sum()), int(rk.max(initial=0)))
    return None


def tile_plan(ranks, cap: int) -> TilePlan:
    """The memoized :class:`TilePlan` for this ranks object at this cap.

    Keyed on the identity of ``ranks`` plus :func:`_ranks_fingerprint`, so
    a new ranks tensor or an in-place write to one gets a new plan, while
    repeated reads (every matvec, every TRSM) reuse it without another
    host copy. A device tensor costs one ``.cpu()`` per plan. The cache
    holds strong references to its last ``_PLAN_CACHE_SIZE`` rank objects,
    so a live entry's ``id`` is never recycled.
    """
    key = (id(ranks), int(cap))
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        ref, fp, plan = hit
        if ref is ranks and fp == _ranks_fingerprint(ranks):
            _PLAN_CACHE.move_to_end(key)
            return plan
        del _PLAN_CACHE[key]
    plan = plan_rank_buckets(ranks, cap)
    _PLAN_CACHE[key] = (ranks, _ranks_fingerprint(ranks), plan)
    while len(_PLAN_CACHE) > _PLAN_CACHE_SIZE:
        _PLAN_CACHE.popitem(last=False)
    return plan


def plan_memo(plan: TilePlan, key, make):
    """``make()`` memoized on the plan under ``key``: what the bucket paths
    derive from a plan (device index tensors, the TRSM's step widths) is
    built once per plan, i.e. once per rank generation, not once per
    call."""
    hit = plan.cache.get(key)
    if hit is None:
        hit = plan.cache[key] = make()
    return hit


def plan_index(plan: TilePlan, bk: RankBucket, device) -> torch.Tensor:
    """``bk.idx`` as a device tensor, memoized on the plan."""
    return plan_memo(plan, ("index", id(bk), torch.device(device)),
                     lambda: to_device(bk.idx.astype(np.int64), device))


# -- the auto policy ------------------------------------------------------------

# "ranked" pays off when the flat r_max-wide batch mostly multiplies zeros:
# the decision statistic is the rank histogram's max/median, with >= 4
# meaning a typical tile wastes 4x its useful width.
RANK_SKEW_RANKED = 4.0


def choose_batching(plan: TilePlan) -> str:
    """"ranked" when max/median rank >= 4 and there is anything to bucket;
    "flat" otherwise."""
    if plan.n == 0 or plan.max_rank == 0:
        return "flat"
    return "ranked" if plan.rank_skew >= RANK_SKEW_RANKED else "flat"


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def resolve_policy(batching: str | None, plan: TilePlan, *, b: int,
                   dtype=torch.float64, right_flush: int = 0) -> dict:
    """Resolve the ``batching`` / ``right_flush`` knobs against a plan and
    return the decision record the drivers put in ``stats["policy"]``
    (the same keys and values as the JAX package's).

    ``batching="auto"`` applies :func:`choose_batching`; explicit values
    pass through. ``right_flush=0`` means auto: flat keeps 2 accumulated
    columns between flushes; ranked appends land at each tile's own bucket
    width, so the window absorbs ~cap / median width columns, clamped to
    [2, 8].
    """
    from ..launch.costmodel import tile_batch_cost

    requested = batching or "auto"
    if requested not in BATCHINGS:
        raise ValueError(
            f"batching must be one of {BATCHINGS}, got {requested!r}")
    decision = choose_batching(plan) if requested == "auto" else requested
    med_w = _bucket_up(max(int(np.ceil(plan.median_rank)), 1),
                       rank_ladder(plan.cap)) if plan.cap else 1
    if right_flush:
        flush = max(1, int(right_flush))
    elif decision == "ranked":
        flush = max(2, min(8, plan.cap // max(med_w, 1)))
    else:
        flush = 2
    est = tile_batch_cost([(bk.padded, bk.width) for bk in plan.buckets],
                          n=plan.n, b=b, cap=plan.cap,
                          itemsize=_itemsize(dtype))
    return {
        "requested": requested,
        "batching": decision,
        "right_flush": flush,
        "rank_max": plan.max_rank,
        "rank_median": plan.median_rank,
        "rank_skew": plan.rank_skew,
        "bucket_widths": [bk.width for bk in plan.buckets],
        "padded_flop_ratio": plan.padded_flop_ratio(),
        **est,
    }


# -- the bucketed rounding pass ---------------------------------------------------


def _gather_padded(X: torch.Tensor, idx: torch.Tensor,
                   padded: int) -> torch.Tensor:
    """``X[idx]`` (any strides) copied once into a contiguous buffer whose
    leading axis is zero-padded to ``padded`` slots: a bucket's kernel
    operand. At the right driver's widest flush buckets this halves the
    transient memory of a gather followed by a padding copy."""
    out = X.new_zeros((padded,) + tuple(X.shape[1:]))
    torch.index_select(X, 0, idx, out=out[:idx.shape[0]])
    return out


def bucketed_round_tiles(U: torch.Tensor, V: torch.Tensor, ranks, eps: float,
                         r_out: int | None = None, *, rel: bool = False):
    """Rank-bucketed rounding pass: the ``batching="ranked"`` counterpart of
    ``tlr_round_tiles`` and the core of ranked ``tlr_round``.

    ``U`` / ``V`` are ``(N, b, W)`` factor stacks whose per-tile meaningful
    width is bounded by ``ranks`` (a tensor or a host array; columns past it
    are zero). Each bucket gathers its tiles straight at its ladder width
    (one contiguous copy, the count padded with zero tiles; the densify
    branch gathers V transposed, as its product takes it), recompresses
    there (factored QR + core SVD when the width fits the tile size,
    densify-then-compress above it) and scatters its results into one
    ``(N, b, r_out)`` output. Rank-0 tiles are skipped outright: their
    output is the zero factor pair at rank 0 with zero error.

    Returns ``(U, V, ranks, err)`` with the flat pass's truncation
    semantics; the results agree up to floating-point reduction order.
    """
    from .algebra import _compress_dense_impl, _round_factors_impl

    N, b, w_in = U.shape
    r_out = r_out or min(w_in, b)
    dev = U.device
    outU = U.new_zeros((N, b, r_out))
    outV = V.new_zeros((N, b, r_out))
    out_ranks = torch.zeros((N,), dtype=torch.int32, device=dev)
    out_err = U.new_zeros((N,))
    if N == 0:
        return outU, outV, out_ranks, out_err
    plan = tile_plan(ranks, w_in)
    sig = (b, str(U.dtype), dev.type, bool(rel))
    for bk in plan.buckets:
        attrs = {}
        if obs.enabled():
            attrs = bucket_span_attrs(plan, bk, b, r_out, U.element_size())
        with obs.span("round.bucket", cat="algebra", **attrs):
            idx = plan_index(plan, bk, dev)
            w = bk.width
            Ug = _gather_padded(U[:, :, :w], idx, bk.padded)
            if w <= b:
                k = min(r_out, w)
                trace_event("batching", ("round", bk.padded, w, k) + sig)
                Vg = _gather_padded(V[:, :, :w], idx, bk.padded)
                Ub, Vb, rb, eb = _round_factors_impl(Ug, Vg, eps, r_out=k,
                                                     rel=rel)
            else:
                k = min(r_out, b)
                trace_event("batching", ("densify", bk.padded, w, k) + sig)
                rg = np.zeros(bk.padded, np.int32)
                rg[:bk.count] = plan.ranks_host[bk.idx]
                dense = ops.batched_gemm(
                    Ug, _gather_padded(V[:, :, :w].transpose(1, 2), idx,
                                       bk.padded),
                    to_device(rg, dev))
                Ub, Vb, rb, eb = _compress_dense_impl(dense, eps, r_out=k,
                                                      rel=rel)
            n = bk.count
            outU[idx, :, :k] = Ub[:n]
            outV[idx, :, :k] = Vb[:n]
            out_ranks[idx] = rb[:n]
            out_err[idx] = eb[:n].to(out_err.dtype)
    return outU, outV, out_ranks, out_err


def bucket_span_attrs(plan: TilePlan, bk: RankBucket, b: int, r_out: int,
                      itemsize: int) -> dict:
    """Telemetry attributes for one rank-bucket launch (enabled mode
    only): the dispatched FLOPs (``flops_padded``, the analytic count of
    :meth:`TilePlan.bucket_flops` at the bucket's dispatch shape, densify
    branch included) against the useful ones (scaled by the bucket's true
    rank mass over its padded ``count x width`` slots), plus the memory
    traffic of the gather + scatter marshaling."""
    fl_pad = _round_core_flops(bk.padded, b, bk.width, min(r_out, bk.width))
    useful = float(plan.ranks_host[bk.idx].sum())
    fl = fl_pad * useful / float(bk.padded * bk.width)
    nbytes = 2 * (bk.padded * b * bk.width + bk.count * b * r_out) * itemsize
    return {"width": bk.width, "count": bk.count, "padded": bk.padded,
            "flops": fl, "flops_padded": fl_pad, "bytes": nbytes}


# -- tile-batch sharding hook (the JAX package's sharded tile algebra) --------

TILE_MESH_MODES = ("pad", "error")

_TILE_MESH = {"mesh": None, "on_indivisible": "pad"}


def set_tile_mesh(mesh, *, on_indivisible: str = "pad"):
    """Install (or clear, with ``None``) the ``torch.distributed`` device
    mesh whose data axes the tile batches split their leading output-tile
    axis over. Returns the previously installed mesh so callers can restore
    it.

    ``on_indivisible`` decides what :func:`shard_tile_batch` does when a
    batch axis does not divide the mesh's data-parallel size:

    * ``"pad"`` (default): zero-pad the leading axis up to the next
      multiple and shard the padded batch. Zero tiles are numerically inert
      in every accumulation path, and the index-driven gathers of the tile
      algebra never reference the trailing pad slots, so results are
      unchanged. Call sites that must keep the caller-visible shape
      (``preserve_shape=True``) replicate instead.
    * ``"error"``: raise ``ValueError`` with the offending sizes, so a
      topology mismatch fails at the first sharded dispatch instead of
      silently running replicated.
    """
    if on_indivisible not in TILE_MESH_MODES:
        raise ValueError(f"on_indivisible must be one of {TILE_MESH_MODES}, "
                         f"got {on_indivisible!r}")
    prev = _TILE_MESH["mesh"]
    _TILE_MESH["mesh"] = mesh
    _TILE_MESH["on_indivisible"] = on_indivisible
    return prev


def tile_mesh():
    return _TILE_MESH["mesh"]


def tile_dp_size() -> int:
    """Size of the installed mesh's data-parallel axes (1 when no mesh)."""
    mesh = _TILE_MESH["mesh"]
    return 1 if mesh is None else dp_size(mesh)


def pad_tile_batch(n: int) -> int:
    """Smallest batch count >= ``n`` divisible by the installed mesh's DP
    size (``n`` itself without a mesh). The right driver sizes its
    accumulation buffers with this so that they always divide."""
    dp = tile_dp_size()
    return int(-(-n // dp) * dp) if n else n


def tile_batch_rows(n: int, *, preserve_shape: bool = False
                    ) -> tuple[int, range]:
    """Where a tile batch of ``n`` rows lies on the installed mesh: its
    global row count (``n``, or padded up to :func:`pad_tile_batch` under
    ``"pad"``) and the rows this rank holds (all of them when replicated or
    without a mesh). Applies the ``on_indivisible`` mode: ``"error"``
    raises on an indivisible ``n``; ``preserve_shape=True`` replicates it
    under ``"pad"``."""
    mesh = _TILE_MESH["mesh"]
    if mesh is None:
        return n, range(n)
    dp = tile_dp_size()
    if dp > 1 and n % dp != 0:
        if _TILE_MESH["on_indivisible"] == "error":
            names = mesh.mesh_dim_names
            raise ValueError(
                f"tile-batch axis of size {n} does not divide the "
                f"mesh's data-parallel size {dp} "
                f"(mesh {dict(zip(names, mesh.shape))}); pad the batch to "
                f"a multiple of {dp} (see pad_tile_batch) or install "
                f"the mesh with on_indivisible='pad'")
        if preserve_shape:
            return n, range(n)
        n = pad_tile_batch(n)
    return n, tile_batch_sharding(mesh, n, 1)


def shard_tile_batch(*arrays, preserve_shape: bool = False):
    """Place each tensor's leading (tile-batch) axis across the installed
    mesh's data axes (``launch/sharding.py``); identity when no mesh is
    set.

    Returns DTensors of the JAX package's global shapes: each rank holds
    its block of rows (``.to_local()``), or all of them where the batch is
    replicated. When the axis does not divide the mesh's DP size, the
    installed ``on_indivisible`` mode decides (see :func:`set_tile_mesh`):
    ``"pad"`` zero-pads the leading axis up to the next multiple,
    ``"error"`` raises. ``preserve_shape=True`` marks call sites whose
    shape must match the input (persistent driver state): they shard when
    divisible and replicate otherwise under ``"pad"``; ``"error"`` still
    raises.
    """
    mesh = _TILE_MESH["mesh"]
    if mesh is None:
        return arrays[0] if len(arrays) == 1 else arrays
    from torch.distributed.tensor import DTensor

    out = []
    for x in arrays:
        n, rows = tile_batch_rows(int(x.shape[0]),
                                  preserve_shape=preserve_shape)
        x = _pad_axis(x, n)
        out.append(DTensor.from_local(
            x[rows.start:rows.stop].clone(), mesh,
            tile_batch_spec(n, x.ndim, mesh), run_check=False))
    return out[0] if len(out) == 1 else tuple(out)
