"""Cost accounting of the port's dry run and roofline (the counterpart of
``repro/launch/costmodel.py``), and the analytic cost model of the TLR tile
batches.

The JAX package reads costs off XLA: ``jaxpr_cost`` walks the
unpartitioned jaxpr (dot / conv FLOPs, times ``scan`` lengths, and an
HBM-traffic proxy), and ``parse_collectives_trips`` parses the
partitioned HLO for collectives, multiplying the bodies of ``while`` loops
by their trip counts, since XLA's own analysis counts a loop body once.
The port has neither a jaxpr nor HLO. It runs the step eagerly on fake
tensors (``FakeTensorMode``: shapes, no memory) and watches the aten ops
go by (``CostMode``, a ``TorchDispatchMode``):

* ``step_cost(fn, *args)`` is ``jaxpr_cost``'s counterpart: FLOPs of the
  unpartitioned step from ``torch.utils.flop_counter.FlopCounterMode``,
  and the same HBM-traffic proxy (operand and result bytes of
  materializing ops, ``_MATERIALIZING`` mapped to aten; external operands
  always count, intermediates only from ``VMEM_BYTES_GLOBAL`` up). An
  eager step runs every trip of every loop, so nothing is multiplied; the
  one term of JAX's proxy without a counterpart is a ``scan``'s carry
  traffic (the port's layer loop is a Python loop, whose carry counts
  when it is a materializing op's operand).
* ``parse_collectives_trips`` and ``parse_collectives`` have no
  counterpart: the collectives of a DTensor step are ops too, which
  ``torch.distributed.tensor.debug.CommDebugMode`` counts (every trip
  included) and ``CostMode`` sizes, through ``collective_traffic`` (the
  ring conventions of ``_line_collective``).
* ``analytic_traffic`` is a copy of JAX's, term for term.
"""

from __future__ import annotations


import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# -- collectives ------------------------------------------------------------------


def collective_traffic(op: str, nbytes: float, group_size: int) -> float:
    """Bytes one rank moves for a collective whose result is ``nbytes``
    over a group of ``group_size`` (ring algorithms, the JAX package's
    ``_line_collective``; a group below 2 is taken as 2):
      all-gather: result x (N-1)/N received;  all-reduce: 2 x buf x (N-1)/N;
      reduce-scatter: result x (N-1);  all-to-all: result x (N-1)/N;
      collective-permute: result size."""
    n = max(int(group_size), 2)
    if op == "all-gather":
        return nbytes * (n - 1) / n
    if op == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if op == "reduce-scatter":
        return nbytes * (n - 1)
    if op == "all-to-all":
        return nbytes * (n - 1) / n
    if op == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {op!r}")


# functional collectives (what DTensor's redistributions issue) by JAX's
# names; their group is the argument named "group_name"
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # DTensor's own op (_dtensor)
}

# -- the HBM-traffic proxy ----------------------------------------------------------

# JAX's _MATERIALIZING primitives as aten ops: dot_general (mm / bmm /
# addmm / baddbmm), conv_general_dilated, gather (index / index_select /
# gather / embedding), scatter / scatter-add (scatter / scatter_add /
# index_put / index_add), dynamic_update_slice (an in-place write into a
# slice: copy_ / index_put_ on a view), sort, top_k, cumsum and
# cumlogsumexp.
_MATERIALIZING = {
    "mm", "bmm", "addmm", "baddbmm", "convolution", "convolution_backward",
    "index", "index_select", "gather", "embedding",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "index_add",
    "sort", "topk", "cumsum", "logcumsumexp",
}
_UPDATE_SLICE = {"copy_", "index_put_", "slice_scatter", "select_scatter"}

# HBM-traffic convention: an operand/result contributes only if it is
# plausibly HBM-resident in a well-fused program -- "external" operands
# (weights, inputs: storages that existed before the step) always count;
# intermediates count only when larger than VMEM_BYTES (a fused attention
# or SSD chunk keeps smaller panels on chip). The JAX package's constant.
VMEM_BYTES_GLOBAL = 512 * 2**20


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _storage_key(x) -> int:
    return x.untyped_storage()._cdata


class CostMode(TorchDispatchMode):
    """Counts the ops of an eager step: FLOPs (``flop_counter``'s
    formulas), the HBM-traffic proxy, collective bytes, and the peak of
    live bytes. With DTensors it counts what one rank runs: an op on
    DTensors is left to DTensor (``NotImplemented``), whose ops on this
    rank's blocks and whose collectives then come through here.
    ``external`` are the tensors that exist before the step: their storages
    count as external operands and as live bytes from the start. Ops of
    DTensor's sharding propagation, which runs each new op once on
    whole-tensor shapes to learn its output's shape (under the active fake
    mode when there is one, or a fake mode of its own), are not counted:
    neither their FLOPs nor their bytes.

    Live bytes: each storage an op returns counts from then until its
    Python storage object is collected (a ``weakref`` callback, as
    ``torch.distributed._tools.mem_tracker`` tracks storages), ``peak`` is
    their largest sum; on fake tensors nothing is allocated, so this is the
    step's peak as this rank's allocator would see it without caching or
    fragmentation."""

    def __init__(self, external=()):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.coll_bytes: dict = {}
        self.live = 0
        self.peak = 0
        self._alive: dict = {}
        self._external = {_storage_key(t) for t in external}
        self._fake_mode = None
        self._propagating = 0
        self._saved = []
        for t in external:
            self._track(t)

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return
        nbytes = st.nbytes()

        def freed(_ref, key=key, nbytes=nbytes):
            self.live -= nbytes
            self._alive.pop(key, None)

        self._alive[key] = weakref.ref(st, freed)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake_mode = active_fake_mode()
        self._watch_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        for obj, attr, value in self._saved:
            setattr(obj, attr, value)
        self._saved = []
        return super().__exit__(*exc)

    def _watch_propagation(self) -> None:
        """Counts the depth of DTensor's sharding propagation
        (``ShardingPropagator.propagate`` and its output-shape pass,
        ``_propagate_tensor_meta*``) while this mode is on, so that its
        whole-shape ops are left out."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        for attr in ("propagate", "_propagate_tensor_meta",
                     "_propagate_tensor_meta_non_cached"):
            fn = ShardingPropagator.__dict__.get(attr)
            if fn is None:
                continue

            def watched(*args, _fn=fn, **kwargs):
                self._propagating += 1
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self._propagating -= 1
            self._saved.append((ShardingPropagator, attr, fn))
            setattr(ShardingPropagator, attr, watched)
        if not self._saved:
            raise RuntimeError("DTensor's ShardingPropagator has none of "
                               "the methods CostMode watches")

    def _op_traffic(self, name, args, out) -> float:
        if name in _UPDATE_SLICE:
            # donated buffers update in place: traffic = the written slice
            src = args[1] if name != "index_put_" else args[2]
            return 2.0 * _nbytes(src) if isinstance(src, torch.Tensor) \
                else 0.0
        tot = 0.0
        for v in tree_flatten(args)[0]:
            if isinstance(v, torch.Tensor):
                b = _nbytes(v)
                if b >= VMEM_BYTES_GLOBAL or \
                        _storage_key(v) in self._external:
                    tot += b
        for v in tree_flatten(out)[0]:
            b = _nbytes(v)
            if b >= VMEM_BYTES_GLOBAL:
                tot += b
        return tot

    def _collective(self, name, args, kwargs, out) -> None:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import \
            _resolve_process_group

        op = _COLLECTIVES[name]
        group = kwargs.get("group_name", args[-1])
        ranks = dist.get_process_group_ranks(_resolve_process_group(group))
        nbytes = sum(_nbytes(v) for v in tree_flatten(out)[0])
        key = (op, len(ranks), _span(ranks))
        self.coll_bytes[key] = self.coll_bytes.get(key, 0.0) + \
            collective_traffic(op, nbytes, len(ranks))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if DTensor in types:
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating or active_fake_mode() is not self._fake_mode:
            return out          # DTensor's sharding propagation
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor") and \
                name in _COLLECTIVES:
            self._collective(name, args, kwargs, out)
            self._track(out)
            return out
        for t in tree_flatten(out)[0]:
            self._track(t)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += float(count(*args, **kwargs, out_val=out))
        if name in _MATERIALIZING or name in _UPDATE_SLICE:
            self.traffic += self._op_traffic(name, args, out)
        return out


# Ranks per node of the cluster the roofline models (8 GPUs a node).
NODE_RANKS = 8


def _span(ranks) -> str:
    """"node" when every rank of a group sits in one node of NODE_RANKS
    ranks (NVLink), else "network"."""
    return "node" if len({r // NODE_RANKS for r in ranks}) == 1 \
        else "network"


def _fake_args(args, mode):
    """``args`` with every meta tensor replaced by a fake tensor of its
    shape and dtype on the CPU (made under ``mode``)."""
    from ..tree import tree_map

    def one(x):
        if isinstance(x, torch.Tensor) and x.device.type == "meta":
            with mode:
                return torch.empty(x.shape, dtype=x.dtype, device="cpu")
        return x
    return tree_map(one, args)


def step_cost(fn, *args) -> dict:
    """Whole-module FLOPs and the HBM-traffic proxy of the unpartitioned
    step ``fn(*args)``, run on fake tensors (``meta`` tensors in ``args``
    are made fake; nothing is computed). The counterpart of JAX's
    ``jaxpr_cost``: ``flops`` from ``FlopCounterMode``, ``traffic`` the
    proxy, top-level inputs read at least once; also ``peak``, the step's
    peak of live bytes (``CostMode``), the arguments included."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..tree import leaves

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = _fake_args(args, mode)
    ins = [x for x in leaves(args) if isinstance(x, torch.Tensor)]
    counter = FlopCounterMode(display=False)
    with mode:
        cost = CostMode(external=ins)
        with counter, cost:
            fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "traffic": cost.traffic + sum(_nbytes(x) for x in ins),
            "peak": cost.peak}


# -- analytic HBM-traffic model -------------------------------------------------


def analytic_traffic(cfg, spec, microbatches: int = 1) -> float:
    """Whole-step global HBM bytes under the standard fused-kernel model.

    Conventions (documented for the roofline):
      * params: read once per forward + once per backward (x microbatches),
        written once by the optimizer; moments read+written; grads
        written+read;
      * block-boundary activations (the layer carries): write fwd, read bwd,
        plus one remat re-write;
      * flash attention: q,k,v read + out written per layer; k,v re-read
        once per q-chunk (on-chip memory can't hold 32k keys);
      * SSD: chunk inputs/outputs + states, ~4 passes over (B,S,d_inner);
      * MoE: every locally-resident expert weight is read per micro-step
        (EP shards experts; dispatch is batched, weights stream once);
      * CE loss: chunk logits written+read in fwd, recomputed in bwd (remat);
      * decode: full KV-cache read per token + slice write; params once.
    """
    B, S = spec.global_batch, spec.seq_len
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    pdt = 2  # bf16 params/activations
    N = cfg.param_count()
    Nact = cfg.active_param_count()
    kind = spec.kind
    M = max(microbatches, 1)

    if kind == "decode":
        # KV cache / SSM state traffic
        KV, hd = cfg.num_kv_heads, cfg.hd
        cache_dt = 1 if cfg.kv_cache_dtype == "int8" else 2
        n_attn = sum(1 for m_, _ in cfg.layer_pattern() if m_ == "attn") \
            * cfg.num_pattern_repeats
        cache = 2 * n_attn * B * S * KV * hd * cache_dt    # k+v read
        n_ssm = sum(1 for m_, _ in cfg.layer_pattern() if m_ == "ssm") \
            * cfg.num_pattern_repeats
        if cfg.ssm is not None:
            din = cfg.ssm.expand * D
            nh = din // cfg.ssm.head_dim
            cache += 2 * n_ssm * B * nh * cfg.ssm.head_dim * cfg.ssm.d_state * 4
        # active params read once per token-step
        frac_experts = 1.0
        if cfg.moe is not None:
            frac_experts = min(1.0, B * cfg.moe.top_k / cfg.moe.num_experts)
        params = (Nact + frac_experts * (N - Nact)) * pdt
        return cache + params + 2 * B * D * pdt * L

    tokens = B * S
    # parameter traffic
    params = (2 * M + 1) * N * pdt
    if kind == "train":
        mdt = 2 if N > 5e10 else 4
        params += 4 * N * mdt + 2 * N * pdt          # moments r/w + grads
    elif kind == "prefill":
        params = N * pdt
    # activations: block carries + remat rewrite
    act = 3 * L * tokens * D * pdt
    # attention: qkv+out + kv re-reads per q-chunk
    H, KVh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    n_attn = sum(1 for m_, _ in cfg.layer_pattern() if m_ in ("attn", "cross")) \
        * cfg.num_pattern_repeats
    nq = max(S // 512, 1)
    attn = n_attn * tokens * (2 * H * hd + 2 * KVh * hd) * pdt
    attn += n_attn * nq * 2 * B * min(S, 32768) * KVh * hd * pdt // max(M, 1)
    # SSD
    ssd = 0
    if cfg.ssm is not None:
        din = cfg.ssm.expand * D
        n_ssm = sum(1 for m_, _ in cfg.layer_pattern() if m_ == "ssm") \
            * cfg.num_pattern_repeats
        ssd = 4 * n_ssm * tokens * din * pdt
    # CE logits (train only; prefill takes last position)
    ce = 4 * tokens * V * pdt if kind == "train" else 0
    # act already counts its 3 passes (write fwd / read bwd / remat rewrite);
    # attention/SSD streams run fwd + remat-recompute + bwd for training.
    passes = 3 if kind == "train" else 1
    if kind != "train":
        act = act / 3
    return params + act + passes * (attn + ssd) + ce


# -- TLR tile-batch roofline (consumed by the core/batching.py auto policy) ----


def tile_batch_cost(bucket_shapes, *, n: int, b: int, cap: int,
                    itemsize: int = 8, nrhs: int = 1) -> dict:
    """Analytic byte/FLOP estimates for one batched two-product tile chain
    ``U (V^T x)`` -- the canonical TLR read-path kernel -- under the two
    dispatch shapes the ``batching`` knob selects:

    * flat:   one (n, b, cap) batch; every tile pays ``cap`` columns.
    * ranked: one (padded, b, width) batch per rank bucket
              (``bucket_shapes`` is ``[(padded, width), ...]``).

    Per dispatched tile of width w: 4*b*w*nrhs FLOPs (two GEMVs per rhs
    column) and 2*b*w*itemsize factor bytes (U and V streamed once; the x/y
    blocks are shared across tiles and negligible at TLR ranks). These are
    roofline *estimates* for the policy record of ``core/batching.py``.
    """
    flops_flat = 4.0 * n * b * cap * nrhs
    bytes_flat = 2.0 * n * b * cap * itemsize
    cols = sum(p * w for p, w in bucket_shapes)
    flops_ranked = 4.0 * b * cols * nrhs
    bytes_ranked = 2.0 * b * cols * itemsize
    return {
        "flops_flat": flops_flat, "flops_ranked": flops_ranked,
        "bytes_flat": bytes_flat, "bytes_ranked": bytes_ranked,
    }
