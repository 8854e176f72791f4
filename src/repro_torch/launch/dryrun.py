"""Multi-GPU dry run (the port's ``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell: hold a ``fake``
process group of 256 ranks (single: a (16, 16) ``("data", "model")``
mesh) or 512 (multi: (2, 16, 16) ``("pod", "data", "model")``) in this
one process, place the step's parameters, AdamW moments, inputs and
caches on the mesh as DTensors of fake tensors (``FakeTensorMode``: shapes,
no memory) by ``params_shardings`` / ``inputs_shardings`` /
``caches_shardings``, install the activation hook, run the
train / prefill / serve step once, and record

  * memory       -- one rank's parameter and argument bytes, and its peak
                    of live fake bytes (``CostMode``: every storage from
                    the op that returns it until it is freed, the
                    arguments included); the unsharded step's peak and
                    parameter bytes beside them,
  * cost         -- whole-module FLOPs and HBM-traffic proxy of the
                    unpartitioned step (``step_cost``), and one rank's
                    FLOPs and traffic in the sharded step (``CostMode``),
  * collectives  -- counts (``CommDebugMode``) and one rank's bytes by op
                    and by link (``collective_traffic``; "node" for a
                    group inside one 8-GPU node, else "network"),

into results/dryrun_torch/<arch>__<shape>__<mesh>.json for the roofline
pass. ``rank_bounds`` bounds a rank's FLOPs and peak by the unsharded
step's. The mesh is CUDA-typed (``--device cpu`` for a machine without a
card). XLA's ``lower_s`` / ``compile_s`` and its body-once costs have no
counterpart: an eager step has no compilation and runs every loop trip,
so the record has one ``trace_s``, the seconds of the fake step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b \
      --shape train_4k --mesh single [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

from ..configs import ALIASES, ARCHS, get_config, supported_shapes
from ..models import (abstract_params, build_loss_fn, build_prefill_fn,
                      build_serve_step, input_specs, pshard)
from ..models.config import SHAPES, ShapeSpec
from ..optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from ..tree import leaves, tree_map, unflatten
from .costmodel import CostMode, step_cost
from .mesh import (PRODUCTION_MESHES, dp_axes, make_test_mesh,
                   model_axis)
from .sharding import (caches_shardings, distribute_tree, inputs_shardings,
                       params_shardings, placements)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def default_microbatches(cfg) -> int:
    """Gradient-accumulation depth for the train cells: big models trade
    extra FSDP all-gathers for a 4x activation-memory cut."""
    if cfg.param_count() > 3e10 or cfg.d_model >= 8192:
        return 4
    if cfg.moe is not None and cfg.moe.top_k >= 8:
        return 4
    return 1


def _grads(loss_fn, params, batch):
    """(loss, grads) at ``params``; each DTensor gradient at its
    parameter's placements (a pending sum over ranks reduce-scattered),
    so that AdamW's state stays at the parameters' placements."""
    from torch.distributed.tensor import DTensor, Replicate

    ps = leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in ps]
        loss = loss_fn(unflatten(params, live), batch)
        if isinstance(loss, DTensor):
            # reduced first: the seed gradient of a pending sum would be
            # one on every rank, a gradient as many times too large
            loss = loss.redistribute(loss.device_mesh,
                                     [Replicate()] * loss.device_mesh.ndim)
        gs = torch.autograd.grad(loss, live)
    gs = [g.redistribute(p.device_mesh, p.placements)
          if isinstance(g, DTensor) else g for g, p in zip(gs, ps)]
    return loss.detach(), unflatten(params, gs)


def _microbatch(x, M: int, i: int):
    """Microbatch ``i`` of ``M``: the rows ``i, i + M, ...`` of the batch.
    (The JAX package takes contiguous blocks; interleaved rows keep each
    microbatch split over the data ranks as the batch is, where a
    contiguous block would lie on a few of them. The FLOPs and the
    bytes are the same.)"""
    return x.reshape(x.shape[0] // M, M, *x.shape[1:])[:, i]


def train_step_fn(cfg, microbatches: int = 0):
    """(train_step, AdamW config) of the dry run's train cells:
    ``train_step(params, ostate, batch) -> (loss, new_params,
    new_state)``, ``microbatches`` deep (0: ``default_microbatches``),
    bf16 moments above 5e10 parameters and a bf16 gradient accumulator
    above 1e11."""
    loss_fn = build_loss_fn(cfg)
    ocfg = AdamWConfig(
        moment_dtype="bfloat16" if cfg.param_count() > 5e10 else "float32")
    M = microbatches or default_microbatches(cfg)
    acc_dtype = torch.bfloat16 if cfg.param_count() > 1e11 \
        else torch.float32

    def train_step(params, ostate, batch):
        if M == 1:
            loss, grads = _grads(loss_fn, params, batch)
        else:
            lacc = torch.zeros((), dtype=torch.float32)
            gacc = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype),
                            params)
            for i in range(M):
                mb = tree_map(lambda x: _microbatch(x, M, i), batch)
                loss, g = _grads(loss_fn, params, mb)
                gacc = unflatten(gacc, [a + b.to(a.dtype) for a, b in
                                        zip(leaves(gacc), leaves(g))])
                lacc = lacc + loss
            loss = lacc / M
            grads = tree_map(lambda g: g / M, gacc)
        new_params, new_state = adamw_update(grads, ostate, params, ocfg)
        return loss, new_params, new_state

    return train_step, ocfg


def _build_step(cfg, shape, microbatches: int = 0):
    """Returns (fn, abstract_args, donate) for the cell's step function;
    the abstract arguments are trees of ``meta`` tensors. The serve
    step's ``cache_len`` is the last cache position, a Python int (the
    port's step reads it on the host)."""
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    specs = input_specs(cfg, spec)
    params = abstract_params(cfg)
    if spec.kind == "train":
        train_step, ocfg = train_step_fn(cfg, microbatches)
        return train_step, (params, adamw_init(params, ocfg), specs), (0, 1)
    if spec.kind == "prefill":
        fn = build_prefill_fn(cfg)
        return fn, (params, specs), ()
    serve = build_serve_step(cfg)

    def serve_fn(params, caches, token, cache_len):
        return serve(params, caches, token, cache_len)

    return serve_fn, (params, specs["caches"], specs["token"],
                      spec.seq_len - 1), (1,)


def whole_over_model(cfg, model: int) -> list[str]:
    """The config's dims that a model axis of ``model`` ranks does not
    divide, so that the sharding rules leave them, and the work on them,
    whole on every model rank: the vocabulary (embedding, LM head, CE),
    attention's query or KV heads, the MLP's width, the SSM's heads, an
    MoE layer whose experts and expert width both do not divide."""
    def off(n):
        return n % model != 0 or n < model

    mixers = {m for m, _ in cfg.layer_pattern()}
    dims = [("vocab", cfg.vocab_size)]
    if mixers & {"attn", "cross"} or cfg.encoder_layers:
        dims += [("heads", cfg.num_heads), ("kv_heads", cfg.num_kv_heads)]
    if cfg.d_ff > 0:
        dims.append(("d_ff", cfg.d_ff))
    if "ssm" in mixers:
        dims.append(("ssm_heads",
                     cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim))
    out = [name for name, n in dims if off(n)]
    if cfg.moe is not None and off(cfg.moe.num_experts) and \
            off(cfg.moe.d_ff_expert):
        out.append("experts")
    return out


def rank_bounds(rec: dict) -> dict:
    """Bounds on one rank's work and memory in a cell's record, from the
    unsharded step's: FLOPs at least the whole step's over the ranks (the
    ranks together run all of it) and at most F times that, and a peak of
    live bytes at most F times the whole step's peak over the ranks, plus
    the whole parameter bytes twice (a weight gathered over the data ranks
    before use and its gradient before the reduce-scatter) and the rank's
    arguments. F is 1 when the model axis divides every dim
    (``model.whole_over_model`` empty), else the model axis's size: the
    work on such a dim is repeated on every model rank, as the rules leave
    it whole."""
    n = rec["devices"]
    model = rec["mesh_shape"][rec["mesh_axes"].index("model")]
    f = model if rec["model"]["whole_over_model"] else 1.05
    flops, mem = rec["cost"]["flops_total"], rec["memory"]
    return {"factor": f, "flops_per_rank": (flops / n, f * flops / n),
            "peak_bytes_est": f * mem["peak_bytes_whole"] / n +
            2 * mem["param_bytes_whole"] + mem["argument_bytes"]}


def _is_cache_arg(i: int, kind: str) -> bool:
    return kind == "decode" and i == 1


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` default process group of ``size`` ranks in this process
    (this process is rank 0; collectives return at once, values
    unchanged), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _fake_step_patches():
    """Two workarounds of DTensor under ``FakeTensorMode``, for the length
    of the fake step; neither changes what DTensor decides.

    * DTensor takes an active fake mode for a compiler's trace and then
      caches neither its sharding propagation nor its redistribution
      plans: every op of every layer is planned anew (a graph search per
      candidate strategy on a strided shard; minutes for one op on a 3-D
      mesh). Here its ``_are_we_tracing`` ignores the fake mode, and the
      plans it costs strategies with are memoized, as its eager cache
      does.
    * The offsets of a ``_StridedShard`` block (an einsum folds a batch
      dim split over data and a head dim split over model into one) are
      read from an ``arange`` with ``tolist``, which fails on a fake
      tensor; computed outside the fake mode here.
    """
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    traced = dispatch._are_we_tracing

    def tracing():
        with unset_fake_temporarily():
            return traced()

    plan = redistribute._gen_transform_infos_non_cached
    plans: dict = {}

    def memo_plan(src, dst, use_graph_based_transform=None):
        key = (src, dst, use_graph_based_transform)
        if key not in plans:
            plans[key] = plan(src, dst, use_graph_based_transform)
        return plans[key]

    name = "local_shard_size_and_offset"
    entry = _StridedShard.__dict__[name]
    offsets = getattr(_StridedShard, name)

    def outside_fake(*args, **kwargs):
        with unset_fake_temporarily():
            return offsets(*args, **kwargs)

    saved = [(dispatch, "_are_we_tracing", traced),
             (redistribute, "_are_we_tracing", redistribute._are_we_tracing),
             (redistribute, "_gen_transform_infos_non_cached", plan),
             (_StridedShard, name, entry)]
    dispatch._are_we_tracing = tracing
    redistribute._are_we_tracing = tracing
    redistribute._gen_transform_infos_non_cached = memo_plan
    setattr(_StridedShard, name, outside_fake)
    try:
        yield
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)


def arg_shardings(args, mesh, kind: str, fsdp: bool = True) -> list:
    """The placements of each step argument: parameters and AdamW moments
    by ``params_shardings``, the decode caches by ``caches_shardings``,
    the other inputs by ``inputs_shardings``; a Python int (the serve
    step's cache length) has none."""
    out = [params_shardings(args[0], mesh, fsdp=fsdp)]
    for i, extra in enumerate(args[1:], start=1):
        if isinstance(extra, AdamWState):
            out.append(AdamWState(step=placements((), mesh),
                                  m=params_shardings(extra.m, mesh, fsdp),
                                  v=params_shardings(extra.v, mesh, fsdp)))
        elif _is_cache_arg(i, kind):
            out.append(caches_shardings(extra, mesh))
        elif isinstance(extra, torch.Tensor) or isinstance(extra, dict):
            out.append(inputs_shardings(extra, mesh))
        else:
            out.append(None)
    return out


@contextlib.contextmanager
def mesh_hook(mesh):
    """The activation hook of ``mesh`` installed (``make_mesh_hook`` on
    its data and model axes), the previous hook put back on exit."""
    prev = pshard._HOOK
    pshard.set_hook(pshard.make_mesh_hook(mesh, dp_axes(mesh),
                                          model_axis(mesh)))
    try:
        yield
    finally:
        pshard.set_hook(prev)


def sharded_train_step(cfg, params, batch, mesh, *, fsdp: bool = True,
                       microbatches: int = 0):
    """The dry run's train step on real tensors: ``params`` (a tree on
    every rank alike), fresh AdamW moments and ``batch`` placed on
    ``mesh`` by the sharding rules, the hook installed. Returns (loss,
    new_params, new_state) as DTensors, the parameters and moments at
    their placements."""
    from torch.distributed.tensor.experimental import implicit_replication

    fn, ocfg = train_step_fn(cfg, microbatches)
    args = (params, adamw_init(params, ocfg), batch)
    dargs = [distribute_tree(a, s, mesh)
             for a, s in zip(args, arg_shardings(args, mesh, "train", fsdp))]
    with mesh_hook(mesh), implicit_replication():
        return fn(*dargs)


def sharded_decode_tick(cfg, params, caches, token, cache_len: int, mesh, *,
                        fsdp: bool = True):
    """One serve step on real tensors, placed as the dry run's decode
    cells place them (parameters, caches, token), the hook installed.
    Returns the logits (a DTensor); ``caches`` are not written."""
    from torch.distributed.tensor.experimental import implicit_replication

    args = (params, caches, token, cache_len)
    dargs = [a if s is None else distribute_tree(a, s, mesh)
             for a, s in zip(args, arg_shardings(args, mesh, "decode", fsdp))]
    with mesh_hook(mesh), implicit_replication():
        logits, _ = build_serve_step(cfg)(*dargs)
    return logits


class MeshLayout:
    """A mesh's axis names and sizes, without ranks: what the sharding
    rules read (``mesh_dim_names``, ``shape``)."""

    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)


def exec_mesh(args, kind: str, fsdp: bool, shape, axes) -> tuple:
    """The mesh a cell runs on: ``(shape, axes)`` itself, or, on a
    ``("pod", "data", "model")`` mesh whose rules never split a dim over
    pod or data alone, the 2-D ``("data", "model")`` mesh with pod and
    data merged (pod-major). Rank r holds the same block on both, and
    each collective over the data-parallel axes has the same group; DTensor
    then never splits one dim over two mesh dims, which older releases
    refuse in some ops ("hybrid sharding strategies")."""
    from torch.distributed.tensor import Shard

    if "pod" not in axes:
        return tuple(shape), tuple(axes)
    layout = MeshLayout(shape, axes)
    pod, data = axes.index("pod"), axes.index("data")
    for tree in arg_shardings(args, layout, kind, fsdp):
        if tree is None:
            continue
        for places in _placement_tuples(tree):
            if places[pod] != places[data] and (
                    isinstance(places[pod], Shard) or
                    isinstance(places[data], Shard)):
                return tuple(shape), tuple(axes)
    merged = [n for i, n in enumerate(shape) if i not in (pod, data)]
    rest = [a for a in axes if a not in ("pod", "data")]
    return ((shape[pod] * shape[data], *merged), ("data", *rest))


def _placement_tuples(tree) -> list:
    """The placement tuples of a tree of them (a tuple whose items are
    placements is a leaf)."""
    from torch.distributed.tensor.placement_types import Placement

    if isinstance(tree, tuple) and tree and isinstance(tree[0], Placement):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in _placement_tuples(x)]


def greedy_decode(cfg, params, token, ticks: int, max_len: int, mesh=None,
                  feed=None):
    """``ticks`` greedy serve steps from ``token`` (B, 1) on zero caches:
    (the argmax tokens (B, ticks), the last position's logits (B, ticks,
    V) in float32), plain tensors. ``feed`` (B, ticks - 1), when given, is
    fed in place of the argmax tokens (the same inputs for two runs whose
    argmax may part). With ``mesh``, parameters, caches and tokens are
    placed as the decode cells place them and the hook is installed."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models import init_decode_caches

    def plain(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    caches = init_decode_caches(cfg, token.shape[0], max_len,
                                device=token.device)
    serve = build_serve_step(cfg)
    ctx = contextlib.ExitStack()
    if mesh is not None:
        args = (params, caches, token, 0)
        params, caches, token, _ = [
            a if sh is None else distribute_tree(a, sh, mesh)
            for a, sh in zip(args, arg_shardings(args, mesh, "decode"))]
        ctx.enter_context(mesh_hook(mesh))
        ctx.enter_context(implicit_replication())
    toks, logs = [], []
    with ctx:
        for t in range(ticks):
            logits, caches = serve(params, caches, token, t)
            last = plain(logits[:, -1]).float()
            pick = last.argmax(-1, keepdim=True).to(torch.int32)
            toks.append(pick)
            logs.append(last)
            token = pick if feed is None else feed[:, t:t + 1]
    return torch.cat(toks, dim=1), torch.stack(logs, dim=1)


def _local(tree) -> list:
    return [x.to_local() for x in leaves(tree)
            if isinstance(x, torch.Tensor)]


_JAX_NAMES = {"all_gather_into_tensor": "all-gather",
              "all_reduce": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter",
              "all_to_all_single": "all-to-all",
              "shard_dim_alltoall": "all-to-all"}


def run_cell(arch: str, shape, mesh_kind: str, *, fsdp: bool = True,
             save: bool = True, microbatches: int = 0,
             kv_cache_dtype: str = "", smoke: bool = False,
             mesh_shape=None, device_type: str | None = None,
             repeats: int = 0) -> dict:
    """One cell: ``shape`` is a ``SHAPES`` name or a ``ShapeSpec``;
    ``smoke`` takes the arch's reduced config and ``mesh_shape`` a
    (shape, axes) pair in place of the production mesh of ``mesh_kind``
    (the tests' small cells); ``repeats`` cuts the depth to that many
    repeats of the layer pattern (0: the config's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch, smoke=smoke)
    if kv_cache_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    if repeats:
        cfg = dataclasses.replace(
            cfg, num_layers=repeats * len(cfg.layer_pattern()))
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    mshape, axes = mesh_shape or PRODUCTION_MESHES[mesh_kind]
    world = math.prod(mshape)
    fn, args, _ = _build_step(cfg, spec, microbatches)
    whole = step_cost(fn, *args)
    eshape, eaxes = exec_mesh(args, spec.kind, fsdp, mshape, axes)

    with fake_world(world):
        mesh = make_test_mesh(eshape, eaxes, device_type or "cuda")
        shardings = arg_shardings(args, mesh, spec.kind, fsdp)
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        with mode:
            dargs = [a if s is None else distribute_tree(a, s, mesh)
                     for a, s in zip(args, shardings)]
        params_local = _local(dargs[0])
        args_local = [x for a in dargs for x in _local(a)]
        t0 = time.perf_counter()
        with mesh_hook(mesh), _fake_step_patches(), mode, \
                implicit_replication(), CommDebugMode() as comm, \
                CostMode(external=args_local) as cost:
            fn(*dargs)
        trace_s = time.perf_counter() - t0
        counts = {}
        for op, n in comm.get_comm_counts().items():
            name = _JAX_NAMES.get(op.__name__, op.__name__)
            counts[name] = counts.get(name, 0) + n

    by_op: dict = {}
    by_link: dict = {}
    for (op, _, link), b in cost.coll_bytes.items():
        by_op[op] = by_op.get(op, 0.0) + b
        by_link.setdefault(op, {})
        by_link[op][link] = by_link[op].get(link, 0.0) + b
    result = {
        "arch": arch, "shape": spec.name, "mesh": mesh_kind,
        "mesh_shape": list(mshape), "mesh_axes": list(axes),
        "exec_mesh_shape": list(eshape), "exec_mesh_axes": list(eaxes),
        "num_layers": cfg.num_layers,
        "device_type": mesh.device_type,
        "kv_cache_dtype": kv_cache_dtype or cfg.dtype,
        "devices": world, "fsdp": fsdp, "trace_s": round(trace_s, 2),
        "memory": {
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in params_local),
            "argument_bytes": sum(x.numel() * x.element_size()
                                  for x in args_local),
            "peak_bytes_est": cost.peak,
            "peak_bytes_whole": whole["peak"],
            "param_bytes_whole": sum(x.numel() * x.element_size()
                                     for x in leaves(args[0])),
        },
        "cost": {
            "flops_total": whole["flops"],
            "traffic_bytes_total": whole["traffic"],
            "flops_per_rank": cost.flops,
            "traffic_bytes_per_rank": cost.traffic,
        },
        "collectives": {"bytes_by_op": by_op, "bytes_by_link": by_link,
                        "counts": counts,
                        "total_bytes": sum(by_op.values())},
        "model": {
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "family": cfg.family,
            "whole_over_model": whole_over_model(
                cfg, mshape[list(axes).index("model")]),
        },
    }
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        out = RESULTS / f"{ALIASES.get(arch, arch)}__{spec.name}__{mesh_kind}.json"
        out.write_text(json.dumps(result, indent=2))
        result["path"] = str(out)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: cuda)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCHS:
            cfg = get_config(arch)
            for shape in supported_shapes(cfg):
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            tag = f"{arch} x {shape} x {mk}"
            try:
                r = run_cell(arch, shape, mk, fsdp=not args.no_fsdp,
                             device_type=args.device)
                print(f"OK   {tag}: trace {r['trace_s']}s, "
                      f"peak/rank {r['memory']['peak_bytes_est']/2**30:.2f} GiB, "
                      f"flops/rank {r['cost']['flops_per_rank']:.3e}, "
                      f"coll/rank {r['collectives']['total_bytes']/2**30:.3f} GiB",
                      flush=True)
            except Exception as e:  # noqa: BLE001 -- report, keep sweeping
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
