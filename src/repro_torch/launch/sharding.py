"""Sharding rules of the port on a ``torch.distributed`` device mesh (the
counterpart of ``repro/launch/sharding.py``): DP / FSDP over (pod, data),
Megatron TP and EP over model, and the placement of TLR tile batches.

The JAX package states a layout as a ``PartitionSpec``; here it is a tuple
of DTensor placements, one per mesh dimension: a tensor dim the JAX spec
puts on axes ``("pod", "data")`` is ``Shard(d)`` on both mesh dims, which
DTensor splits in mesh order (pod major), so rank r holds the block JAX's
device r holds. ``spec_axes`` turns placements back into the per-tensor-dim
tuple of axis names.

Parameter rules, from the tree path (``tree.path_str``, JAX's
``_path_str``):
  * attention wq/wk/wv: head (output) dim on "model"; wo: input dim on "model"
  * MLP wg/wu/wi: F on "model"; wd/wo: F on "model"
  * MoE experts (E, D, F): E on "model" when divisible (expert parallelism),
    else F on "model" (tensor parallelism inside experts) -- granite's 40
    experts do not divide 16-way, so it takes the TP path
  * embeddings: vocab on "model" (parallel CE loss)
  * SSD: in/out projections sharded on d_inner over "model"
  * FSDP: the largest remaining dim additionally sharded over (pod, data)
    when enabled and divisible
Every rule degrades gracefully: a dim is sharded only when divisible by the
axis size, so reduced smoke configs fall back to replication.

The tile half: a tile batch's leading (output-tile) axis is split over the
data axes when it divides their size (``tile_batch_spec``), and each rank
holds one contiguous block of rows (``tile_batch_sharding``).
``gather_rows`` is its only cross-rank read. It sums, over the data axes'
process group, zero buffers into which each rank has written the rows it
holds: an ``all_reduce`` rather than an ``all_gather``, because gloo (the
backend of two ranks that share one card) reduces CUDA tensors but does
not gather them. The sum is exact (x + 0 = x; only a zero's sign can
change).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..tree import flatten_with_path, path_str, unflatten
from .mesh import dp_axes


def dp_size(mesh) -> int:
    """Size of the mesh's data-parallel axes (1 without any)."""
    names = mesh.mesh_dim_names
    return math.prod(mesh.shape[names.index(a)] for a in dp_axes(mesh))


def dp_index(mesh) -> int:
    """This rank's coordinate along the data axes, flattened in mesh order:
    the block of rows it holds of a sharded batch."""
    idx = 0
    for a in dp_axes(mesh):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return idx


def tile_batch_spec(n: int, ndim: int, mesh) -> tuple:
    """DTensor placements of a TLR tile batch of ``n`` rows: the leading
    (output-tile) axis sharded over the data axes when ``n`` divides their
    size, replicated otherwise and on every other axis.

    The accumulation batches of ``tlr_syrk_column`` and the right driver's
    flushes are embarrassingly parallel over output tiles, so the batch
    axis is the natural multi-device split (``core/batching.py`` installs a
    mesh via ``set_tile_mesh``; without one everything stays on one
    device).
    """
    from torch.distributed.tensor import Replicate, Shard

    dp = dp_axes(mesh)
    split = bool(ndim and dp and n > 0 and n % dp_size(mesh) == 0)
    return tuple(Shard(0) if split and name in dp else Replicate()
                 for name in mesh.mesh_dim_names)


def tile_batch_sharding(mesh, n: int, ndim: int) -> range:
    """The rows of a tile batch of ``n`` rows that this rank holds (see
    ``tile_batch_spec``): one contiguous block when sharded, all rows when
    replicated."""
    from torch.distributed.tensor import Shard

    if not any(isinstance(p, Shard) for p in tile_batch_spec(n, ndim, mesh)):
        return range(n)
    chunk = n // dp_size(mesh)
    lo = dp_index(mesh) * chunk
    return range(lo, lo + chunk)


def dp_group(mesh):
    """The process group of this rank's data axes."""
    dp = dp_axes(mesh)
    if len(dp) == 1:
        return mesh.get_group(dp[0])
    return mesh[dp]._flatten().get_group()


def gather_rows(local: torch.Tensor, rows: range, want, mesh) -> torch.Tensor:
    """Rows ``want`` (global indices) of a batch whose rows ``rows`` this
    rank holds as ``local``, on every rank of the data axes: each rank
    writes the wanted rows it holds into a zero buffer and one
    ``all_reduce(SUM)`` adds the buffers. Every rank must call it with the
    same ``want``."""
    import torch.distributed as dist

    want = np.asarray(want, np.int64)
    out = local.new_zeros((len(want), *local.shape[1:]))
    if out.numel() == 0:
        return out
    pos = np.nonzero((want >= rows.start) & (want < rows.stop))[0]
    if pos.size:
        idx = torch.as_tensor(np.stack([pos, want[pos] - rows.start]),
                              device=local.device)
        out[idx[0]] = local[idx[1]]
    dist.all_reduce(out, group=dp_group(mesh))
    return out


# -- specs and placements -------------------------------------------------------


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def placements(spec, mesh) -> tuple:
    """DTensor placements of a JAX-style spec (one entry per tensor dim:
    None, an axis name or a tuple of them): ``Shard(d)`` on every mesh dim
    that tensor dim d is split over, ``Replicate()`` on the others. A dim
    split over several axes takes them in mesh order, as the rules here
    give them (``dp_axes``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in mesh "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_axes(places, ndim: int, mesh) -> tuple:
    """Per tensor dim, the tuple of mesh axis names it is split over (in
    mesh order; ``()`` for a whole dim): the form the tests compare with
    JAX's ``PartitionSpec``."""
    from torch.distributed.tensor import Shard

    out = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, places):
        if isinstance(p, Shard):
            out[p.dim].append(name)
    return tuple(tuple(a) for a in out)


# -- parameters -----------------------------------------------------------------


def param_spec(path_s: str, shape: tuple[int, ...], mesh,
               fsdp: bool = True) -> tuple:
    """Placements of one parameter leaf (``repro/launch/sharding.py``'s
    ``param_spec``, rule for rule)."""
    model = "model" if "model" in mesh.mesh_dim_names else None
    dp = dp_axes(mesh)
    nd = len(shape)
    spec: list = [None] * nd

    def try_shard(dim: int, axes) -> bool:
        size = _axis_size(mesh, axes)
        if axes and spec[dim] is None and shape[dim] % size == 0 and size > 1:
            spec[dim] = axes
            return True
        return False

    # Block-stacked params carry a leading repeats axis -> never shard dim 0
    # for block params; detect via path containing "blocks".
    offset = 1 if ("blocks/" in path_s and nd >= 2) else 0

    leaf = path_s.rsplit("/", 1)[-1]
    parent = path_s.rsplit("/", 2)[-2] if path_s.count("/") >= 1 else ""

    if leaf == "tok":                       # (V, D) embedding
        try_shard(0, model)
        if fsdp:
            try_shard(1, dp)
    elif leaf == "head":                    # (D, V) unembedding
        try_shard(1, model)
        if fsdp:
            try_shard(0, dp)
    elif leaf in ("wq", "wk", "wv"):        # (D, H*hd): heads on model
        try_shard(offset + 1, model)
        if fsdp:
            try_shard(offset + 0, dp)
    elif leaf == "wo" and parent in ("mixer", "cross"):  # (H*hd, D)
        try_shard(offset + 0, model)
        if fsdp:
            try_shard(offset + 1, dp)
    elif leaf in ("wg", "wu", "wi") and nd - offset == 3:   # MoE (E, D, F)
        if not try_shard(offset + 0, model):     # EP preferred
            try_shard(offset + 2, model)         # else TP on F
        if fsdp:
            try_shard(offset + 1, dp)
    elif leaf in ("wd", "wo") and nd - offset == 3:         # MoE (E, F, D)
        if not try_shard(offset + 0, model):
            try_shard(offset + 1, model)
        if fsdp:
            try_shard(offset + 2, dp)
    elif leaf in ("wg", "wu", "wi"):        # dense MLP (D, F)
        try_shard(offset + 1, model)
        if fsdp:
            try_shard(offset + 0, dp)
    elif leaf in ("wd",):                   # dense MLP (F, D)
        try_shard(offset + 0, model)
        if fsdp:
            try_shard(offset + 1, dp)
    elif leaf == "wo":                      # gelu MLP out (F, D)
        try_shard(offset + 0, model)
        if fsdp:
            try_shard(offset + 1, dp)
    elif leaf == "router":                  # (D, E)
        if fsdp:
            try_shard(offset + 0, dp)
    elif leaf == "w_in":                    # SSD (D, 2*din+2N+nh)
        try_shard(offset + 1, model)
        if fsdp:
            try_shard(offset + 0, dp)
    elif leaf == "w_out":                   # SSD (din, D)
        try_shard(offset + 0, model)
        if fsdp:
            try_shard(offset + 1, dp)
    elif nd - offset >= 2 and fsdp:
        # generic matrices: fsdp the largest dim
        dims = sorted(range(offset, nd), key=lambda d: -shape[d])
        try_shard(dims[0], dp)
    # vectors (norm scales, biases, A_log, ...) stay replicated
    return placements(spec, mesh)


def _map_with_path(fn, tree):
    flat = flatten_with_path(tree)
    return unflatten(tree, [fn(path_str(p, "/"), x) for p, x in flat])


def params_shardings(params, mesh, fsdp: bool = True):
    """A tree of placements matching a parameter tree (of any tensors:
    ``meta`` ones from ``abstract_params`` too)."""
    return _map_with_path(
        lambda ps, x: param_spec(ps, tuple(x.shape), mesh, fsdp), params)


# -- inputs ---------------------------------------------------------------------


def batch_spec(shape: tuple[int, ...], mesh) -> tuple:
    """Shard dim0 (global batch) over as many DP axes as divide it; for
    batch-1 decode, shard the sequence dim (dim with the largest extent)."""
    dp = dp_axes(mesh)
    sizes = _sizes(mesh)
    spec: list = [None] * len(shape)
    if shape and shape[0] % _axis_size(mesh, dp) == 0 and len(dp) > 0:
        spec[0] = dp
    elif shape and len(dp) > 0 and shape[0] % sizes[dp[-1]] == 0 \
            and sizes[dp[-1]] > 1 and shape[0] > 1:
        spec[0] = dp[-1]
    else:
        # batch not shardable (e.g. long_500k batch=1): shard longest dim
        if len(shape) >= 2:
            d = int(np.argmax(shape[1:])) + 1
            if shape[d] % _axis_size(mesh, dp) == 0:
                spec[d] = dp
    return placements(spec, mesh)


def cache_spec(shape: tuple[int, ...], mesh) -> tuple:
    """KV / SSM caches: stacked (R, B, S, KV, hd) or (R, B, ...). Shard batch
    over DP when divisible, else sequence; shard heads over model when
    divisible."""
    dp = dp_axes(mesh)
    spec: list = [None] * len(shape)
    if len(shape) < 2:
        return placements(spec, mesh)
    if shape[1] % _axis_size(mesh, dp) == 0 and shape[1] > 1:
        spec[1] = dp
    elif len(shape) >= 3 and shape[2] % _axis_size(mesh, dp) == 0:
        spec[2] = dp   # sequence-sharded cache (long-context decode)
    if len(shape) >= 4:
        msize = _sizes(mesh).get("model", 1)
        if spec[3] is None and shape[3] % msize == 0 and shape[3] > 1:
            spec[3] = "model"       # KV heads over model
        elif len(shape) >= 5 and spec[2] is None and msize > 1 and \
                shape[2] % msize == 0:
            spec[2] = "model"       # else: cache sequence over model
    return placements(spec, mesh)


def inputs_shardings(specs: Any, mesh):
    """A tree of placements for ``input_specs`` structures
    (train / prefill / decode)."""

    def one(ps, x):
        if "caches" in ps:
            return cache_spec(tuple(x.shape), mesh)
        if x.dim() == 0:
            return placements((), mesh)
        return batch_spec(tuple(x.shape), mesh)

    return _map_with_path(one, specs)


def caches_shardings(caches: Any, mesh):
    """A tree of placements for decode-cache structures.

    Must be used whenever a cache subtree is passed on its own (the path no
    longer contains "caches", so ``inputs_shardings`` would misroute it to
    ``batch_spec`` -- which shards the leading layer-stack axis over data and
    forces a full cache all-gather inside the layer loop)."""
    return _map_with_path(lambda ps, x: cache_spec(tuple(x.shape), mesh),
                          caches)


# -- placing trees on a mesh ------------------------------------------------------


def local_shape(shape, mesh, places) -> tuple[int, ...]:
    """The shape of this rank's block of a tensor of ``shape``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(
        tuple(shape), mesh, places, skip_offset=True)[0])


def distribute_tree(tree, shardings, mesh):
    """The DTensors of a tree on ``mesh``, leaf by leaf at the placements
    of ``shardings`` (a tree of the same structure). A real tensor is cut
    by ``distribute_tensor`` from the copy every rank holds (no
    collective), its block made contiguous (DTensor's ``view`` fails on a
    block that is a column slice); a fake one (under ``FakeTensorMode``)
    or a ``meta`` one becomes an empty block of this rank's local shape,
    made on the mesh's device type."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, places):
        if isinstance(x, FakeTensor) or x.device.type == "meta":
            local = torch.empty(local_shape(x.shape, mesh, places),
                                dtype=x.dtype, device=mesh.device_type)
        else:
            local = distribute_tensor(x, mesh, places, src_data_rank=None
                                      ).to_local().contiguous()
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return unflatten(tree, [one(x, _at(shardings, path))
                            for path, x in flatten_with_path(tree)])


def _at(tree, path):
    """The subtree of ``tree`` at ``path`` (a ``tree.flatten_with_path``
    path): how a leaf finds its placements in a tree of placement
    tuples, whose tuples ``flatten_with_path`` would descend into."""
    for kind, entry in path:
        tree = getattr(tree, entry) if kind == "name" else tree[entry]
    return tree
