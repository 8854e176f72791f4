"""Activation-sharding hook (the port's ``repro/models/pshard.py``).

Model code calls ``shard(x, "dp", None, "model")`` at the points where the
JAX package constrains an activation's layout (post-embedding, block
boundaries, attention heads, logits). By default this is the identity, so
``models/`` runs with no mesh at all; a launcher installs a hook that maps
the symbolic names onto a device mesh ("dp" -> the (pod, data) axes,
"model" -> the TP axis): ``make_mesh_hook``, whose hook redistributes a
DTensor to those placements, as JAX's ``with_sharding_constraint`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..device import is_dtensor

_HOOK: Optional[Callable] = None


def set_hook(fn: Optional[Callable]) -> None:
    global _HOOK
    _HOOK = fn


def shard(x, *names):
    if _HOOK is None:
        return x
    return _HOOK(x, names)


def fsdp_gather(tree: dict) -> dict:
    """A layer's parameter tree with each DTensor's data-parallel split
    gathered (FSDP's gather before use; a model-axis split stays), so that
    the layer's work splits over the data ranks with the batch. DTensor's
    own choice for a matmul of a small activation and a weight split over
    data is to gather the activation instead, which runs the whole batch
    on every data rank. Without a hook, ``tree`` as it is."""
    if _HOOK is None:
        return tree
    return {k: fsdp_gather(v) if isinstance(v, dict) else _HOOK.gather_dp(v)
            for k, v in tree.items()}


def local(fn, out_names, in_names, *args, partial=None, reduce="sum"):
    """``fn(*args)``, on DTensors each rank on its blocks
    (``local_map``): ``in_names`` / ``out_names`` give each argument's /
    output's symbolic names per dim, as ``shard`` takes them ("dp",
    "model", None; ``out_names`` a tuple of them for several outputs). A
    name whose axes some named dim does not divide is dropped from every
    argument and output, so the blocks agree (heads over model only when
    every head count divides). ``partial`` names the axes over which the
    outputs are a pending ``reduce`` ("sum" or "max") of the ranks' blocks
    (a contraction or reduction over a dim split on them), when that name
    is kept. A plain tensor among ``args`` is the same on every rank.
    Without DTensors, ``fn(*args)``. For a body that is independent across
    the named dims (attention across batch and heads), this is what
    DTensor's own ops would compute, without their sharding propagation of
    every folded einsum, which is slow."""
    if _HOOK is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    return _HOOK.local(fn, out_names, in_names, args, partial, reduce)


def splits(n: int, name: str) -> bool:
    """Whether the installed hook splits a dim of size ``n`` named
    ``name`` (its axes' size divides ``n`` and is no larger); False
    without a hook."""
    return _HOOK is not None and _HOOK.splits(n, name)


def grad_placements(in_pl) -> list:
    """The placements of the gradients of a ``local_map`` body's inputs
    placed at ``in_pl``: where the body's work is split over a mesh dim
    (some input is sharded over it), the gradient of an input whole over
    that dim is a partial sum (each rank saw its part of the work);
    otherwise the input's own placement."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    split = [any(isinstance(pl[m], Shard) for pl in in_pl)
             for m in range(len(in_pl[0]))]
    return [[Partial() if split[m] and isinstance(p, Replicate) else p
             for m, p in enumerate(pl)] for pl in in_pl]


def reshape(x, *shape):
    """``x.reshape(*shape)``. On a DTensor whose split a reshape cannot
    carry as whole-dim shards (a dim sharded over n ranks split into parts
    the first of which n does not divide, such as H * hd heads over more
    ranks than H, or a split DTensor can only state as a strided shard),
    the sharded dims the reshape changes are first gathered (what XLA does
    for such a split; the leading dims it keeps, such as the batch, keep
    their split), and a later ``shard`` may split the result again. The
    gradient is reshaped back the same way: it may arrive split where the
    input was whole (a flatten's gradient split over the flattened dim).
    (DTensor plans every redistribution of a strided shard by a graph
    search, which on a 3-D mesh takes minutes for one op.)"""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def _reshape_dt(x, shape):
    """``reshape``'s DTensor path, without autograd."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Replicate, Shard

    try:
        out = x.reshape(*shape)
        if not any(type(p).__name__ == "_StridedShard"
                   for p in out.placements):
            return out
    except RuntimeError:
        # DTensor refuses the split ("unevenly sharded", or "split the
        # sharded dimension" in older releases): gathered below
        pass
    kept = 0
    while kept < min(x.ndim, len(shape)) and x.shape[kept] == shape[kept]:
        kept += 1
    part = [Replicate() if isinstance(p, Shard) and p.dim >= kept else p
            for p in x.placements]
    return x.redistribute(x.device_mesh, part).reshape(*shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape_dt(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape_dt(grad, ctx.in_shape), None


def make_mesh_hook(mesh, dp_axes: tuple[str, ...], model_axis: str = "model"):
    """Standard hook: resolve symbolic axis names against a mesh. A dim
    takes its axes when their size divides it (and is no larger); the
    hook redistributes a DTensor to the placements that gives, and returns
    any other tensor, or one whose ndim differs from the names', as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate

    from ..launch.sharding import placements

    mapping = {"dp": dp_axes if len(dp_axes) > 1 else dp_axes[0],
               "model": model_axis}
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def _axis_len(n):
        ax = mapping.get(n)
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return math.prod(sizes[a] for a in ax)
        return sizes[ax]

    def splits_dim(n, name):
        return name in mapping and n % _axis_len(name) == 0 and \
            n >= _axis_len(name)

    def spec_of(shape, names):
        return [mapping[n] if splits_dim(shape[dim], n) else None
                for dim, n in enumerate(names)]

    def hook(x, names):
        if x.ndim != len(names) or not isinstance(x, DTensor):
            return x
        want = placements(spec_of(x.shape, names), mesh)
        if tuple(x.placements) == want:
            return x
        # contiguous first: redistributing a DTensor whose strides are a
        # permutation (an einsum's result) gives contiguous blocks under the
        # permuted strides, and a later view of it fails
        return x.contiguous().redistribute(mesh, want)

    def run_local(fn, out_names, in_names, args, partial, reduce):
        from torch.distributed.tensor import Partial
        from torch.distributed.tensor.experimental import local_map

        keep = set(mapping)
        for a, names in zip(args, in_names):
            for dim, n in enumerate(names):
                if n in keep and not splits_dim(a.shape[dim], n):
                    keep.discard(n)
        pending = set()
        if partial in keep:
            ax = mapping[partial]
            pending = {mesh.mesh_dim_names.index(a)
                       for a in (ax if isinstance(ax, tuple) else (ax,))}

        def places(names, out=False):
            pl = list(placements(
                [mapping[n] if n in keep else None for n in names], mesh))
            return [Partial(reduce) if out and m in pending else p
                    for m, p in enumerate(pl)]

        in_pl = [places(names) for names in in_names]
        many = isinstance(out_names[0], tuple)
        out_pl = tuple(places(n, True) for n in out_names) if many \
            else places(out_names, True)
        # a plain tensor is the same on every rank (implicit replication)
        whole = [Replicate()] * mesh.ndim
        args = [a if isinstance(a, DTensor) else
                DTensor.from_local(a, mesh, whole, run_check=False)
                for a in args]
        return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                         in_grad_placements=grad_placements(in_pl),
                         device_mesh=mesh, redistribute_inputs=True)(*args)

    dp_dims = {mesh.mesh_dim_names.index(a) for a in dp_axes}

    def gather_dp(x):
        if not isinstance(x, DTensor):
            return x
        want = [Replicate() if m in dp_dims else p
                for m, p in enumerate(x.placements)]
        if list(x.placements) == want:
            return x
        return x.redistribute(mesh, want)

    hook.spec_of = spec_of
    hook.splits = splits_dim
    hook.local = run_local
    hook.gather_dp = gather_dp
    return hook
