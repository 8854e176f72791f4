"""Placement of the TLR tile batches on a device mesh (the counterpart of
``repro/launch/sharding.py:145-165``), and the one collective of the
sharded tile algebra.

A tile batch's leading (output-tile) axis is split over the mesh's
data-parallel axes when it divides their size, and replicated otherwise.
The JAX package states that as a ``PartitionSpec``; here it is a tuple of
DTensor placements, one per mesh dimension (``Shard(0)`` on the data axes,
``Replicate()`` on the others), and each rank holds one contiguous block
of rows (``tile_batch_sharding``).

``gather_rows`` is the only cross-rank read. It sums, over the data axes'
process group, zero buffers into which each rank has written the rows it
holds: an ``all_reduce`` rather than an ``all_gather``, because gloo (the
backend of two ranks that share one card) reduces CUDA tensors but does
not gather them. The sum is exact (x + 0 = x; only a zero's sign can
change).
"""

from __future__ import annotations

import math

import numpy as np
import torch

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
