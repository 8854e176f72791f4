"""Analytic cost model of the TLR tile batches (the port's own copy of
``tile_batch_cost``, ``repro/launch/costmodel.py:376-400``, whose module
imports jax)."""

from __future__ import annotations


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
