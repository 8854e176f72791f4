"""Geometric orderings that keep tile ranks low (paper section 6).

Own copy of ``repro/core/ordering.py`` (numpy only; the port imports
nothing of ``repro``). The KD-tree splits each cluster along the largest
dimension of its bounding box so the left child holds the power-of-two
multiple of the tile size nearest to half the cluster; the leaves then map
1:1 onto tiles. The Morton (Z-curve) ordering is the alternative the
paper's related work refers to.
"""

from __future__ import annotations

import numpy as np


def kd_tree_ordering(points: np.ndarray, tile_size: int) -> np.ndarray:
    """Permutation ordering points into KD-tree leaves of ~tile_size.

    Returns ``perm`` such that ``points[perm]`` is the reordered cloud.
    """
    points = np.asarray(points)
    n = points.shape[0]
    out: list[np.ndarray] = []

    def split(idx: np.ndarray) -> None:
        m = idx.shape[0]
        if m <= tile_size:
            out.append(idx)
            return
        cloud = points[idx]
        widths = cloud.max(axis=0) - cloud.min(axis=0)
        dim = int(np.argmax(widths))
        order = np.argsort(cloud[:, dim], kind="stable")
        # left cluster: tile_size * (power of two closest to m/(2*tile_size))
        half_tiles = max(1, m / (2 * tile_size))
        p2 = 2 ** int(round(np.log2(half_tiles)))
        left = min(m - 1, max(1, p2 * tile_size))
        split(idx[order[:left]])
        split(idx[order[left:]])

    split(np.arange(n))
    return np.concatenate(out)


def morton_ordering(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-order (Morton) curve permutation for d<=3 point clouds."""
    points = np.asarray(points)
    n, d = points.shape
    lo, hi = points.min(axis=0), points.max(axis=0)
    scale = np.where(hi > lo, hi - lo, 1.0)
    q = ((points - lo) / scale * (2**bits - 1)).astype(np.uint64)
    codes = np.zeros(n, np.uint64)
    for bit in range(bits):
        for dim in range(d):
            codes |= ((q[:, dim] >> np.uint64(bit)) & np.uint64(1)) \
                << np.uint64(bit * d + dim)
    return np.argsort(codes, kind="stable")
