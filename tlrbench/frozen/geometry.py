"""Point clouds and their tile ordering (the paper's section 6).

A uniform grid in the unit cube, ordered by a KD-tree whose leaves map
one to one onto tiles: each cluster splits along the widest side of its
bounding box, the left child taking the power-of-two multiple of the tile
size nearest to half the cluster.
"""

from __future__ import annotations

import numpy as np


def grid_points(n: int, d: int) -> np.ndarray:
    """The first n points of the m^d uniform grid on [0, 1]^d, m the
    smallest side with m^d >= n."""
    m = int(round(n ** (1.0 / d)))
    while m**d < n:
        m += 1
    axes = [np.linspace(0.0, 1.0, m) for _ in range(d)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, d)
    return pts[:n]


def kd_tree_ordering(points: np.ndarray, tile: int) -> np.ndarray:
    """Permutation ``perm`` such that ``points[perm]`` lists the KD-tree's
    leaves, each of at most ``tile`` points, in order."""
    out: list[np.ndarray] = []
    stack = [np.arange(points.shape[0])]
    while stack:
        idx = stack.pop()
        m = idx.shape[0]
        if m <= tile:
            out.append(idx)
            continue
        cloud = points[idx]
        dim = int(np.argmax(cloud.max(axis=0) - cloud.min(axis=0)))
        order = np.argsort(cloud[:, dim], kind="stable")
        half_tiles = max(1, m / (2 * tile))
        left = min(m - 1, max(1, 2 ** int(round(np.log2(half_tiles))) * tile))
        stack.append(idx[order[left:]])     # popped after the left child
        stack.append(idx[order[:left]])
    return np.concatenate(out)


def ordered_grid(n: int, d: int, tile: int) -> np.ndarray:
    """The grid of :func:`grid_points`, KD-tree ordered at ``tile``."""
    pts = grid_points(n, d)
    return pts[kd_tree_ordering(pts, tile)]
