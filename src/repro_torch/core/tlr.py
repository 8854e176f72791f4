"""Tile Low Rank (TLR) symmetric matrix representation.

The matrix is partitioned into an ``nb x nb`` grid of ``b x b`` tiles.
Diagonal tiles are stored dense; each strictly-lower off-diagonal tile
``A(i, j), i > j`` is stored as a low rank factorization ``U V^T`` padded to
``r_max`` columns, zero past the tile's rank. The upper triangle is implied
by symmetry: ``A(j, i) = V U^T``.

Packed lower-triangle indexing: tile ``(i, j)`` with ``i > j`` lives at flat
index ``i * (i - 1) // 2 + j`` (the layout of ``repro/core/tlr.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tril_index(i: int, j: int) -> int:
    """Flat index of strictly-lower tile (i, j), i > j."""
    if i <= j:
        raise ValueError(f"tril_index requires i > j, got ({i}, {j})")
    return i * (i - 1) // 2 + j


def num_tiles(nb: int) -> int:
    return nb * (nb - 1) // 2


def tril_pairs(nb: int) -> np.ndarray:
    """(nt, 2) array of (i, j) pairs in packed order."""
    i, j = np.tril_indices(nb, -1)   # row-major: i ascending, then j
    return np.stack([i, j], axis=1).astype(np.int64)


@dataclasses.dataclass
class TLRMatrix:
    """Symmetric TLR matrix.

    Attributes:
      D:     (nb, b, b)      dense diagonal tiles.
      U:     (nt, b, r_max)  left low-rank factors, zero-padded past ``ranks``.
      V:     (nt, b, r_max)  right low-rank factors, zero-padded past ``ranks``.
      ranks: (nt,) int32     per-tile numerical rank (<= r_max).
    """

    D: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    ranks: torch.Tensor

    @property
    def nb(self) -> int:
        return self.D.shape[0]

    @property
    def b(self) -> int:
        return self.D.shape[1]

    @property
    def n(self) -> int:
        return self.nb * self.b

    @property
    def r_max(self) -> int:
        return self.U.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.D.dtype

    @property
    def device(self) -> torch.device:
        return self.D.device

    def to_dense(self) -> torch.Tensor:
        return tlr_to_dense(self.D, self.U, self.V, self.nb, self.b)

    def memory_stats(self) -> dict:
        """Logical (paper's Sum 2*b*k_ij) and padded byte counts."""
        compute_itemsize = self.D.element_size()
        store_itemsize = self.U.element_size()
        ranks = self.ranks.cpu().numpy()
        dense_bytes = self.D.numel() * compute_itemsize
        logical_lr = int(2 * self.b * ranks.sum()) * store_itemsize
        padded_lr = (self.U.numel() + self.V.numel()) * store_itemsize
        full_dense = self.n * self.n * compute_itemsize
        return {
            "n": self.n,
            "tile_size": self.b,
            "compute_dtype": str(self.dtype).removeprefix("torch."),
            "store_dtype": str(self.U.dtype).removeprefix("torch."),
            "dense_diag_bytes": int(dense_bytes),
            "lowrank_bytes_logical": int(logical_lr),
            "lowrank_bytes_padded": int(padded_lr),
            "total_bytes_logical": int(dense_bytes + logical_lr),
            "total_bytes_padded": int(dense_bytes + padded_lr),
            "full_dense_bytes": int(full_dense),
            "dense_equivalent_gb": float(full_dense) / 2**30,
            "compression_ratio": float(full_dense)
            / float(dense_bytes + logical_lr),
            "avg_rank": float(ranks.mean()) if ranks.size else 0.0,
            "max_rank": int(ranks.max()) if ranks.size else 0,
        }


def tlr_to_dense(D, U, V, nb: int, b: int) -> torch.Tensor:
    """Dense symmetric (n, n) matrix of the TLR tiles."""
    n = nb * b
    out = torch.zeros((nb, b, nb, b), dtype=D.dtype, device=D.device)
    ar = torch.arange(nb, device=D.device)
    out[ar, :, ar, :] = D
    if nb > 1:
        pairs = torch.as_tensor(tril_pairs(nb), device=D.device)
        # (nt, b, b), in D's precision when U / V are stored lower
        blocks = (U @ V.transpose(1, 2)).to(D.dtype)
        out[pairs[:, 0], :, pairs[:, 1], :] = blocks
        out[pairs[:, 1], :, pairs[:, 0], :] = blocks.transpose(1, 2)
    return out.reshape(n, n)


def rank_heatmap(A: TLRMatrix) -> np.ndarray:
    """(nb, nb) array of tile ranks (diag = b, upper mirrored) for plots."""
    nb, b = A.nb, A.b
    H = np.full((nb, nb), b, np.int32)
    if nb > 1:
        pairs = tril_pairs(nb)
        ranks = A.ranks.cpu().numpy()
        H[pairs[:, 0], pairs[:, 1]] = ranks
        H[pairs[:, 1], pairs[:, 0]] = ranks
    return H


def zeros_like_structure(nb: int, b: int, r_max: int, dtype,
                         device) -> TLRMatrix:
    nt = num_tiles(nb)
    return TLRMatrix(
        D=torch.zeros((nb, b, b), dtype=dtype, device=device),
        U=torch.zeros((nt, b, r_max), dtype=dtype, device=device),
        V=torch.zeros((nt, b, r_max), dtype=dtype, device=device),
        ranks=torch.zeros((nt,), dtype=torch.int32, device=device),
    )
