"""Batched adaptive randomized compression of dense tiles (Algorithm 1).

For every tile A (b x b) it grows an orthonormal basis Q in blocks of
``bs`` columns: each block samples Y = A Omega with a Gaussian Omega shared
by the batch, removes the basis from it by two block Gram-Schmidt passes,
takes the largest column norm of what is left as the estimate of the
residual's 2-norm, and stops the tile once that estimate is at most
``eps`` (absolute) or the basis would pass ``r_max``. Otherwise the
block's Householder QR, with numerically dead columns zeroed, is appended
at the tile's rank. The tile is then stored as ``U V^T`` with ``U = Q``
and ``V = A^T Q``, both padded to ``r_max`` columns with zeros past the
rank, which is a multiple of ``bs``.

Tiles are compressed a chunk at a time from a callable that evaluates
them, so the dense matrix is never held whole.
"""

from __future__ import annotations

from typing import Callable

import torch


def _orthonormalize(Y: torch.Tensor, drop_tol: float) -> torch.Tensor:
    """Q of the batched Householder QR of Y (T, b, s), with the columns
    whose norm or R diagonal is below ``drop_tol``, or below a relative
    cut of the block's largest R diagonal, set to zero."""
    keep = torch.linalg.vector_norm(Y, dim=1) > drop_tol
    rel = 1e-8 if Y.dtype == torch.float64 else 1e-4
    Q, R = torch.linalg.qr(Y)
    rdiag = torch.diagonal(R, dim1=-2, dim2=-1).abs()
    keep &= (rdiag > drop_tol) & (rdiag > rel * rdiag.amax(-1, keepdim=True))
    return Q * keep[:, None, :]


def ara_tiles(A: torch.Tensor, *, eps: float, r_max: int, bs: int,
              generator: torch.Generator):
    """Bases of a batch of dense tiles A (T, b, m): (Q (T, b, r_max), ranks
    (T,) int32)."""
    T, b, m = A.shape
    Q = A.new_zeros((T, b, r_max))
    rank = torch.zeros((T,), dtype=torch.int64, device=A.device)
    done = torch.zeros((T,), dtype=torch.bool, device=A.device)
    cols = torch.arange(bs, device=A.device)
    for _ in range(max(1, r_max // bs)):
        if bool(done.all()):
            break
        omega = torch.randn((m, bs), generator=generator, dtype=A.dtype,
                            device=A.device)
        Y = A @ omega
        for _ in range(2):
            Y = Y - Q @ (Q.transpose(1, 2) @ Y)
        err = torch.linalg.vector_norm(Y, dim=1).amax(dim=1)
        room = rank + bs <= r_max
        grow = ~done & (err > eps) & room
        Qy = _orthonormalize(Y, drop_tol=eps * 1e-3) * grow[:, None, None]
        idx = (rank[:, None] + cols).clamp(max=r_max - 1)
        Q = torch.where(grow[:, None, None],
                        Q.scatter(2, idx[:, None, :].expand(T, b, bs), Qy), Q)
        rank = rank + grow * bs
        done |= ~grow
    return Q, rank.to(torch.int32)


def compress_tiles(tiles: Callable[[int, int], torch.Tensor], nt: int,
                   b: int, *, eps: float, r_max: int, bs: int,
                   generator: torch.Generator, dtype: torch.dtype,
                   device: torch.device, chunk: int):
    """Compress the ``nt`` off-diagonal tiles that ``tiles(lo, hi)``
    evaluates, ``chunk`` at a time: (U, V (nt, b, r_max), ranks (nt,)
    int32)."""
    U = torch.zeros((nt, b, r_max), dtype=dtype, device=device)
    V = torch.zeros_like(U)
    ranks = torch.zeros((nt,), dtype=torch.int32, device=device)
    for lo in range(0, nt, chunk):
        hi = min(nt, lo + chunk)
        A = tiles(lo, hi)
        Q, r = ara_tiles(A, eps=eps, r_max=r_max, bs=bs, generator=generator)
        U[lo:hi] = Q
        V[lo:hi] = A.transpose(1, 2) @ Q
        ranks[lo:hi] = r
        del A, Q
    return U, V, ranks
