"""Carry TLR state across from numpy arrays (for example a JAX package's
arrays passed through ``np.asarray``), so the port can solve with a factor
computed elsewhere, and the reverse (``.cpu().numpy()`` of the port's
tensors); and carry an LM's parameter tree across both ways
(``model_from_numpy`` / ``model_to_numpy``)."""

from __future__ import annotations

import numpy as np
import torch

from .core.algebra import TLRTiles
from .core.operator import TLRFactorization, TLROperator
from .core.tlr import TLRMatrix
from .device import resolve_device
from .tree import tree_map


def tlr_from_numpy(D, U, V, ranks, device=None) -> TLRMatrix:
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)

    return TLRMatrix(D=t(D), U=t(U), V=t(V),
                     ranks=t(np.asarray(ranks, np.int32)))


def tiles_from_numpy(D, U, V, ranks, device=None) -> TLRTiles:
    """A general (nonsymmetric) tile grid, such as the JAX package's
    ``TLRTiles`` from ``tlr_gemm`` or ``TLROperator.compose``."""
    A = tlr_from_numpy(D, U, V, ranks, device)
    return TLRTiles(D=A.D, U=A.U, V=A.V, ranks=A.ranks)


def operator_from_numpy(D, U, V, ranks, device=None) -> TLROperator:
    return TLROperator(tlr_from_numpy(D, U, V, ranks, device))


def factorization_from_numpy(D, U, V, ranks, d=None, perm=None,
                             device=None) -> TLRFactorization:
    L = tlr_from_numpy(D, U, V, ranks, device)
    dvec = None if d is None else torch.as_tensor(np.array(d), device=L.device)
    perm = np.arange(L.nb) if perm is None else np.asarray(perm)
    return TLRFactorization(L=L, d=dvec, perm=perm, stats={})


def _tensor(x, dev) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(arr), device=dev)


def model_from_numpy(tree, device=None):
    """The port's parameters from the JAX package's ``init_model`` tree
    (its leaves as numpy arrays, bfloat16 ones included): the same tree,
    names, shapes, dtypes and ``(in, out)`` layout, on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev), tree)


def model_to_numpy(params):
    """The port's parameter tree as numpy arrays (bfloat16 leaves as
    float32, which holds them exactly), for the JAX package."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(arr, params)
