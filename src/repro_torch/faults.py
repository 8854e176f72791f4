"""Deterministic fault-injection harness (port of ``repro/faults.py``).

Faults are declared as plain data (:class:`Fault`) and armed with the
:func:`inject` context manager; instrumented sites in the factorization
drivers and the server's tick loop (``serve/server.py``) consult the
active set by name:

* ``"chol.diag"``  -- perturb the updated diagonal tile of column
  ``column`` just before its dense factor: ``kind="nan"`` poisons one
  entry, ``kind="indefinite"`` subtracts ``magnitude * scale * I``
  (``scale`` = the tile's max |diag| entry), making the tile genuinely
  indefinite.
* ``"chol.panel"`` -- poison one entry of panel tile ``tile``'s basis
  right after the column's ARA / rounding pass (a NaN produced
  mid-panel).
* ``"serve.admit"`` -- hold request ``rid`` out of slot admission for
  ``delay`` ticks (a delayed request, for deadline/timeout tests).
* ``"serve.solve"`` -- overwrite request ``rid``'s column of a packed
  solve/sample result block with NaN on the host (a poisoned co-batched
  column, for isolation tests).

Everything is host-driven and deterministic: no randomness, no clocks,
and each fault counts its own firings (``once=True`` faults fire a single
time). The instrumented sites gate on :func:`active`, one module-global
truthiness check: with no injection context open the drivers never call
into the harness.

The sites return corrupted copies and never write into the tensors they
are given (a driver's diagonal tile may be a view of its state). Input-level
mutators (:func:`poison_tile`, :func:`make_diag_indefinite`,
:func:`spike_rank`) build corrupted *operands* instead of intercepting
mid-flight -- the honest way to provoke rank overflow (the spiked tile
really has high rank) and indefinite inputs end to end. They return new
``TLRMatrix`` values (``dataclasses.replace``) and leave their argument as
it was.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

__all__ = [
    "Fault", "inject", "active", "corrupt_diag", "corrupt_panel",
    "defer_admission", "corrupt_result_block", "poison_tile",
    "make_diag_indefinite", "spike_rank",
]


@dataclasses.dataclass
class Fault:
    """One armed fault; see the module docstring for the site semantics."""

    site: str                      # "chol.diag" | "chol.panel" |
                                   # "serve.admit" | "serve.solve"
    kind: str = "nan"              # "nan" | "indefinite" | "delay"
    column: Optional[int] = None   # factorization column to fire at
                                   # (None = first visit)
    tile: int = 0                  # panel batch position ("chol.panel")
    magnitude: float = 4.0         # indefinite perturbation strength
    delay: int = 0                 # "serve.admit": ticks to hold
    rid: Optional[int] = None      # serve sites: target request id
    once: bool = True
    fired: int = 0                 # firing count (mutated by the sites)


_STACK: List[List[Fault]] = []


def active() -> bool:
    """True when any :func:`inject` context is open (the site gate)."""
    return bool(_STACK)


@contextlib.contextmanager
def inject(*faults: Fault):
    """Arm ``faults`` for the dynamic extent of the ``with`` block."""
    _STACK.append(list(faults))
    try:
        yield faults
    finally:
        _STACK.pop()


def _matching(site: str, column: Optional[int] = None,
              rid: Optional[int] = None) -> List[Fault]:
    out = []
    for frame in _STACK:
        for f in frame:
            if f.site != site:
                continue
            if f.site != "serve.admit" and f.once and f.fired > 0:
                continue
            if column is not None and f.column is not None \
                    and f.column != column:
                continue
            if rid is not None and f.rid is not None and f.rid != rid:
                continue
            out.append(f)
    return out


def _diag_scale(Dk: torch.Tensor) -> torch.Tensor:
    return Dk.diagonal().abs().max().clamp(min=1.0)


# -- factorization sites -------------------------------------------------------


def corrupt_diag(Akk: torch.Tensor, column: int) -> torch.Tensor:
    """Apply armed ``"chol.diag"`` faults to one updated diagonal tile."""
    for f in _matching("chol.diag", column=column):
        f.fired += 1
        if f.kind == "nan":
            Akk = Akk.clone()
            Akk[0, 0] = float("nan")
        elif f.kind == "indefinite":
            eye = torch.eye(Akk.shape[-1], dtype=Akk.dtype,
                            device=Akk.device)
            Akk = Akk - f.magnitude * _diag_scale(Akk) * eye
        else:
            raise ValueError(f"chol.diag fault kind {f.kind!r}")
    return Akk


def corrupt_panel(Q: torch.Tensor, column: int) -> torch.Tensor:
    """Apply armed ``"chol.panel"`` faults to a (T, b, r) panel basis."""
    for f in _matching("chol.panel", column=column):
        if f.kind != "nan":
            raise ValueError(f"chol.panel fault kind {f.kind!r}")
        if f.tile < Q.shape[0]:
            f.fired += 1
            Q = Q.clone()
            Q[f.tile, 0, 0] = float("nan")
    return Q


# -- serve sites ---------------------------------------------------------------


def defer_admission(rid: int) -> bool:
    """True while an armed ``"serve.admit"`` fault still holds ``rid``
    out of slot admission (one firing per held tick, up to ``delay``)."""
    for f in _matching("serve.admit", rid=rid):
        if f.fired < f.delay:
            f.fired += 1
            return True
    return False


def corrupt_result_block(X: np.ndarray, rids: List[Optional[int]]):
    """NaN-poison the columns of a packed host result block whose rids an
    armed ``"serve.solve"`` fault targets (``rids[i]`` None = idle)."""
    for f in _matching("serve.solve"):
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            if f.rid is None or f.rid == rid:
                f.fired += 1
                if not X.flags.writeable:
                    X = X.copy()
                X[:, i] = np.nan
    return X


# -- input-level mutators ------------------------------------------------------


def poison_tile(A, i: int, j: int):
    """A copy of TLR matrix ``A`` with a NaN planted in the stored basis
    of off-diagonal tile ``(i, j)`` (``i > j``, packed-lower index)."""
    from .core.tlr import tril_index

    t = tril_index(i, j)
    U, ranks = A.U.clone(), A.ranks.clone()
    U[t, 0, 0] = float("nan")
    ranks[t] = ranks[t].clamp(min=1)
    return dataclasses.replace(A, U=U, ranks=ranks)


def make_diag_indefinite(A, k: int, magnitude: float = 4.0):
    """A copy of ``A`` whose ``k``-th diagonal tile is shifted indefinite
    (subtract ``magnitude * max|diag| * I``)."""
    D = A.D.clone()
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    D[k] -= magnitude * _diag_scale(D[k]) * eye
    return dataclasses.replace(A, D=D)


def spike_rank(A, i: int, j: int, seed: int = 0, scale: float = 1.0,
               compensate: bool = True):
    """A copy of ``A`` whose tile ``(i, j)`` is replaced by a full-rank
    random factor pair at the storage width -- a genuine rank spike: the
    tile's numerical rank exceeds any cap below ``min(b, r_max)``, so a
    tight-eps factorization must overflow there.

    ``compensate`` (default) bumps diagonal tiles ``i`` and ``j`` by the
    spectral norm of the tile change, which keeps an SPD operand SPD --
    without it the replacement typically makes the matrix indefinite and
    the factorization exercises the SPD-breakdown ladder instead of the
    rank-overflow one. The factor pair is drawn from numpy's
    ``default_rng(seed)``, as in the JAX package, so both packages plant
    the same spike."""
    from .core.tlr import tril_index

    t = tril_index(i, j)
    b, r = A.U.shape[1], A.U.shape[2]
    rng = np.random.default_rng(seed)
    Us = rng.standard_normal((b, r)) * scale
    Vs = rng.standard_normal((b, r)) * scale
    D = A.D.clone()
    if compensate:
        old = A.U[t].cpu().double().numpy() @ A.V[t].cpu().double().numpy().T
        margin = 1.01 * (np.linalg.norm(Us @ Vs.T, 2)
                         + np.linalg.norm(old, 2))
        eye = margin * torch.eye(b, dtype=D.dtype, device=D.device)
        D[i] += eye
        D[j] += eye
    U, V, ranks = A.U.clone(), A.V.clone(), A.ranks.clone()
    U[t] = torch.as_tensor(Us, dtype=U.dtype, device=U.device)
    V[t] = torch.as_tensor(Vs, dtype=V.dtype, device=V.device)
    ranks[t] = r
    return dataclasses.replace(A, D=D, U=U, V=V, ranks=ranks)
