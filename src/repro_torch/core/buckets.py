"""Bucket-ladder helpers (counterpart of ``repro/core/buckets.py:18-61``).

Host-driven loops whose batch size changes every step (factorization
columns, triangular-solve columns) pad each batch up to a small ladder of
power-of-two sizes, so only ~log2(nb) distinct operand shapes occur. The
JAX package needs that to bound its compiled variants; the port keeps the
same shapes so both packages run the same padded batches, and so a later
CUDA-graph capture has a bounded set of shapes to capture.
"""

from __future__ import annotations

import numpy as np
import torch


def _bucket_ladder(cap: int) -> list[int]:
    """Powers of two capped at ``cap``: [1, 2, 4, ..., cap]."""
    if cap <= 0:
        return []
    vals = []
    v = 1
    while v < cap:
        vals.append(v)
        v *= 2
    vals.append(cap)
    return vals


def _bucket_up(x: int, ladder: list[int]) -> int:
    """Smallest ladder value >= x."""
    for v in ladder:
        if v >= x:
            return v
    return ladder[-1]


def _column_buckets(nb: int, k: int, ladder: list[int]) -> tuple[int, int]:
    """Coupled (T, J) bucket pair for factorization column ``k``.

    T = nb-1-k and J = k always sum to nb-1, so bucketing T up the ladder
    determines an interval [Tmin, Tb] of columns sharing one shape; padding
    J up to nb-1-Tmin covers every column in the interval.
    """
    T = nb - 1 - k
    Tb = _bucket_up(T, ladder)
    i = ladder.index(Tb)
    Tmin = (ladder[i - 1] + 1) if i > 0 else 1
    Jb = max(1, nb - 1 - Tmin)
    return Tb, Jb


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array ``a`` as a tensor on ``device``. A copy to the card goes
    through pinned memory and does not block the host: a copy from pageable
    memory waits for the current stream's queued work first, which would
    keep the right driver's lookahead schedule from enqueueing a panel
    while the previous column's tail update runs."""
    if torch.device(device).type != "cuda":
        return torch.as_tensor(a, device=device)
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        device, non_blocking=True)


def _pad_axis(x: torch.Tensor, size: int, axis: int = 0) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to ``size`` (no copy when it fits)."""
    if x.shape[axis] == size:
        return x
    shape = list(x.shape)
    shape[axis] = size - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


# -- dispatch-shape registry (counterpart of repro/core/buckets.py:72-126) ----

# The JAX package counts compiled variants of each jitted core family; a
# jitted core compiles once per operand shape. PyTorch compiles nothing, so
# the port counts what those compiles were keyed on: the distinct dispatch
# shapes of each family. Keys in use:
#
#   "batching" -- rank-bucketed rounding / densify cores (core/batching.py),
#   "plan"     -- rank-bucketed read-path chains driven by a TilePlan
#                 (core/solve.py),
#   "trsm"     -- the blocked TRSM's column steps (core/solve.py),
#   "pcg"      -- the batched-RHS PCG block step (core/solve.py).
#
# Each family must stay O(ladder length) per shape family and never scale
# with the tile count or the rank distribution; it is also the set of
# shapes a CUDA-graph capture of those cores would have to cover.
_SHAPES: dict[str, set] = {}


def trace_event(key: str, shape: tuple) -> None:
    """Record one dispatch of family ``key`` at ``shape`` (a hashable
    signature: operand shapes, dtype, static arguments)."""
    _SHAPES.setdefault(key, set()).add(shape)


def trace_count(key: str | None = None) -> int:
    """Distinct dispatch shapes of one family, or of every family when
    ``key`` is None (process-wide, monotone)."""
    if key is None:
        return sum(len(s) for s in _SHAPES.values())
    return len(_SHAPES.get(key, ()))


def trace_counts() -> dict[str, int]:
    """Snapshot of the registry's per-family counts."""
    return {key: len(s) for key, s in _SHAPES.items()}


def trace_counts_diff(before: dict[str, int]) -> dict[str, int]:
    """Per-family count deltas since the ``trace_counts()`` snapshot
    ``before``; an empty dict means no new dispatch shape anywhere."""
    out = {}
    for key, val in trace_counts().items():
        d = val - before.get(key, 0)
        if d:
            out[key] = d
    return out
