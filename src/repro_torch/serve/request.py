"""Request and result records of the TLR inference server (the port's own
copy of ``repro/serve/request.py``).

A :class:`ServeRequest` names one unit of linear-algebra work against a
resident factorization: a direct ``solve`` (one TRSM sweep pair), a
``logdet`` (memoized scalar), a posterior ``sample`` (one triangular
product of a fresh Gaussian draw), or an iterative ``pcg_solve`` with a
per-request tolerance and iteration budget. Requests are host-side plain
data; the server packs their columns into fixed-shape device blocks at
tick time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


KINDS = ("solve", "logdet", "sample", "pcg_solve")

# The kinds that complete in the tick they are admitted; pcg_solve
# iterates over several.
ONE_TICK_KINDS = ("solve", "logdet", "sample")


class RequestRejected(ValueError):
    """Typed submit-time rejection.

    Raised before a request can touch the queue or a slot: non-finite or
    mis-shaped right-hand sides, unknown request kinds, and unknown or
    evicted factorization ids. A ``ValueError`` subclass, so callers that
    guard submit with ``except ValueError`` keep working; ``reason`` /
    ``kind`` / ``fid`` make the rejection machine-readable.
    """

    def __init__(self, reason: str, *, kind: Optional[str] = None,
                 fid: Optional[str] = None):
        super().__init__(reason)
        self.reason = reason
        self.kind = kind
        self.fid = fid


@dataclasses.dataclass
class ServeRequest:
    """One inference request.

    ``rhs`` is required for ``solve`` / ``pcg_solve`` (a length-n vector);
    ``seed`` seeds the per-request generator of ``sample`` (defaults to
    the rid assigned at submit, so a result is reproducible from the
    request id alone); ``tol`` / ``maxiter`` apply to ``pcg_solve`` only.
    ``fid`` selects the resident factorization (None = the server's sole
    registration).
    """

    kind: str
    rhs: Optional[np.ndarray] = None
    tol: float = 1e-6
    maxiter: int = 200
    seed: Optional[int] = None
    fid: Optional[str] = None
    rid: int = -1                 # assigned by the queue at submit
    deadline_ticks: Optional[int] = None
                                  # evict (error result) if not complete
                                  # within this many ticks of submission
    retries: int = 0              # pcg_solve: re-admissions allowed after
                                  # a breakdown, with exponential backoff

    def sample_generator(self) -> torch.Generator:
        """The per-request generator of the ``sample`` kind: a CPU
        ``torch.Generator`` seeded from ``seed`` (or the rid). The server
        draws the request's ``(n, 1)`` Gaussian from it on the host, so the
        draw is the same on the CPU and on the card, and a sequential
        ``fact.sample(z=...)`` with the same draw reproduces the result."""
        seed = self.seed if self.seed is not None else self.rid
        return torch.Generator(device="cpu").manual_seed(int(seed))


@dataclasses.dataclass
class ServeResult:
    """Completion record handed back by the server.

    ``value`` is an ``(n,)`` numpy vector (``solve`` / ``sample`` /
    ``pcg_solve``) or a float (``logdet``). ``iterations`` / ``converged``
    / ``breakdown`` / ``history`` carry the per-column PCG diagnostics of
    ``pcg_solve`` (iterations 0 and converged True for the direct kinds).
    ``latency_s`` spans submit to completion (queue wait included);
    ``ticks`` counts the server ticks the request held a slot.

    ``ok`` is False for degraded completions, with ``error`` naming the
    path: deadline timeouts (``"timeout"``, value None), non-finite result
    columns isolated from a co-batched block (``"nonfinite_result"``,
    value None), requests stranded by ``evict_resident``
    (``"resident_evicted"``, value None), and PCG breakdowns that
    exhausted their retry budget (``"pcg_breakdown"``; value keeps the
    last finite iterate). ``attempts`` counts admissions (> 1 after
    breakdown retries).
    """

    rid: int
    kind: str
    fid: str
    value: object
    iterations: int = 0
    converged: bool = True
    breakdown: Optional[str] = None
    history: Optional[list] = None
    latency_s: float = 0.0
    ticks: int = 0
    ok: bool = True
    error: Optional[str] = None
    attempts: int = 1
