"""``TLRServer``: continuous-batching inference over resident TLR
factorizations (port of ``repro/serve/server.py``).

A fixed block of ``slots`` right-hand-side columns, heterogeneous requests
packed into it, finished work evicted and the freed columns refilled from
a FIFO queue every tick -- shapes never change, so after :meth:`warmup`
no new dispatch shape appears (the ``trace_counts`` registry of
``core/buckets.py`` pins it in the tests).

One tick:

0. **deadline scan** -- requests whose ``deadline_ticks`` elapsed leave
   as ``error="timeout"`` results (queued or slotted; a slotted PCG
   column is cancelled mid-flight), freeing their slots for this tick's
   refill.
1. **refill** -- free slots take breakdown retries whose backoff elapsed,
   then requests off the queue in submit order; ``pcg_solve`` admissions
   stage their column into the resident's
   :class:`~..core.solve.BatchedPCG`, ``sample`` admissions draw their
   ``(n, 1)`` Gaussian on the host from the request's own generator.
2. **compute** -- per resident, the direct kinds run once for the whole
   block: solve columns pack on the host into one ``(n, slots)`` block
   through the multi-RHS TRSM, sample columns through one ``L @ Z``;
   ``logdet`` completes from the scalar memoized at registration; the PCG
   engine advances one ``check_every`` window with per-column masks.
3. **evict** -- every completed request leaves its slot with a
   :class:`ServeResult`. Non-finite columns of a packed block are
   isolated as ``error="nonfinite_result"`` without touching co-batched
   neighbours; PCG breakdowns re-admit with exponential backoff up to
   ``ServeRequest.retries``.

Packing is host-side numpy around one copy to the factor's device per
block and one ``.cpu()`` read per op per tick. The server runs on the
factor's device: the card, unless the factor was built on the CPU.

When telemetry records (``repro_torch.obs``), a tick is a ``serve.tick``
span (``active`` / ``pending`` set on it) over ``serve.pack`` (the refill,
and each block's host packing), ``serve.dispatch`` (the copy to the device
and the op), ``serve.sync`` (the read back) and ``serve.evict`` spans per
kind, with one ``occupancy`` counter sample.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import faults, obs
from ..core import solve as _solve
from ..device import numpy_dtype
from .queue import RequestQueue
from .request import KINDS, RequestRejected, ServeRequest, ServeResult
from .stats import ServerStats


@dataclasses.dataclass
class _Resident:
    """One registered factorization and its serving-side cache."""

    fid: str
    fact: object                      # TLRFactorization
    operator: object = None           # TLROperator (pcg_solve matvec), or None
    logdet: Optional[float] = None    # memoized at registration
    engine: object = None             # BatchedPCG, created when operator given

    @property
    def np_dtype(self) -> np.dtype:
        return numpy_dtype(self.fact.dtype)


@dataclasses.dataclass
class _Slot:
    """Occupied-slot record: the request plus admission bookkeeping."""

    req: ServeRequest
    admit_tick: int
    z: Optional[np.ndarray] = None    # sample kinds: the admission-time draw
    attempts: int = 1                 # admissions so far (breakdown retries)


class TLRServer:
    """Slot-based continuous-batching server over resident factorizations.

    Parameters
    ----------
    slots : fixed RHS block width -- every device op of the serve path runs
        at this column count, occupied or not (idle columns are zeros).
    check_every : PCG window length per tick (one host read per window).
    seed : base seed for ``sample`` requests that carry none (kept for the
        JAX package's signature; a request's draw is seeded by its own
        ``seed`` or rid).
    """

    def __init__(self, slots: int = 8, *, check_every: int = 4,
                 seed: int = 0):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = int(slots)
        self.check_every = max(1, int(check_every))
        self.seed = int(seed)
        self._residents: Dict[str, _Resident] = {}
        self._queue = RequestQueue()
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self.stats = ServerStats(slots=self.slots)
        self.results: Dict[int, ServeResult] = {}
        self._submit_t: Dict[int, float] = {}
        self._submit_tick: Dict[int, int] = {}
        self._evicted: set = set()
        # Breakdown-retry holding pen: (req, ready_tick, attempts) tuples
        # re-admitted (ahead of the queue) once their backoff elapses.
        self._backoff: List[tuple] = []
        self._tick = 0
        self._warm = False

    # -- registration ------------------------------------------------------

    def register(self, fid: str, fact, operator=None) -> None:
        """Make factorization ``fact`` resident under name ``fid``.

        ``operator`` (the compressed A) enables ``pcg_solve`` requests
        against this resident: the server builds a width-``slots``
        :class:`~..core.solve.BatchedPCG` over it, preconditioned by
        ``fact``, on the factor's device. The logdet is memoized here, so
        ``logdet`` requests complete in one tick with no device work.
        """
        if fid in self._residents:
            raise ValueError(f"factorization {fid!r} already registered")
        res = _Resident(fid=fid, fact=fact, operator=operator)
        res.logdet = float(fact.logdet())
        if operator is not None:
            res.engine = _solve.BatchedPCG(
                operator, fact.n, self.slots, precond=fact,
                check_every=self.check_every, dtype=fact.dtype,
                device=fact.device)
        self._residents[fid] = res
        self._warm = False

    def _resident(self, fid: Optional[str]) -> _Resident:
        if fid is None:
            if len(self._residents) != 1:
                raise RequestRejected(
                    "request.fid is required when "
                    f"{len(self._residents)} factorizations are registered",
                    fid=fid)
            return next(iter(self._residents.values()))
        if fid not in self._residents:
            if fid in self._evicted:
                raise RequestRejected(
                    f"factorization {fid!r} was evicted and is no longer "
                    f"resident (registered: {sorted(self._residents)})",
                    fid=fid)
            raise RequestRejected(f"unknown factorization {fid!r} "
                                  f"(registered: {sorted(self._residents)})",
                                  fid=fid)
        return self._residents[fid]

    def evict_resident(self, fid: str) -> None:
        """Drop a resident factorization. Requests already queued, held
        for a retry or slotted against it complete as error results
        (``error="resident_evicted"``); later submits naming it are
        rejected with an 'evicted' message."""
        if fid not in self._residents:
            raise RequestRejected(
                f"unknown factorization {fid!r} "
                f"(registered: {sorted(self._residents)})", fid=fid)
        res = self._residents.pop(fid)
        self._evicted.add(fid)
        for req in self._queue.drain(lambda r: r.fid == fid):
            self.stats.errors += 1
            self._complete_unslotted(req, error="resident_evicted")
        kept = []
        for req, ready, attempts in self._backoff:
            if req.fid == fid:
                self.stats.errors += 1
                self._complete_unslotted(req, error="resident_evicted")
            else:
                kept.append((req, ready, attempts))
        self._backoff = kept
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.fid == fid:
                if slot.req.kind == "pcg_solve" and res.engine is not None:
                    res.engine.cancel(i)
                self.stats.errors += 1
                self._complete(i, None, converged=False, ok=False,
                               error="resident_evicted")

    # -- submission --------------------------------------------------------

    def submit(self, req: ServeRequest) -> int:
        """Validate and enqueue; returns the assigned request id.

        Validation runs on the host before the request can take a slot:
        unknown kinds, missing, mis-sized or non-finite right-hand sides,
        unknown or evicted factorization ids, ``sample`` against an LDL^T
        factorization, and ``pcg_solve`` against a resident registered
        without its operator raise :class:`RequestRejected`.
        """
        try:
            return self._validate_and_enqueue(req)
        except RequestRejected:
            self.stats.rejected += 1
            raise

    def _validate_and_enqueue(self, req: ServeRequest) -> int:
        if req.kind not in KINDS:
            raise RequestRejected(f"unknown request kind {req.kind!r} "
                                  f"(one of {KINDS})", kind=req.kind)
        res = self._resident(req.fid)
        req.fid = res.fid
        if req.kind in ("solve", "pcg_solve"):
            if req.rhs is None:
                raise RequestRejected(f"{req.kind} request requires rhs",
                                      kind=req.kind, fid=res.fid)
            rhs = _solve._host_column(req.rhs, res.np_dtype)
            if rhs.shape[0] != res.fact.n:
                raise RequestRejected(
                    f"rhs length {rhs.shape[0]} != n="
                    f"{res.fact.n} of {res.fid!r}", kind=req.kind,
                    fid=res.fid)
            if not np.isfinite(rhs).all():
                bad = int(np.sum(~np.isfinite(rhs)))
                raise RequestRejected(
                    f"{req.kind} rhs contains {bad} non-finite entries",
                    kind=req.kind, fid=res.fid)
            req.rhs = rhs
        if req.kind == "sample" and res.fact.is_ldlt:
            raise RequestRejected(
                "sample requires a Cholesky factorization "
                f"({res.fid!r} is LDL^T)", kind=req.kind, fid=res.fid)
        if req.kind == "pcg_solve" and res.engine is None:
            raise RequestRejected(
                f"pcg_solve requires {res.fid!r} to be "
                "registered with its operator", kind=req.kind, fid=res.fid)
        rid = self._queue.submit(req)
        self._submit_t[rid] = time.perf_counter()
        self._submit_tick[rid] = self._tick
        return rid

    @property
    def pending(self) -> int:
        """Requests waiting in the queue (not yet in a slot)."""
        return len(self._queue)

    @property
    def active(self) -> int:
        """Requests currently occupying slots."""
        return sum(s is not None for s in self._slots)

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> None:
        """Run every fixed-shape operation of the serve path once per
        resident, on its device: the ``(n, slots)`` solve block, the
        ``(n, 1)`` per-request draw, the batched ``L @ Z`` sample product
        and one full PCG window (the engine is reset after). A drain after
        this adds no dispatch shape to the ``trace_counts`` registry."""
        for res in self._residents.values():
            fact = res.fact
            B = torch.zeros((fact.n, self.slots), dtype=fact.dtype,
                            device=fact.device)
            fact.solve(B)
            if not fact.is_ldlt:
                self._draw(res, ServeRequest("sample", seed=0))
                self._sample_block(res, B)
            if res.engine is not None:
                res.engine.load(0, np.ones(fact.n), tol=0.0,
                                maxiter=self.check_every)
                res.engine.advance(self.check_every)
                res.engine.reset()
            if fact.device.type == "cuda":
                torch.cuda.synchronize(fact.device)
        self._warm = True

    # -- the tick ----------------------------------------------------------

    def _draw(self, res: _Resident, req: ServeRequest) -> np.ndarray:
        """The request's ``(n,)`` Gaussian draw in the factor's dtype, from
        its own CPU generator (the same on every device)."""
        z = torch.randn((res.fact.n, 1), generator=req.sample_generator(),
                        dtype=res.fact.dtype)
        return z[:, 0].numpy()

    def _sample_block(self, res: _Resident, Z: torch.Tensor) -> torch.Tensor:
        """x = P^T L z for a packed draw block (the batched body of
        ``fact.sample``, minus the draw: draws happen per request at
        admission, so results do not depend on slot placement)."""
        fact = res.fact
        X = fact.tri_matvec(Z)
        eperm = _solve.tile_perm_to_element_perm(fact.perm, fact.L.b)
        return _solve._unpermute_rows(X, eperm)

    def _admit(self, i: int, req: ServeRequest) -> None:
        slot = _Slot(req=req, admit_tick=self._tick)
        res = self._residents[req.fid]
        if req.kind == "sample":
            slot.z = self._draw(res, req)
        elif req.kind == "pcg_solve":
            res.engine.load(i, req.rhs, tol=req.tol, maxiter=req.maxiter)
        self._slots[i] = slot
        self.stats.admitted += 1

    def _complete(self, i: int, value, *, iterations: int = 0,
                  converged: bool = True, breakdown=None,
                  history=None, ok: bool = True,
                  error: Optional[str] = None) -> ServeResult:
        slot = self._slots[i]
        req = slot.req
        result = ServeResult(
            rid=req.rid, kind=req.kind, fid=req.fid, value=value,
            iterations=iterations, converged=converged, breakdown=breakdown,
            history=history,
            latency_s=time.perf_counter() - self._submit_t.pop(req.rid),
            ticks=self._tick - slot.admit_tick + 1, ok=ok, error=error,
            attempts=slot.attempts)
        self._submit_tick.pop(req.rid, None)
        self.results[req.rid] = result
        self.stats.record_completion(req.kind, result.latency_s,
                                     result.ticks)
        self._slots[i] = None
        return result

    def _complete_unslotted(self, req: ServeRequest, *, error: str,
                            attempts: int = 1) -> ServeResult:
        """Error completion for a request that never reached (or no longer
        holds) a slot -- deadline-expired in the queue, or stranded by
        ``evict_resident``."""
        result = ServeResult(
            rid=req.rid, kind=req.kind, fid=req.fid or "", value=None,
            converged=False,
            latency_s=time.perf_counter()
            - self._submit_t.pop(req.rid, time.perf_counter()),
            ticks=0, ok=False, error=error, attempts=attempts)
        self._submit_tick.pop(req.rid, None)
        self.results[req.rid] = result
        return result

    def _expired(self, req: ServeRequest) -> bool:
        if req.deadline_ticks is None:
            return False
        born = self._submit_tick.get(req.rid, self._tick)
        return self._tick - born >= req.deadline_ticks

    def _deadline_scan(self, done: List[ServeResult]) -> None:
        """Evict every request whose deadline passed: queued and
        backoff-held requests complete as unslotted timeouts; slotted ones
        free their slot (cancelling the PCG column mid-flight, so the
        freed column is refillable this very tick)."""
        for req in self._queue.drain(self._expired):
            self.stats.timeouts += 1
            done.append(self._complete_unslotted(req, error="timeout"))
        if self._backoff:
            kept = []
            for req, ready, attempts in self._backoff:
                if self._expired(req):
                    self.stats.timeouts += 1
                    done.append(self._complete_unslotted(
                        req, error="timeout", attempts=attempts - 1))
                else:
                    kept.append((req, ready, attempts))
            self._backoff = kept
        for i, slot in enumerate(self._slots):
            if slot is None or not self._expired(slot.req):
                continue
            res = self._residents.get(slot.req.fid)
            if slot.req.kind == "pcg_solve" and res is not None \
                    and res.engine is not None:
                res.engine.cancel(i)
            self.stats.timeouts += 1
            done.append(self._complete(i, None, converged=False, ok=False,
                                       error="timeout"))

    def _evict_block(self, idx: List[int], X: np.ndarray,
                     done: List[ServeResult]) -> None:
        """Complete a packed solve/sample block column by column, isolating
        any non-finite column as an ``error="nonfinite_result"``
        completion: a poisoned column never reaches a caller as a value
        and never touches its co-batched neighbours."""
        if faults.active():
            rids = [self._slots[i].req.rid if (i in idx) else None
                    for i in range(self.slots)]
            X = faults.corrupt_result_block(X, rids)
        for i in idx:
            x = X[:, i].copy()
            if not np.isfinite(x).all():
                self.stats.errors += 1
                done.append(self._complete(i, None, converged=False,
                                           ok=False,
                                           error="nonfinite_result"))
            else:
                done.append(self._complete(i, x))

    def _run_block(self, res: _Resident, kind: str, idx: List[int], cols,
                   op, done: List[ServeResult]) -> None:
        """Pack ``cols`` (one host column per slot of ``idx``) into an
        ``(n, slots)`` block, run ``op`` on it on the factor's device,
        read the result back once and evict the block."""
        with obs.span("serve.pack", cat="serve", kind=kind, count=len(idx)):
            B = np.zeros((res.fact.n, self.slots), res.np_dtype)
            for i, col in zip(idx, cols):
                B[:, i] = col
        with obs.span("serve.dispatch", cat="serve", kind=kind):
            Xd = op(torch.as_tensor(B).to(res.fact.device))
        with obs.span("serve.sync", cat="serve", kind=kind):
            X = Xd.cpu().numpy()
        with obs.span("serve.evict", cat="serve", kind=kind):
            self._evict_block(idx, X, done)

    def _advance_pcg(self, res: _Resident, done: List[ServeResult]) -> None:
        """One PCG window of the resident's engine, then evict its done
        columns (``done_columns`` rather than advance's return: a
        zero-rhs load finishes without ever activating)."""
        with obs.span("serve.dispatch", cat="serve", kind="pcg_solve"):
            res.engine.advance(self.check_every)
        with obs.span("serve.evict", cat="serve", kind="pcg_solve"):
            for i in res.engine.done_columns:
                x, iters, hist, conv = res.engine.evict(i)
                slot = self._slots[i]
                if hist.breakdown is not None and not conv \
                        and slot.attempts <= slot.req.retries:
                    # Bounded retry with exponential backoff: free the slot
                    # without completing; the request re-admits from the
                    # holding pen once 2^(attempts-1) ticks elapse.
                    attempts = slot.attempts
                    self.stats.pcg_retries += 1
                    self._backoff.append(
                        (slot.req, self._tick + 2 ** (attempts - 1),
                         attempts + 1))
                    self._slots[i] = None
                    continue
                broke = hist.breakdown is not None and not conv
                if broke:
                    self.stats.errors += 1
                done.append(self._complete(
                    i, x, iterations=iters, converged=conv,
                    breakdown=hist.breakdown, history=hist, ok=not broke,
                    error="pcg_breakdown" if broke else None))

    def _refill(self) -> None:
        """Fill free slots: breakdown retries whose backoff elapsed first
        (they are older than anything queued), then the queue in FIFO
        order. An admission delay held by the fault harness keeps a popped
        request out for this tick and requeues it at the front."""
        ready = [e for e in self._backoff if e[1] <= self._tick]
        deferred: List[ServeRequest] = []
        for i in range(self.slots):
            if self._slots[i] is not None:
                continue
            if ready:
                entry = ready.pop(0)
                self._backoff.remove(entry)
                req, _rt, attempts = entry
                self._admit(i, req)
                self._slots[i].attempts = attempts
                continue
            while self._queue:
                req = self._queue.pop()
                if faults.active() and faults.defer_admission(req.rid):
                    deferred.append(req)
                    continue
                self._admit(i, req)
                break
        if deferred:
            self._queue.requeue(deferred)

    def tick(self) -> List[ServeResult]:
        """One refill -> compute -> evict cycle; returns the requests
        completed this tick (in slot order per kind)."""
        if not self._warm:
            self.warmup()
        t0 = time.perf_counter()
        with obs.span("serve.tick", cat="serve", tick=self._tick) as tsp:
            done: List[ServeResult] = []
            self._deadline_scan(done)
            with obs.span("serve.pack", cat="serve", stage="refill"):
                self._refill()
            self.stats.record_tick(self.active, 0.0)  # seconds patched below
            if obs.enabled():
                tsp.set(active=self.active, pending=self.pending)
                obs.counter("occupancy", {"active": self.active,
                                          "slots": self.slots})
            for fid, res in self._residents.items():
                by_kind: Dict[str, List[int]] = {}
                for i, slot in enumerate(self._slots):
                    if slot is not None and slot.req.fid == fid:
                        by_kind.setdefault(slot.req.kind, []).append(i)
                if "logdet" in by_kind:
                    with obs.span("serve.evict", cat="serve", kind="logdet"):
                        for i in by_kind["logdet"]:
                            done.append(self._complete(i, res.logdet))
                if "solve" in by_kind:
                    idx = by_kind["solve"]
                    self._run_block(res, "solve", idx,
                                    [self._slots[i].req.rhs for i in idx],
                                    res.fact.solve, done)
                if "sample" in by_kind:
                    idx = by_kind["sample"]
                    self._run_block(res, "sample", idx,
                                    [self._slots[i].z for i in idx],
                                    lambda Z: self._sample_block(res, Z),
                                    done)
                if "pcg_solve" in by_kind:
                    self._advance_pcg(res, done)
        self.stats.tick_seconds[-1] = time.perf_counter() - t0
        self._tick += 1
        return done

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, ServeResult]:
        """Tick until the queue, the retry pen and every slot drain (or
        ``max_ticks``); returns all results completed so far, keyed by
        rid. Direct kinds complete in their admission tick and PCG columns
        are bounded by their per-request ``maxiter``, so this ends."""
        ticks = 0
        while self._queue or self.active or self._backoff:
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.tick()
            ticks += 1
        return dict(self.results)

    def result(self, rid: int) -> ServeResult:
        if rid not in self.results:
            raise KeyError(f"request {rid} has not completed "
                           f"({self.pending} queued, {self.active} active)")
        return self.results[rid]
