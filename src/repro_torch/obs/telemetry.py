"""Span-based telemetry: the process-wide recording context.

Port of ``repro/obs/telemetry.py``. One module-level :class:`Telemetry`
instance (or ``None`` -- the disabled state) collects *spans*: named,
nested wall-time intervals opened at the natural phase boundaries of every
layer -- per-column phases in the Cholesky drivers, per-bucket launches in
the ``TilePlan`` dispatch paths, per-tick stages of the ``TLRServer`` loop.
Spans carry free-form numeric attributes; the instrumentation sites attach
``flops`` (useful) / ``flops_padded`` (dispatched, padding included)
estimates, bucket widths and rank-histogram snapshots, which
``obs.metrics_snapshot`` aggregates into per-phase FLOP/s and
padded-vs-useful ratios and ``obs.export_chrome_trace`` turns into a
Perfetto-loadable trace.

Design constraints, in order:

* **Zero-cost when disabled.** ``span(...)`` checks one module global and
  returns a shared no-op handle; no allocation, no clock read, no device
  interaction. Instrumentation sites gate any attribute *computation*
  behind ``enabled()``, so the disabled path is the pre-telemetry path.
* **Host-side only.** Spans never wait for the card: a span's duration is
  the host time of its ``with`` body. No telemetry site adds a
  ``torch.cuda.synchronize()``, an ``.item()`` or a ``.cpu()``; where a
  span must see a device value (a panel's ranks), it reads the host copy
  the driver already makes, so on the card most spans time the launches
  and the host work, and the spans that bracket a driver's own sync (the
  right driver's ``chol.sync``, a panel's rank read) time the device work
  too. Device-accurate timelines come from ``torch.profiler``: every
  enabled span also enters ``torch.profiler.record_function`` (a user range
  the profiler links to the kernels launched inside it) and, when a CUDA
  card is present, an NVTX range of the same name (for ``nsys``), so a
  device profile taken under telemetry aligns its kernels with these host
  spans by name. The JAX package also enters ``jax.named_scope``, which
  names the operations traced inside a span; the port traces nothing, so
  it has no counterpart.
* **No new dispatch shapes.** Telemetry never changes what is dispatched:
  enabling it adds no entry to the ``trace_counts`` registry.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Span:
    """One finished span: a named wall-time interval with attributes.

    ``ts`` / ``dur`` are seconds relative to the owning telemetry's epoch;
    ``parent`` is the id of the enclosing span (-1 at the root), ``depth``
    its nesting depth, ``cat`` the layer ("factor" / "solve" / "algebra" /
    "serve") the Chrome-trace export maps to a Perfetto track.
    """

    id: int
    name: str
    cat: str
    ts: float
    dur: float
    parent: int
    depth: int
    args: Dict[str, Any]


class _SpanHandle:
    """Open-span context manager returned by :meth:`Telemetry.start_span`.

    The finished :class:`Span` shares the handle's ``args`` dict, so an
    attribute ``set`` after the span closed (a value the driver reads on
    the host only later) still lands on the recorded span."""

    __slots__ = ("_tel", "id", "name", "cat", "parent", "depth", "t0",
                 "args", "_ctxs")

    def __init__(self, tel: "Telemetry", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.cat = cat
        self.args = args
        self._ctxs = ()

    def set(self, **attrs) -> "_SpanHandle":
        """Attach (or overwrite) attributes on the span."""
        self.args.update(attrs)
        return self

    def __enter__(self) -> "_SpanHandle":
        self._tel._enter(self)
        return self

    def __exit__(self, *exc) -> None:
        self._tel._exit(self)


class _NoopSpan:
    """The shared disabled-mode handle: every operation is a no-op. A
    single instance serves every ``span()`` call while telemetry is off,
    so the disabled path allocates nothing."""

    __slots__ = ()
    id = -1

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _NvtxRange:
    """An NVTX range (``nsys``'s view of a span). Entered only when a CUDA
    card is present: a CPU-only torch build has no NVTX and raises."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc) -> None:
        torch.cuda.nvtx.range_pop()


def _device_annotations(name: str, nvtx: bool) -> list:
    """Profiler alignment contexts for one span: a
    ``torch.profiler.record_function`` range (the host range that
    ``torch.profiler`` links to the CUDA kernels launched inside it), and
    with ``nvtx`` an NVTX range of the same name."""
    ctxs = [torch.profiler.record_function(name)]
    if nvtx:
        ctxs.append(_NvtxRange(name))
    return ctxs


class Telemetry:
    """One recording session: finished spans, counter events, an epoch.

    Thread-correct for the repo's actual concurrency (the drivers and the
    server are single-threaded hosts; a lock guards the shared lists so a
    background submitter thread cannot corrupt them), but span *nesting*
    is tracked per-thread: each thread sees its own open-span stack.
    """

    def __init__(self, *, device_annotations: bool = True):
        self._clock = time.perf_counter
        self.epoch = self._clock()
        self.spans: List[Span] = []
        self.counters: List[tuple] = []   # (name, ts, {series: value})
        self.device_annotations = device_annotations
        # NVTX only where a card is: asked once, not at every span.
        self._nvtx = device_annotations and torch.cuda.is_available()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0

    # -- span lifecycle ----------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def start_span(self, name: str, cat: str,
                   args: Dict[str, Any]) -> _SpanHandle:
        return _SpanHandle(self, name, cat, args)

    def _enter(self, h: _SpanHandle) -> None:
        st = self._stack()
        with self._lock:
            h.id = self._next_id
            self._next_id += 1
        h.parent = st[-1].id if st else -1
        h.depth = len(st)
        st.append(h)
        if self.device_annotations:
            ctxs = _device_annotations(h.name, self._nvtx)
            for c in ctxs:
                c.__enter__()
            h._ctxs = tuple(ctxs)
        h.t0 = self._clock()

    def _exit(self, h: _SpanHandle) -> None:
        t1 = self._clock()
        for c in reversed(h._ctxs):
            c.__exit__(None, None, None)
        st = self._stack()
        if st and st[-1] is h:
            st.pop()
        sp = Span(id=h.id, name=h.name, cat=h.cat, ts=h.t0 - self.epoch,
                  dur=t1 - h.t0, parent=h.parent, depth=h.depth,
                  args=h.args)
        with self._lock:
            self.spans.append(sp)

    # -- counters ----------------------------------------------------------

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """Record one multi-series counter sample (Chrome-trace ``ph="C"``)."""
        with self._lock:
            self.counters.append((name, self._clock() - self.epoch,
                                  dict(values)))

    def record_retraces(self) -> None:
        """Fold the dispatch-shape registry (``core/buckets.py``) in as a
        counter sample: the retrace timeline, on the trace."""
        from ..core.buckets import trace_counts

        self.counter("retraces", trace_counts())

    # -- selection ---------------------------------------------------------

    def subtree(self, root) -> List[Span]:
        """Finished spans in the subtree of ``root`` (a handle, a span, or
        an id), root included; all spans for ``root=None``."""
        if root is None:
            return list(self.spans)
        rid = root if isinstance(root, int) else root.id
        keep = {rid}
        out = []
        for sp in self.spans:
            if sp.id in keep or sp.parent in keep:
                keep.add(sp.id)
                out.append(sp)
        # Children close before their parent, so a child may be seen before
        # its parent joined ``keep``: iterate to a fixed point.
        changed = True
        while changed:
            changed = False
            for sp in self.spans:
                if sp.id not in keep and sp.parent in keep:
                    keep.add(sp.id)
                    out.append(sp)
                    changed = True
        out.sort(key=lambda s: (s.ts, s.id))
        return out


# -- module-level state (the process-wide context) -----------------------------

_STATE: Optional[Telemetry] = None


def enabled() -> bool:
    """Is telemetry recording? The one check every instrumentation site
    gates its attribute computation behind."""
    return _STATE is not None


def current() -> Optional[Telemetry]:
    """The active :class:`Telemetry`, or None when disabled."""
    return _STATE


def enable(*, device_annotations: bool = True) -> Telemetry:
    """Start (or restart) recording; returns the fresh context. Any
    previous context is dropped -- export it first if you need it."""
    global _STATE
    _STATE = Telemetry(device_annotations=device_annotations)
    return _STATE


def disable() -> Optional[Telemetry]:
    """Stop recording; returns the (now inert) context so callers can
    still export or snapshot it."""
    global _STATE
    tel, _STATE = _STATE, None
    return tel


def span(name: str, cat: str = "", **args):
    """Open a span (context manager). The disabled fast path returns the
    shared :data:`NOOP_SPAN` without touching the clock."""
    tel = _STATE
    if tel is None:
        return NOOP_SPAN
    return tel.start_span(name, cat, args)


def counter(name: str, values: Dict[str, float]) -> None:
    tel = _STATE
    if tel is not None:
        tel.counter(name, values)


def record_retraces() -> None:
    tel = _STATE
    if tel is not None:
        tel.record_retraces()


def traced(name: str, cat: str = ""):
    """Decorator form of :func:`span` for whole entry points (the algebra
    layer's ``tlr_gemm`` / ``tlr_syrk`` / rounding passes): one span per
    call, the disabled path one global check + a direct tail call."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _STATE is None:
                return fn(*args, **kwargs)
            with _STATE.start_span(name, cat, {}):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def rank_hist(ranks, cap: int) -> Dict[str, int]:
    """Compact rank-histogram snapshot on the power-of-two rank ladder:
    ``{"0": n_zero, "1": ..., "2": ..., ...}`` with each positive rank
    counted at the ladder width it buckets up to -- the span attribute the
    drivers attach at column boundaries (JSON-friendly string keys).
    ``ranks`` is a host array: the drivers pass the copy they already
    read."""
    from ..core.buckets import _bucket_ladder

    rk = np.asarray(ranks).reshape(-1)
    out: Dict[str, int] = {}
    nz = int((rk <= 0).sum())
    if nz:
        out["0"] = nz
    ladder = np.asarray(_bucket_ladder(int(cap)), np.int64)
    if ladder.size:
        pos = rk[rk > 0]
        ix = np.minimum(np.searchsorted(ladder, pos), ladder.size - 1)
        for i in sorted(set(ix.tolist())):
            out[str(int(ladder[i]))] = int((ix == i).sum())
    return out
