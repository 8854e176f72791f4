"""Column-stage graph both Cholesky drivers schedule over.

Own copy of ``repro/core/stages.py`` (pure Python), kept so the port's
``stats["schedule"]`` record has the JAX package's schema. Each column is
decomposed into *stages* -- ``diag`` (dense diagonal factor), ``panel``
(ARA + TRSM, or round + TRSM) and the right-looking trailing update
(``update`` as one node, or the ``update_head`` / ``update_tail`` split the
lookahead schedule needs) -- declared as :class:`Stage` nodes with explicit
``reads`` / ``writes`` / ``destroys`` resource tokens.
:func:`Schedule.order` turns the declared dataflow into an execution order
and :func:`run_graph` executes it on the host; each stage body enqueues its
device work asynchronously.

Tokens are *versioned values*, written exactly once. Three edge kinds fall
out:

* RAW -- a stage reading a token depends on its (unique) writer;
* WAW -- a token's writer depends on the previous writer of the same token;
* destruction anti-dependency -- a stage that ``destroys`` a token (it
  overwrites the backing buffer in place) must run after every *other*
  reader of that token. This is what lets the lookahead schedule run column
  ``k``'s trailing update after column ``k+1``'s panel: the panel reads the
  buffers before the update overwrites them.

``SequentialSchedule`` reproduces program order (the exact-parity default,
and the only legal order for the left-looking driver's serial dependency
chain). ``LookaheadSchedule`` sinks each column's ``update_tail`` below the
*next* column's diag + panel; the dependency edges guarantee the reorder is
legal (and ``order`` re-validates it). On the card the right-looking driver
runs each ``update_tail`` on a second CUDA stream, so it overlaps the next
column's panel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

__all__ = [
    "Stage", "Schedule", "SequentialSchedule", "LookaheadSchedule",
    "build_deps", "run_graph",
]


Token = tuple


@dataclasses.dataclass(frozen=True)
class Stage:
    """One schedulable unit of factorization work.

    ``fn`` runs on the host and mutates the driver's column state (it
    closes over it); the device work it enqueues is asynchronous. ``reads``
    / ``writes`` / ``destroys`` are tuples of hashable resource tokens --
    versioned values, each written by exactly one stage. ``seq`` is the
    construction index (program order), the tiebreaker every schedule
    falls back to.
    """

    name: str
    kind: str                      # "diag" | "panel" | "update" |
                                   # "update_head" | "update_tail" | "init"
    k: int
    fn: Callable[[], None]
    reads: tuple = ()
    writes: tuple = ()
    destroys: tuple = ()           # tokens whose buffers this stage overwrites
    seq: int = 0
    check: Optional[Callable[[], None]] = None
                                   # optional hook run immediately after
                                   # ``fn``, before any other stage. None
                                   # (the default) costs nothing.


def build_deps(stages: list[Stage]) -> dict[str, set[str]]:
    """Dependency edges from the declared tokens.

    Returns ``{stage.name: set of stage names that must run first}``.
    Declaration order carries no meaning -- readers and the destroyer of
    a token may appear in any list order; the edges alone decide legality
    (an unsatisfiable graph surfaces as a cycle in ``Schedule.order``).
    Raises on malformed graphs: duplicate stage names, two writers of one
    token (tokens are versioned values, written once), or two destroyers
    of one token (a buffer can only be overwritten once).
    """
    writer: dict[Token, str] = {}
    readers: dict[Token, list[str]] = {}
    destroyer: dict[Token, str] = {}
    deps: dict[str, set[str]] = {}
    for s in stages:
        if s.name in deps:
            raise ValueError(f"duplicate stage name {s.name!r}")
        deps[s.name] = set()
        for t in s.reads + s.destroys:
            readers.setdefault(t, []).append(s.name)
        for t in s.destroys:
            if t in destroyer:
                raise ValueError(
                    f"token {t!r} destroyed twice ({destroyer[t]!r} and "
                    f"{s.name!r}); a buffer can only be overwritten once")
            destroyer[t] = s.name
        for t in s.writes:
            if t in writer:
                raise ValueError(
                    f"token {t!r} written twice ({writer[t]!r} and "
                    f"{s.name!r}); tokens are versioned values")
            writer[t] = s.name
    for s in stages:
        # RAW: a consumer runs after the token's unique writer.
        for t in s.reads + s.destroys:
            w = writer.get(t)
            if w is not None and w != s.name:
                deps[s.name].add(w)
        # Donation anti-dependency: the destroyer runs after every other
        # reader of the token (it invalidates the backing buffer).
        for t in s.destroys:
            for r in readers.get(t, ()):
                if r != s.name:
                    deps[s.name].add(r)
    return deps


class Schedule:
    """Base scheduler: a priority over stages + list scheduling.

    ``order`` runs list scheduling over :func:`build_deps`: among the
    ready stages (all dependencies executed) the minimal ``priority``
    runs next. Subclasses only define the priority.
    """

    name = "base"

    def priority(self, s: Stage) -> tuple:
        raise NotImplementedError

    def order(self, stages: list[Stage]) -> list[Stage]:
        deps = build_deps(stages)
        by_name = {s.name: s for s in stages}
        pending = {s.name: set(deps[s.name]) for s in stages}
        dependents: dict[str, list[str]] = {s.name: [] for s in stages}
        for s in stages:
            for d in deps[s.name]:
                dependents[d].append(s.name)
        ready = sorted((s.name for s in stages if not pending[s.name]),
                       key=lambda n: self.priority(by_name[n]))
        out: list[Stage] = []
        done: set[str] = set()
        while ready:
            nm = ready.pop(0)
            out.append(by_name[nm])
            done.add(nm)
            released = []
            for d in dependents[nm]:
                pending[d].discard(nm)
                if not pending[d] and d not in done:
                    released.append(d)
            if released:
                ready.extend(released)
                ready.sort(key=lambda n: self.priority(by_name[n]))
        if len(out) != len(stages):
            stuck = [n for n, p in pending.items() if p and n not in done]
            raise ValueError(f"stage graph has a cycle; stuck: {stuck}")
        # Re-validate: every dependency precedes its dependent.
        pos = {s.name: i for i, s in enumerate(out)}
        for s in out:
            for d in deps[s.name]:
                if pos[d] >= pos[s.name]:
                    raise AssertionError(
                        f"schedule {self.name!r} ordered {s.name!r} before "
                        f"its dependency {d!r}")
        return out


class SequentialSchedule(Schedule):
    """Program order -- the exact-parity default (and the only legal
    order for the left-looking driver's serial dependency chain)."""

    name = "sequential"

    def priority(self, s: Stage) -> tuple:
        return (s.seq,)


class LookaheadSchedule(Schedule):
    """Right-looking lookahead: ``update_tail(k)`` sinks between
    ``panel(k+1)`` and ``update_head(k+1)``.

    Resulting order per column block: ``... update_head(k) -> diag(k+1)
    -> panel(k+1) -> update_tail(k) -> update_head(k+1) ...`` -- the
    narrow head update (next column's tiles + diagonal) runs first so
    column ``k+1`` can start, and the destruction anti-dependency (the tail
    overwrites the buffers the panel reads) pins the panel first.
    """

    name = "lookahead"

    _RANK = {"init": -1.0, "diag": 0.0, "panel": 1.0, "update": 2.0,
             "update_head": 3.0}

    def priority(self, s: Stage) -> tuple:
        if s.kind == "update_tail":
            return (s.k + 1, 1.5, s.seq)
        return (s.k, self._RANK.get(s.kind, 2.0), s.seq)


def run_graph(stages: list[Stage], schedule: Schedule,
              on_stage: Optional[Callable[[Stage, float], None]] = None
              ) -> dict:
    """Execute the stage graph under ``schedule`` and return the record
    the drivers put in ``stats["schedule"]``: the schedule name, the
    executed order, and per-kind host wall time."""
    order = schedule.order(stages)
    kind_seconds: dict[str, float] = {}
    checks = 0
    for s in order:
        t0 = time.perf_counter()
        s.fn()
        dt = time.perf_counter() - t0
        kind_seconds[s.kind] = kind_seconds.get(s.kind, 0.0) + dt
        if s.check is not None:
            # Health hook: validated (and possibly repaired) before any
            # later stage can consume -- or overwrite -- this stage's outputs.
            # Timed separately so the clean-path overhead is attributable.
            t0 = time.perf_counter()
            s.check()
            kind_seconds["check"] = (kind_seconds.get("check", 0.0)
                                     + time.perf_counter() - t0)
            checks += 1
        if on_stage is not None:
            on_stage(s, dt)
    return {
        "name": schedule.name,
        "stages": len(order),
        "order": [s.name for s in order],
        "kind_seconds": kind_seconds,
        "checks": checks,
    }
