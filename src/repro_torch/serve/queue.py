"""Host-side FIFO request queue of the TLR inference server.

Slots that free up at the end of a tick refill from here in submit order,
so shapes stay fixed and occupancy stays high while there is work. Purely
host-side (the tick loop is single-threaded); rids are assigned
monotonically at submit.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from .request import ServeRequest


class RequestQueue:
    """FIFO of :class:`ServeRequest` with monotone rid assignment."""

    def __init__(self):
        self._q: deque[ServeRequest] = deque()
        self._next_rid = 0

    def submit(self, req: ServeRequest) -> int:
        """Assign the next rid (unless the caller set one >= 0), enqueue,
        and return the rid."""
        if req.rid < 0:
            req.rid = self._next_rid
        self._next_rid = max(self._next_rid, req.rid) + 1
        self._q.append(req)
        return req.rid

    def pop(self) -> Optional[ServeRequest]:
        """Next request in FIFO order, or None when empty."""
        return self._q.popleft() if self._q else None

    def peek(self) -> Optional[ServeRequest]:
        return self._q[0] if self._q else None

    def drain(self, pred) -> list[ServeRequest]:
        """Remove and return every queued request matching ``pred``,
        keeping FIFO order among both the kept and the drained ones."""
        out = [r for r in self._q if pred(r)]
        if out:
            self._q = deque(r for r in self._q if not pred(r))
        return out

    def requeue(self, reqs: list[ServeRequest]) -> None:
        """Push ``reqs`` back to the front, in their order (requests
        popped during refill but held out of admission stay ahead of newer
        work)."""
        for r in reversed(reqs):
            self._q.appendleft(r)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
