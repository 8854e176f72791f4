"""TLR inference serving on the port: continuous batching over resident
factorizations (counterpart of ``repro/serve``).

A fixed ``(n, slots)`` right-hand-side block, heterogeneous requests
(``solve`` / ``logdet`` / ``sample`` / ``pcg_solve``) packed into its
columns, finished work evicted and the columns refilled from a host-side
queue every tick -- the serving side of the paper's Algorithm 5. Shapes
stay fixed, so no new dispatch shape appears after warmup (the port's
``trace_counts`` registry pins it). See ``examples/serve_gp_torch.py``.
"""

from .queue import RequestQueue
from .request import KINDS, RequestRejected, ServeRequest, ServeResult
from .server import TLRServer
from .stats import ServerStats

__all__ = [
    "KINDS",
    "RequestQueue",
    "RequestRejected",
    "ServeRequest",
    "ServeResult",
    "ServerStats",
    "TLRServer",
]
