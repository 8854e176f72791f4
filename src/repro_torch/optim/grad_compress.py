"""Low-rank gradient compression with error feedback (PowerSGD-style),
built on the paper's randomized range finder (the port's
``repro/optim/grad_compress.py``).

Before the data-parallel all-reduce, each 2-D gradient G (m x n) is
compressed to rank k via one randomized range-finding pass -- the sampling
step of the paper's ARA (``Y = G Omega``, ``Q = orth(Y)``, ``B = G^T Q``)
-- cutting the all-reduced payload from m*n to k*(m+n). The compression
residual is fed back into the next step's gradient (error feedback).
``payload_bytes`` / ``raw_bytes`` / ``ratio`` report the saving.

Omega comes from a ``torch.Generator`` (one draw per compressible leaf, in
leaf order) where the JAX package splits a key per leaf, so the two draw
different probes; ``_lowrank_pass`` takes Omega, so a test can feed it
JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    rank: int = 8
    min_size: int = 64 * 64   # only compress matrices at least this large
    error_feedback: bool = True


class CompressState(NamedTuple):
    error: Any   # residual tree (0-d zeros for uncompressed leaves)


def _is_compressible(leaf, cfg: CompressConfig) -> bool:
    return leaf.ndim == 2 and leaf.numel() >= cfg.min_size and \
        min(leaf.shape) > cfg.rank


def compress_init(grads_like, cfg: CompressConfig) -> CompressState:
    def zeros(g):
        shape = tuple(g.shape) if _is_compressible(g, cfg) else ()
        return torch.zeros(shape, dtype=torch.float32, device=g.device)
    return CompressState(error=tree_map(zeros, grads_like))


def _lowrank_pass(G, Om):
    """One-pass randomized range finder (the ARA sampling step) with the
    probes ``Om`` (n x k): G ~= Q B^T."""
    Y = G @ Om                       # sample
    Q, _ = torch.linalg.qr(Y)        # orthogonalize
    B = G.T @ Q                      # project
    return Q, B


@torch.no_grad()
def compress_grads(grads, state: CompressState, cfg: CompressConfig,
                   generator: torch.Generator):
    """Returns (decompressed_grads, new_state, stats).

    In a multi-host deployment the all-reduce runs on (Q, B) factors; here
    the decompressed gradient is returned (single-process semantics) with
    the payload accounting. ``stats["compressed"]`` lists the indices of
    the leaves that were compressed.
    """
    gl = leaves(grads)
    out, new_err, done = [], [], []
    raw_bytes = compressed_bytes = 0
    for i, (g, e) in enumerate(zip(gl, leaves(state.error))):
        raw_bytes += g.numel() * 4
        if not _is_compressible(g, cfg):
            out.append(g)
            new_err.append(torch.zeros((), dtype=torch.float32,
                                       device=g.device))
            compressed_bytes += g.numel() * 4
            continue
        gf = g.float()
        if cfg.error_feedback:
            gf = gf + e
        Om = torch.randn((g.shape[1], cfg.rank), generator=generator,
                         dtype=gf.dtype, device=gf.device)
        Q, B = _lowrank_pass(gf, Om)
        approx = Q @ B.T
        resid = gf - approx
        out.append(approx.to(g.dtype))
        new_err.append(resid if cfg.error_feedback
                       else torch.zeros_like(resid))
        compressed_bytes += (Q.numel() + B.numel()) * 4
        done.append(i)
    stats = {"payload_bytes": compressed_bytes, "raw_bytes": raw_bytes,
             "ratio": raw_bytes / max(compressed_bytes, 1),
             "compressed": done}
    return (unflatten(grads, out), CompressState(error=unflatten(grads,
                                                                 new_err)),
            stats)
