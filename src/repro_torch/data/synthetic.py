"""Deterministic, shardable, resumable synthetic token pipeline (the port's
copy of ``repro/data/synthetic.py``: numpy only, so its batches are the JAX
package's bit for bit).

Batches are a pure function of (seed, step): resuming from a checkpoint at
step k replays exactly the stream a non-preempted run would have seen, and
any host can materialize just its slice (``host_slice``) -- the properties a
real distributed loader must have, provided here without an external corpus.

Tokens follow a Zipf distribution with document boundaries (EOS every
~doc_len tokens) so losses behave like natural text rather than uniform
noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    doc_len: int = 512
    eos_id: int = 0


class SyntheticTokens:
    """Stateless-by-step token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, *, host_index: int = 0,
                 host_count: int = 1) -> dict:
        cfg = self.cfg
        assert cfg.batch % host_count == 0
        local_b = cfg.batch // host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_index]))
        z = rng.zipf(cfg.zipf_a, size=(local_b, cfg.seq_len + 1))
        tokens = (z % (cfg.vocab_size - 1)) + 1     # reserve 0 for EOS
        # document boundaries
        doc = rng.geometric(1.0 / cfg.doc_len, size=(local_b, 8))
        pos = np.cumsum(doc, axis=1)
        for b in range(local_b):
            for p in pos[b]:
                if p < cfg.seq_len + 1:
                    tokens[b, p] = cfg.eos_id
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
