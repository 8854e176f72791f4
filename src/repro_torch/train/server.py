"""Batched decode server with continuous batching (the port's
``repro/train/server.py``).

Fixed decode slots; finished sequences are evicted and refilled from the
request queue at stable shapes -- the serving-side mirror of the paper's
dynamic batched ARA (Algorithm 5): converged work leaves the batch, pending
work enters, shapes never change, occupancy stays high.

Greedy decoding (``temperature == 0``) takes the argmax and gives the JAX
package's tokens. ``temperature > 0`` samples from a CPU
``torch.Generator`` seeded ``seed``, which draws other tokens than
``jax.random.categorical`` would.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import build_serve_step, init_decode_caches
from ..models.api import _enc_len
from ..models.config import ModelConfig
from ..tree import leaves


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    rid: int = 0


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list[int]


class DecodeServer:
    """Slot-based continuous batching over the one-token serve_step."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, seed: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.gen = torch.Generator().manual_seed(seed)
        self._serve = build_serve_step(cfg)
        self.caches = init_decode_caches(cfg, slots, max_len,
                                         ctx_len=_enc_len(cfg, max_len),
                                         device=self.device)
        # slot bookkeeping (host side, like the paper's subset marshaling)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_tokens: list[list[int]] = [[] for _ in range(slots)]
        self.slot_pos = np.zeros(slots, np.int32)
        self.ticks = 0

    def _reset_slot_cache(self, s: int):
        for c in leaves(self.caches):
            if c.ndim >= 2 and c.shape[1] == self.slots:
                c[:, s] = 0

    def run(self, requests: list[Request]) -> list[Completion]:
        queue = list(requests)
        done: list[Completion] = []
        # serve_step uses a single scalar cache_len for the batch, so the
        # server advances all active slots in lockstep and feeds prompt
        # tokens one-at-a-time (teacher forcing) until a slot switches to
        # generation. Positions are therefore uniform across slots.
        while queue or any(r is not None for r in self.slot_req):
            # refill empty slots
            for s in range(self.slots):
                if self.slot_req[s] is None and queue:
                    self.slot_req[s] = queue.pop(0)
                    self.slot_tokens[s] = []
                    self._reset_slot_cache(s)
                    self.slot_pos[s] = 0
            active = [s for s in range(self.slots)
                      if self.slot_req[s] is not None]
            if not active:
                break
            pos = int(self.slot_pos[active].max())
            tok = np.zeros((self.slots, 1), np.int32)
            for s in active:
                req = self.slot_req[s]
                p = int(self.slot_pos[s])
                if p < len(req.prompt):
                    tok[s, 0] = req.prompt[p]
                elif self.slot_tokens[s]:
                    tok[s, 0] = self.slot_tokens[s][-1]
                else:
                    tok[s, 0] = req.prompt[-1]
            logits, self.caches = self._serve(
                self.params, self.caches,
                torch.from_numpy(tok).to(self.device), pos)
            logits = logits[:, 0].float().cpu()
            self.ticks += 1
            for s in active:
                req = self.slot_req[s]
                self.slot_pos[s] += 1
                p = int(self.slot_pos[s])
                if p >= len(req.prompt):
                    if req.temperature > 0:
                        probs = torch.softmax(logits[s] / req.temperature, -1)
                        nxt = int(torch.multinomial(probs, 1,
                                                    generator=self.gen))
                    else:
                        nxt = int(torch.argmax(logits[s]))
                    self.slot_tokens[s].append(nxt)
                    if len(self.slot_tokens[s]) >= req.max_new_tokens or \
                            p >= self.max_len - 1:
                        done.append(Completion(rid=req.rid,
                                               tokens=self.slot_tokens[s]))
                        self.slot_req[s] = None
        return done
