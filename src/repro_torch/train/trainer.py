"""Training loop with checkpoint/restart, preemption handling, straggler
detection and gradient compression (the port's
``repro/train/trainer.py``), run eagerly.

Fault-tolerance contract:

  * auto-resume: newest checkpoint in ``ckpt_dir`` is restored on start;
    the data pipeline is stateless-by-step so the token stream replays
    exactly;
  * preemption: SIGTERM/SIGINT triggers an emergency checkpoint at the next
    step boundary and a return with status ``"preempted"``; the handlers
    that were installed before ``run`` are put back when it returns;
  * straggler mitigation: per-step wall times feed a rolling median; steps
    slower than ``straggler_factor`` x median are logged to metrics.jsonl;
  * elastic restart: checkpoints store full logical arrays, so a restart may
    put them on another device (``restore_checkpoint(device=)``).

The checkpointed tree is ``(params, ostate)``, as in the JAX package, so a
checkpoint of one package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..checkpoint import latest_checkpoint, restore_checkpoint, \
    save_checkpoint
from ..data import DataConfig, SyntheticTokens
from ..device import resolve_device
from ..models import build_loss_fn, init_model
from ..models.config import ModelConfig
from ..optim import (AdamWConfig, CompressConfig, adamw_init, adamw_update,
                     compress_grads, compress_init, global_norm)
from ..tree import leaves, unflatten


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    ckpt_dir: str = "checkpoints"
    save_every: int = 50
    log_every: int = 10
    keep: int = 3
    seed: int = 0
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    compress: Optional[CompressConfig] = None
    straggler_factor: float = 3.0
    metrics_path: Optional[str] = None


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The compression probes' generator of one step (JAX folds the step
    into the run's key)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.data = SyntheticTokens(DataConfig(
            vocab_size=cfg.vocab_size, batch=tcfg.batch,
            seq_len=tcfg.seq_len, seed=tcfg.seed))
        self._preempted = False
        self._step_times: list[float] = []
        self._metrics_file = None
        self._loss_fn = build_loss_fn(cfg)
        # the step a run resumed from (None: it started afresh) and the
        # last compression stats
        self.resumed_from: Optional[int] = None
        self.compress_stats: Optional[dict] = None
        if tcfg.metrics_path:
            Path(tcfg.metrics_path).parent.mkdir(parents=True, exist_ok=True)
            self._metrics_file = open(tcfg.metrics_path, "a")

    def close(self) -> None:
        if self._metrics_file:
            self._metrics_file.close()
            self._metrics_file = None

    # -- one step ----------------------------------------------------------

    def fwd_bwd(self, params, batch):
        """(loss, grads, gnorm) at ``params`` (a tree of tensors)."""
        ps = leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in ps]
            loss = self._loss_fn(unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
        grads = unflatten(params, list(grads))
        return loss.detach(), grads, global_norm(grads)

    def apply(self, grads, ostate, params):
        return adamw_update(grads, ostate, params, self.tcfg.optimizer)

    # -- fault tolerance ---------------------------------------------------

    def _install_signal_handlers(self) -> dict:
        def handler(signum, frame):
            self._preempted = True
        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            old[sig] = signal.signal(sig, handler)
        return old

    def _log(self, rec: dict):
        if self._metrics_file:
            self._metrics_file.write(json.dumps(rec) + "\n")
            self._metrics_file.flush()

    def _straggler_check(self, step: int, dt: float):
        self._step_times.append(dt)
        window = self._step_times[-50:]
        med = float(np.median(window))
        if len(window) >= 10 and dt > self.tcfg.straggler_factor * med:
            self._log({"event": "straggler", "step": step, "dt": dt,
                       "median": med})

    # -- main loop -----------------------------------------------------------

    def run(self) -> dict:
        old = self._install_signal_handlers()
        try:
            return self._run()
        finally:
            for sig, h in old.items():
                signal.signal(sig, h)

    def _run(self) -> dict:
        tcfg, dev = self.tcfg, self.device
        params = init_model(tcfg.seed, self.cfg, device=dev)
        ostate = adamw_init(params, tcfg.optimizer)
        cstate = compress_init(params, tcfg.compress) if tcfg.compress \
            else None
        start_step = 0

        ck = latest_checkpoint(tcfg.ckpt_dir)
        if ck is not None:
            start_step, (params, ostate), _ = restore_checkpoint(
                ck, (params, ostate))
            self.resumed_from = start_step
            self._log({"event": "resumed", "step": start_step,
                       "from": str(ck)})

        losses = []
        for step in range(start_step, tcfg.steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in self.data.batch_at(step).items()}
            loss, grads, gnorm = self.fwd_bwd(params, batch)
            if cstate is not None:
                grads, cstate, self.compress_stats = compress_grads(
                    grads, cstate, tcfg.compress,
                    step_generator(tcfg.seed, step, dev))
            params, ostate = self.apply(grads, ostate, params)
            loss_f = float(loss)
            losses.append(loss_f)
            dt = time.time() - t0
            self._straggler_check(step, dt)
            if step % tcfg.log_every == 0:
                self._log({"event": "step", "step": step, "loss": loss_f,
                           "gnorm": float(gnorm), "dt": dt})
            if (step + 1) % tcfg.save_every == 0:
                save_checkpoint(tcfg.ckpt_dir, step + 1, (params, ostate),
                                keep=tcfg.keep, meta={"loss": loss_f})
            if self._preempted:
                save_checkpoint(tcfg.ckpt_dir, step + 1, (params, ostate),
                                keep=tcfg.keep, meta={"preempted": True})
                self._log({"event": "preempted", "step": step + 1})
                return {"status": "preempted", "step": step + 1,
                        "losses": losses}
        save_checkpoint(tcfg.ckpt_dir, tcfg.steps, (params, ostate),
                        keep=tcfg.keep, meta={"final": True})
        return {"status": "done", "step": tcfg.steps, "losses": losses,
                "params": params, "ostate": ostate}
