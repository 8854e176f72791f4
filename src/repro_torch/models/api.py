"""Public model API: input specs per (arch x shape) cell + step builders
(the port's ``repro/models/api.py``).

``input_specs`` returns tensors on the ``meta`` device (shape and dtype,
no allocation) where the JAX package returns ``ShapeDtypeStruct``s;
``materialize_inputs`` fills them with numpy-seeded data, the same values
as the JAX package's for the same seed.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_map
from . import transformer as T
from .config import SHAPES, ModelConfig, ShapeSpec


def _enc_len(cfg: ModelConfig, seq_len: int) -> int:
    """Stubbed frontend token count: whisper frames = seq/4 (conv downsample
    stand-in), VLM patch tokens = cfg.frontend_tokens (fixed per image)."""
    if cfg.family == "audio":
        return max(64, seq_len // 4)
    return cfg.frontend_tokens


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str | ShapeSpec) -> dict[str, Any]:
    """Meta-tensor stand-ins for every input of (arch, shape)."""
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = spec.global_batch, spec.seq_len
    if spec.kind in ("train", "prefill"):
        out = {"tokens": _spec((B, S), torch.int32)}
        if spec.kind == "train":
            out["labels"] = _spec((B, S), torch.int32)
        if cfg.family == "audio":
            out["frames"] = _spec((B, _enc_len(cfg, S), cfg.d_model),
                                  cfg.tdtype)
        elif cfg.frontend_tokens:
            out["patches"] = _spec((B, cfg.frontend_tokens, cfg.d_model),
                                   cfg.tdtype)
        return out
    # decode: one new token against a seq_len cache
    return {
        "token": _spec((B, 1), torch.int32),
        "caches": T.init_decode_caches(cfg, B, S, ctx_len=_enc_len(cfg, S),
                                       device="meta"),
        "cache_len": _spec((), torch.int32),
    }


# -- step builders -------------------------------------------------------------


def build_loss_fn(cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch):
        return T.train_loss(params, batch, cfg)
    return loss_fn


def build_prefill_fn(cfg: ModelConfig) -> Callable:
    def prefill_fn(params, batch):
        return T.prefill(params, batch, cfg)
    return prefill_fn


def build_serve_step(cfg: ModelConfig) -> Callable:
    def serve_fn(params, caches, token, cache_len):
        return T.serve_step(params, caches, token, cache_len, cfg)
    return serve_fn


def abstract_params(cfg: ModelConfig, seed: int = 0):
    """The parameter tree on the ``meta`` device: shapes, no allocation."""
    return T.init_model(seed, cfg, device="meta")


def materialize_inputs(cfg: ModelConfig, shape: str, seed: int = 0, *,
                       device=None):
    """Random concrete inputs matching input_specs (smoke tests)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def make(s):
        if not s.dtype.is_floating_point:
            x = rng.integers(0, max(2, cfg.vocab_size // 2), s.shape)
        else:
            x = rng.standard_normal(s.shape) * 0.02
        return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=s.dtype)

    return tree_map(make, input_specs(cfg, shape))
