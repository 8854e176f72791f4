"""Model assembly: stacked block parameters for the dense family (the port's
``repro/models/transformer.py``).

Layers are grouped into the repeating (mixer, mlp) *pattern* of
``cfg.layer_pattern()``; the parameter tree holds one dict per pattern
position whose leaves carry a leading ``repeats`` axis ``(R, ...)``, as
the JAX package's scanned stack does. The depth loop runs ``r`` over that
axis (the leaves are unbound once, so autograd stacks the per-layer
gradients into each leaf's gradient). The tree therefore has JAX's names,
shapes and leaf order: the optimizers, the checkpoints and the K-FAC
``curvature`` keys see the same tree in both packages. With ``cfg.remat``
each block is rematerialized in the backward pass
(``torch.utils.checkpoint``, non-reentrant); ``remat_policy="dots"`` keeps
the outputs of the plain matrix products (``mm`` / ``addmm``; the batched
attention products are recomputed), as JAX's
``dots_with_no_batch_dims_saveable``.

Decode state is a tuple of per-pattern-position ``KVCache``s stacked over
repeats; ``serve_step`` writes them in place.

Only the dense family runs (``mixer == "attn"``, ``mlp == "dense"``): a
config whose pattern needs SSM, cross-attention or MoE layers, or an
encoder, raises ``NotImplementedError`` (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import functools
from typing import Any, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig
from .layers import KVCache
from .pshard import shard


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` is a dense attention block."""
    kinds = set(cfg.layer_pattern())
    if cfg.family in ("audio", "vlm") or cfg.encoder_layers or \
            cfg.frontend_tokens or kinds != {("attn", "dense")} or \
            cfg.d_ff <= 0:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with layers "
            f"{sorted(kinds)} is not ported yet (only dense attention "
            "blocks run; MoE, SSM, hybrid, audio and VLM are ROADMAP "
            "Queue 1 item 10)")


def _generator(seed: Union[int, torch.Generator], device):
    """(generator, device): a given generator draws on its own device; an
    int seeds one on ``device`` (``"meta"``: shapes only, no draws)."""
    if isinstance(seed, torch.Generator):
        return seed, seed.device
    if str(device) == "meta":
        return torch.Generator().manual_seed(int(seed)), torch.device("meta")
    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(int(seed)), dev


# -- init -------------------------------------------------------------------------


def _init_block(gen, cfg: ModelConfig, dtype, dev):
    return {"norm1": L.init_norm(cfg, dtype, dev),
            "mixer": L.init_attention(gen, cfg, dtype, dev),
            "norm2": L.init_norm(cfg, dtype, dev),
            "mlp": L.init_mlp(gen, cfg, dtype, dev)}


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_model(seed: Union[int, torch.Generator], cfg: ModelConfig, *,
               device=None) -> dict:
    """Random parameters drawn from ``seed`` (an int or a
    ``torch.Generator``, which then names the device; ``device="meta"``
    gives shapes only). The draws differ
    from ``jax.random``'s; carry JAX's weights across with
    ``repro_torch.convert.model_from_numpy``."""
    check_supported(cfg)
    gen, dev = _generator(seed, device)
    dtype = cfg.tdtype
    R = cfg.num_pattern_repeats
    params: dict[str, Any] = {"emb": L.init_embeddings(gen, cfg, dtype, dev)}
    params["blocks"] = [_stack([_init_block(gen, cfg, dtype, dev)
                                for _ in range(R)])
                        for _ in cfg.layer_pattern()]
    params["final_norm"] = L.init_norm(cfg, dtype, dev)
    return params


def _unstack(tree: dict, R: int) -> list[dict]:
    """The R per-layer views of a stacked block tree (one ``unbind`` per
    leaf, so the backward pass stacks the gradients once)."""
    flat = {k: _unstack(v, R) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: v[r] for k, v in flat.items()} for r in range(R)]


# -- forward (full-sequence) --------------------------------------------------------


def _apply_block(bp, x, cfg: ModelConfig, positions, causal: bool):
    h = L.apply_norm(bp["norm1"], x, cfg.norm)
    x = x + L.attention_block(bp["mixer"], h, cfg, positions, causal=causal)
    h2 = L.apply_norm(bp["norm2"], x, cfg.norm)
    return x + L.apply_mlp(bp["mlp"], h2, cfg.act)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def apply_blocks(params, x, cfg: ModelConfig, *, causal=True):
    """The depth loop; returns (hidden, moe_aux) with moe_aux 0 (dense)."""
    check_supported(cfg)
    pat = cfg.layer_pattern()
    R = cfg.num_pattern_repeats
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    step = functools.partial(_apply_block, cfg=cfg, positions=positions,
                             causal=causal)
    if cfg.remat:
        kw = {"use_reentrant": False}
        if cfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        plain = step
        step = lambda bp, x: checkpoint(plain, bp, x, **kw)  # noqa: E731
    layers = [_unstack(bp, R) for bp in params["blocks"]]
    for r in range(R):
        for i in range(len(pat)):
            x = step(layers[i][r], x)
            x = shard(x, "dp", "model", None)   # sequence-parallel carry
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.apply_norm(params["final_norm"], x, cfg.norm), aux


# -- train loss ----------------------------------------------------------------------


def train_loss(params, batch, cfg: ModelConfig, *, aux_weight: float = 0.01):
    """Causal-LM CE loss (chunked over the vocab projection)."""
    x = shard(L.embed(params["emb"], batch["tokens"]), "dp", "model", None)
    h, aux = apply_blocks(params, x, cfg, causal=True)
    loss = L.chunked_ce_loss(params["emb"], h, batch["labels"])
    return loss + aux_weight * aux


# -- serving: prefill & decode ---------------------------------------------------------


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       ctx_len: int = 0, *, device=None):
    """Zero caches for one-token serve steps: one ``KVCache`` of
    ``(R, batch, max_len, KV, hd)`` per pattern position (int8 when
    ``cfg.kv_cache_dtype == "int8"``). ``device="meta"`` gives shapes
    only."""
    check_supported(cfg)
    dev = device if str(device) == "meta" else resolve_device(device)
    dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.tdtype
    shape = (cfg.num_pattern_repeats, batch, max_len, cfg.num_kv_heads,
             cfg.hd)
    return tuple(KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                         v=torch.zeros(shape, dtype=dtype, device=dev))
                 for _ in cfg.layer_pattern())


@torch.no_grad()
def serve_step(params, caches, token, cache_len, cfg: ModelConfig):
    """One-token decode: token (B, 1) -> (logits (B, 1, V), caches). The
    caches are updated in place and returned."""
    check_supported(cfg)
    pat = cfg.layer_pattern()
    R = cfg.num_pattern_repeats
    cache_len = int(cache_len)
    x = L.embed(params["emb"], token)
    layers = [_unstack(bp, R) for bp in params["blocks"]]
    for r in range(R):
        for i in range(len(pat)):
            bp, c = layers[i][r], caches[i]
            h = L.apply_norm(bp["norm1"], x, cfg.norm)
            out, _ = L.decode_attention(bp["mixer"], h, cfg,
                                        KVCache(c.k[r], c.v[r]), cache_len)
            x = x + out
            h2 = L.apply_norm(bp["norm2"], x, cfg.norm)
            x = x + L.apply_mlp(bp["mlp"], h2, cfg.act)
    h = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.unembed_logits(params["emb"], h), caches


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig):
    """Full-sequence forward returning last-position logits (B, 1, V)."""
    x = shard(L.embed(params["emb"], batch["tokens"]), "dp", "model", None)
    h, _ = apply_blocks(params, x, cfg, causal=True)
    return L.unembed_logits(params["emb"], h[:, -1:])
