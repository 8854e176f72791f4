"""Model assembly: stacked block parameters for every architecture family
(the port's ``repro/models/transformer.py``).

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

Each stacked tensor is drawn in place, layer by layer
(``layers.StackedDraws``), so a pattern position of R layers never exists
twice (llama4's MoE position is 16.1 B parameters).

Decode state is a tuple of per-pattern-position caches stacked over
repeats (``KVCache`` for attn, the fixed context ``KVCache`` for
cross-attention, ``SSMState`` for SSD layers; audio decoders append one
cross-attention ``KVCache`` per position after them); ``serve_step`` writes
them in place.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig
from .layers import KVCache
from .pshard import fsdp_gather, shard


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


def _init_block(gen, cfg: ModelConfig, mixer: str, mlp: str, dtype, dev):
    p: dict[str, Any] = {"norm1": L.init_norm(cfg, dtype, dev)}
    if mixer in ("attn", "cross"):
        p["mixer"] = L.init_attention(gen, cfg, dtype, dev)
    else:
        p["mixer"] = SSM.init_ssm(gen, cfg, dtype, dev)
    if cfg.family == "audio":  # decoder layers carry self + cross attention
        p["norm_c"] = L.init_norm(cfg, dtype, dev)
        p["cross"] = L.init_attention(gen, cfg, dtype, dev)
    if mlp == "moe":
        p["norm2"] = L.init_norm(cfg, dtype, dev)
        p["mlp"] = MOE.init_moe(gen, cfg, dtype, dev)
    elif cfg.d_ff > 0:  # pure-SSM archs (mamba2) have no MLP sublayer
        p["norm2"] = L.init_norm(cfg, dtype, dev)
        p["mlp"] = L.init_mlp(gen, cfg, dtype, dev)
    return p


def _init_encoder_block(gen, cfg: ModelConfig, dtype, dev):
    return {"norm1": L.init_norm(cfg, dtype, dev),
            "mixer": L.init_attention(gen, cfg, dtype, dev),
            "norm2": L.init_norm(cfg, dtype, dev),
            "mlp": L.init_mlp(gen, cfg, dtype, dev)}


def _init_stack(gen, R: int, make) -> dict:
    """R layers of ``make(gen)`` stacked on a leading axis, each drawn leaf
    drawn straight into its ``(R, ...)`` tensor."""
    draws = L.StackedDraws(gen, R)
    return draws.stack([make(draws.layer(r)) for r in range(R)])


def init_model(seed: Union[int, torch.Generator], cfg: ModelConfig, *,
               device=None) -> dict:
    """Random parameters drawn from ``seed`` (an int or a
    ``torch.Generator``, which then names the device; ``device="meta"``
    gives shapes only). The draws differ
    from ``jax.random``'s; carry JAX's weights across with
    ``repro_torch.convert.model_from_numpy``."""
    gen, dev = _generator(seed, device)
    dtype = cfg.tdtype
    R = cfg.num_pattern_repeats
    params: dict[str, Any] = {"emb": L.init_embeddings(gen, cfg, dtype, dev)}
    params["blocks"] = [
        _init_stack(gen, R, lambda g, mixer=mixer, mlp=mlp: _init_block(
            g, cfg, mixer, mlp, dtype, dev))
        for mixer, mlp in cfg.layer_pattern()]
    params["final_norm"] = L.init_norm(cfg, dtype, dev)
    if cfg.encoder_layers:
        params["encoder"] = {
            "blocks": _init_stack(gen, cfg.encoder_layers, lambda g:
                                  _init_encoder_block(g, cfg, dtype, dev)),
            "final_norm": L.init_norm(cfg, dtype, dev),
        }
    return params


def _unstack(tree: dict, R: int) -> list[dict]:
    """The R per-layer views of a stacked block tree (one ``unbind`` per
    leaf, so the backward pass stacks the gradients once)."""
    flat = {k: _unstack(v, R) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: v[r] for k, v in flat.items()} for r in range(R)]


# -- forward (full-sequence) --------------------------------------------------------


def _gather_seq(h):
    """A block's normed input with its sequence whole on each model rank:
    the sequence-parallel carry gathered before the tensor-parallel
    projections, as Megatron-SP does (XLA gathers it there too); in
    decode, the pending sum of the model ranks' partial outputs reduced,
    so that a column-parallel projection splits its work. Only a sharded
    run sees it: without a hook ``shard`` is the identity."""
    return shard(h, "dp", None, None)


def _scatter_seq(y):
    """A sublayer's output on the carry's layout (reduce-scattered over
    the sequence, as Megatron-SP does), so that its gradient reaches the
    sublayer's projections in their own layout and not split over the
    sequence (which DTensor plans by a slow graph search)."""
    return shard(y, "dp", "model", None)


def _apply_block(bp, x, cfg: ModelConfig, mixer: str, mlp: str, positions,
                 ctx, causal: bool):
    """One block: (x, the MoE auxiliary loss or None)."""
    aux = None
    bp = fsdp_gather(bp)
    h = _gather_seq(L.apply_norm(bp["norm1"], x, cfg.norm))
    if mixer == "attn":
        x = x + _scatter_seq(L.attention_block(bp["mixer"], h, cfg,
                                               positions, causal=causal))
    elif mixer == "cross":
        kv = L.cross_kv(bp["mixer"], ctx, cfg)
        x = x + _scatter_seq(L.attention_block(
            bp["mixer"], h, cfg, positions, causal=False, kv_override=kv,
            rope=False))
    else:
        x = x + _scatter_seq(SSM.ssd_forward(bp["mixer"], h, cfg))
    if cfg.family == "audio" and ctx is not None:
        hc = _gather_seq(L.apply_norm(bp["norm_c"], x, cfg.norm))
        kv = L.cross_kv(bp["cross"], ctx, cfg)
        x = x + _scatter_seq(L.attention_block(
            bp["cross"], hc, cfg, positions, causal=False, kv_override=kv,
            rope=False))
    if mlp == "moe":
        h2 = _gather_seq(L.apply_norm(bp["norm2"], x, cfg.norm))
        y, aux = MOE.apply_moe(bp["mlp"], h2, cfg)
        x = x + _scatter_seq(y)
    elif cfg.d_ff > 0:
        h2 = _gather_seq(L.apply_norm(bp["norm2"], x, cfg.norm))
        x = x + _scatter_seq(L.apply_mlp(bp["mlp"], h2, cfg.act))
    return x, aux


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(cfg: ModelConfig) -> dict:
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return kw


def apply_blocks(params, x, cfg: ModelConfig, *, ctx=None, causal=True):
    """The depth loop; returns (hidden, moe_aux): the MoE layers'
    auxiliary losses summed (0 without MoE layers)."""
    pat = cfg.layer_pattern()
    R = cfg.num_pattern_repeats
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)

    def step(bp, x, i):
        mixer, mlp = pat[i]
        return _apply_block(bp, x, cfg, mixer, mlp, positions, ctx, causal)

    if cfg.remat:
        plain, kw = step, _remat_kwargs(cfg)
        step = lambda bp, x, i: checkpoint(plain, bp, x, i, **kw)  # noqa: E731
    layers = [_unstack(bp, R) for bp in params["blocks"]]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(R):
        for i in range(len(pat)):
            x, a = step(layers[i][r], x, i)
            x = shard(x, "dp", "model", None)   # sequence-parallel carry
            if a is not None:
                aux = aux + a
    return L.apply_norm(params["final_norm"], x, cfg.norm), aux


def apply_encoder(params, frames, cfg: ModelConfig):
    """Whisper-style encoder over (precomputed) frame embeddings."""
    enc = params["encoder"]

    def body(bp, x):
        B, S, _ = x.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=x.device)[None].expand(B, S)
        bp = fsdp_gather(bp)
        h = _gather_seq(L.apply_norm(bp["norm1"], x, cfg.norm))
        x = x + _scatter_seq(L.attention_block(bp["mixer"], h, cfg, pos,
                                               causal=False))
        h2 = _gather_seq(L.apply_norm(bp["norm2"], x, cfg.norm))
        return x + _scatter_seq(L.apply_mlp(bp["mlp"], h2, cfg.act))

    step = body
    if cfg.remat:       # jax.checkpoint(body): the default policy
        def step(bp, x):
            return checkpoint(body, bp, x, use_reentrant=False)
    x = frames
    for bp in _unstack(enc["blocks"], cfg.encoder_layers):
        x = step(bp, x)
    return L.apply_norm(enc["final_norm"], x, cfg.norm)


def _context(params, batch, cfg: ModelConfig):
    """The cross-attention context of a batch: the encoder's output over
    ``frames`` (audio), the ``patches`` (VLM), else None."""
    if cfg.encoder_layers:
        return apply_encoder(params, batch["frames"], cfg)
    if cfg.frontend_tokens:
        return batch["patches"]
    return None


# -- train loss ----------------------------------------------------------------------


def train_loss(params, batch, cfg: ModelConfig, *, aux_weight: float = 0.01):
    """Causal-LM CE loss (chunked over the vocab projection)."""
    x = shard(L.embed(params["emb"], batch["tokens"]), "dp", "model", None)
    h, aux = apply_blocks(params, x, cfg, ctx=_context(params, batch, cfg),
                          causal=True)
    loss = L.chunked_ce_loss(params["emb"], h, batch["labels"])
    return loss + aux_weight * aux


# -- serving: prefill & decode ---------------------------------------------------------


class DecodeState(NamedTuple):
    caches: tuple                    # per pattern position, stacked over repeats
    cache_len: torch.Tensor          # () int32
    ctx_kv: Optional[tuple]          # not used; context KV lives in caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       ctx_len: int = 0, *, device=None):
    """Zero caches for one-token serve steps, one per pattern position,
    each stacked over the R repeats: a ``KVCache`` of ``(R, batch,
    max_len, KV, hd)`` for attn (int8 when ``cfg.kv_cache_dtype ==
    "int8"``), of ``(R, batch, ctx_len, KV, hd)`` for cross, an
    ``SSMState`` for SSD layers; audio decoders append one cross
    ``KVCache`` of ``ctx_len`` per position. ``device="meta"`` gives
    shapes only."""
    dev = device if str(device) == "meta" else resolve_device(device)
    dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.tdtype
    R, KV, hd = cfg.num_pattern_repeats, cfg.num_kv_heads, cfg.hd

    def kv(length):
        shape = (R, batch, length, KV, hd)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev))

    caches = []
    for mixer, _ in cfg.layer_pattern():
        if mixer == "attn":
            caches.append(kv(max_len))
        elif mixer == "cross":
            caches.append(kv(ctx_len))
        else:
            s = SSM.ssm_init_state(cfg, batch, dtype, device="meta")
            caches.append(SSM.SSMState(*(
                torch.zeros((R,) + tuple(x.shape), dtype=x.dtype, device=dev)
                for x in s)))
    # Audio decoders additionally carry per-position cross-attention KV
    # (encoder outputs projected per layer), appended after the self caches.
    if cfg.family == "audio":
        caches += [kv(ctx_len) for _ in cfg.layer_pattern()]
    return tuple(caches)


@torch.no_grad()
def serve_step(params, caches, token, cache_len, cfg: ModelConfig):
    """One-token decode: token (B, 1) -> (logits (B, 1, V), caches). The
    caches are updated in place and returned."""
    pat = cfg.layer_pattern()
    R = cfg.num_pattern_repeats
    cache_len = int(cache_len)
    x = L.embed(params["emb"], token)
    layers = [_unstack(bp, R) for bp in params["blocks"]]
    for r in range(R):
        for i, (mixer, mlp) in enumerate(pat):
            bp, c = fsdp_gather(layers[i][r]), caches[i]
            h = _gather_seq(L.apply_norm(bp["norm1"], x, cfg.norm))
            if mixer == "attn":
                out, _ = L.decode_attention(bp["mixer"], h, cfg,
                                            KVCache(c.k[r], c.v[r]),
                                            cache_len)
            elif mixer == "cross":
                out = L.decode_cross_attention(bp["mixer"], h, cfg,
                                               KVCache(c.k[r], c.v[r]))
            else:
                out, new = SSM.ssd_decode_step(
                    bp["mixer"], h, cfg, SSM.SSMState(c.conv[r], c.ssm[r]))
                c.conv[r].copy_(new.conv)
                c.ssm[r].copy_(new.ssm)
            x = x + out
            if cfg.family == "audio":
                hc = _gather_seq(L.apply_norm(bp["norm_c"], x, cfg.norm))
                cc = caches[len(pat) + i]
                x = x + L.decode_cross_attention(bp["cross"], hc, cfg,
                                                 KVCache(cc.k[r], cc.v[r]))
            if mlp == "moe":
                h2 = _gather_seq(L.apply_norm(bp["norm2"], x, cfg.norm))
                y, _ = MOE.apply_moe(bp["mlp"], h2, cfg)
                x = x + y
            elif cfg.d_ff > 0:
                h2 = _gather_seq(L.apply_norm(bp["norm2"], x, cfg.norm))
                x = x + L.apply_mlp(bp["mlp"], h2, cfg.act)
    h = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.unembed_logits(params["emb"], h), caches


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig):
    """Full-sequence forward returning last-position logits (B, 1, V)."""
    x = shard(L.embed(params["emb"], batch["tokens"]), "dp", "model", None)
    h, _ = apply_blocks(params, x, cfg, ctx=_context(params, batch, cfg),
                        causal=True)
    return L.unembed_logits(params["emb"], h[:, -1:])
