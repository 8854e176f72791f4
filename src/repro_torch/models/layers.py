"""Transformer building blocks: norms, RoPE, GQA attention (chunked /
decode), MLPs, embeddings, chunked cross-entropy (the port's
``repro/models/layers.py``).

Parameters are plain dicts of tensors in the JAX package's layout: a
projection is an ``(in, out)`` matrix applied as ``x @ W``. ``init_*``
builds a dict with draws from an explicit ``torch.Generator`` on the
device named; the other functions consume one. Attention over long
sequences is the JAX package's online-softmax scan over KV chunks, in torch
ops with ``torch.utils.checkpoint`` for ``jax.checkpoint``, so the (S x S)
score matrix is never materialized. It is no Pallas kernel in the JAX
package, and the port keeps its algorithm (not
``scaled_dot_product_attention``) so the two agree chunk by chunk.
``StackedDraws`` lets the ``init_*`` functions draw a stack of layers
straight into its ``(R, ...)`` tensors.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import is_dtensor
from .pshard import local, reshape, shard

# -- initializers ---------------------------------------------------------------


def _dense_init(gen, shape, dtype, device, scale: float = 1.0):
    """A (fan_in, ...) weight of standard deviation scale / sqrt(fan_in),
    drawn in float32 from ``gen`` (a ``torch.Generator`` or a
    ``StackedDraws``)."""
    std = float(scale / np.sqrt(shape[0]))
    if isinstance(gen, StackedDraws):
        return gen.draw(tuple(shape), dtype, device, std)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


class StackedDraws:
    """The draws of R stacked layers, written straight into their
    ``(R, ...)`` tensors: the k-th draw of layer r lands in slot r of the
    k-th tensor. Layers are drawn in turn (``layer(r)`` before each), so
    the values are those of drawing each layer's tree and stacking them,
    while no more than one layer's leaf is held in float32 beside the
    stack."""

    def __init__(self, gen: torch.Generator, R: int):
        self.gen, self.R = gen, R
        self.out: list[torch.Tensor] = []
        self._first: list[torch.Tensor] = []   # layer 0's views, by draw
        self.r = self.k = 0

    def layer(self, r: int) -> "StackedDraws":
        self.r, self.k = r, 0
        return self

    def draw(self, shape, dtype, device, std: float) -> torch.Tensor:
        if self.r == 0:
            self.out.append(torch.empty((self.R,) + shape, dtype=dtype,
                                        device=device))
        dst = self.out[self.k]
        self.k += 1
        if dst.device.type != "meta":
            x = torch.randn(shape, generator=self.gen, device=device,
                            dtype=torch.float32)
            dst[self.r].copy_(x.mul_(std))
            del x
        view = dst[self.r]
        if self.r == 0:
            self._first.append(view)
        return view

    def stack(self, trees: list[dict]) -> dict:
        """The stacked tree of the R layers' trees: each drawn leaf is its
        ``(R, ...)`` tensor, every other leaf (norm scales, biases, SSM
        constants) is stacked."""
        return _stack_trees(trees, {id(v): t for v, t in
                                    zip(self._first, self.out)})


def _stack_trees(ts: list, drawn: dict):
    # a module-level recursion: a closure calling itself is a reference
    # cycle, which would keep the stacked tensors alive until the cyclic
    # garbage collector runs, long after the caller dropped them
    if isinstance(ts[0], dict):
        return {k: _stack_trees([t[k] for t in ts], drawn) for k in ts[0]}
    full = drawn.get(id(ts[0]))
    return torch.stack(ts) if full is None else full


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


# -- norms ----------------------------------------------------------------------


def init_norm(cfg, dtype, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (xf * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


# -- rotary embeddings -----------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None):
    e = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(theta, e)      # float32, theta rounded to it


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- attention -------------------------------------------------------------------


def init_attention(gen, cfg, dtype, device):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": _dense_init(gen, (D, H * hd), dtype, device),
        "wk": _dense_init(gen, (D, KV * hd), dtype, device),
        "wv": _dense_init(gen, (D, KV * hd), dtype, device),
        "wo": _dense_init(gen, (H * hd, D), dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def _qkv(p, x, cfg, positions, rope: bool = True):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = reshape(q, B, S, H, hd)
    k = reshape(k, B, S, KV, hd)
    v = reshape(v, B, S, KV, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "dp", None, "model", None)
    k = shard(k, "dp", None, "model", None)
    v = shard(v, "dp", None, "model", None)
    return q, k, v


def _pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target."""
    c = min(target, S)
    while S % c:
        c -= 1
    return max(c, 1)


class SoftmaxState(NamedTuple):
    m: torch.Tensor    # running max        (B, KV, G, Sq)
    l: torch.Tensor    # running denom      (B, KV, G, Sq)
    acc: torch.Tensor  # running numerator  (B, KV, G, Sq, hd)


def _online_softmax_step(state: SoftmaxState, logits, vc):
    """logits: (B, KV, G, Sq, Sk); vc: (B, Sk, KV, hd)."""
    m_new = torch.maximum(state.m, logits.amax(-1))
    scale = torch.exp(state.m - m_new)
    probs = torch.exp(logits - m_new[..., None])
    l_new = state.l * scale + probs.sum(-1)
    acc = state.acc * scale[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", probs, vc.to(probs.dtype))
    return SoftmaxState(m_new, l_new, acc)


# Python scalars where JAX has constants: a scalar tensor made on the card
# from the host would be a copy that waits for the card
_NEG = -1e30


def _attend_chunks(qc, qp, ks, vs, kps, scale, causal, out_dtype):
    """One q chunk against a sequence of kv chunks: the online-softmax scan.
    qc: (B, q_chunk, KV, G, hd); qp: (q_chunk,) absolute positions."""
    B, qn, KV, G, hd = qc.shape
    state = SoftmaxState(
        m=torch.full((B, KV, G, qn), -math.inf, dtype=torch.float32,
                     device=qc.device),
        l=torch.zeros((B, KV, G, qn), dtype=torch.float32, device=qc.device),
        acc=torch.zeros((B, KV, G, qn, hd), dtype=torch.float32,
                        device=qc.device))
    qf = qc.float()
    for kc, vc, kp in zip(ks, vs, kps):
        logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kc.float()) * scale
        if causal:
            mask = qp[:, None] >= kp[None, :]
            logits = torch.where(mask[None, None, None], logits, _NEG)
        state = _online_softmax_step(state, logits, vc)
    out = state.acc / torch.clamp(state.l, min=1e-30)[..., None]
    return out.to(out_dtype)  # (B, KV, G, q_chunk, hd)


def chunked_attention(q, k, v, *, causal: bool, k_chunk: int = 512,
                      q_chunk: int = 512, q_offset: int = 0):
    """Online-softmax attention; never materializes (S x S).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). GQA via head grouping.
    ``q_offset`` is the absolute position of q[0] (prefill continuation).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = float(1.0 / np.sqrt(hd))
    q_chunk = _pick_chunk(Sq, q_chunk)
    k_chunk = _pick_chunk(Sk, k_chunk)
    nq = Sq // q_chunk
    nk = Sk // k_chunk

    qr = reshape(q, B, nq, q_chunk, KV, G, hd)
    kr = reshape(k, B, nk, k_chunk, KV, hd).unbind(1)
    vr = reshape(v, B, nk, k_chunk, KV, hd).unbind(1)
    q_pos = (q_offset + torch.arange(Sq, device=q.device)).reshape(nq,
                                                                   q_chunk)
    k_pos = torch.arange(Sk, device=q.device).reshape(nk, k_chunk).unbind(0)

    # Triangular causal schedule: q-chunk i only visits kv-chunks 0..i
    # (the JAX package's condition, layers.py:188-189); otherwise the
    # rectangle over every kv chunk, masked when causal. Each q chunk is
    # rematerialized in the backward pass.
    triangular = causal and Sq == Sk and q_chunk == k_chunk and \
        q_offset == 0 and nq <= 64

    def one_q_chunk(qi, qc):
        hi = qi + 1 if triangular else nk
        return _attend_chunks(qc, q_pos[qi], kr[:hi], vr[:hi], k_pos[:hi],
                              scale, causal, q.dtype)

    outs = [_remat(one_q_chunk, qi, qr[:, qi]) for qi in range(nq)]
    out = torch.stack(outs, dim=1)        # (B, nq, KV, G, q_chunk, hd)
    out = out.permute(0, 1, 4, 2, 3, 5)   # (B, nq, q_chunk, KV, G, hd)
    return out.reshape(B, Sq, H * hd)


def attention_block(p, x, cfg, positions, *, causal=True, kv_override=None,
                    rope=True):
    """Self-attention (or cross-attention when kv_override=(k, v) given)."""
    q, k, v = _qkv(p, x, cfg, positions, rope=rope)
    if kv_override is not None:
        k, v = kv_override
    heads = ("dp", None, "model", None)
    out = local(functools.partial(chunked_attention, causal=causal),
                ("dp", None, "model"), (heads, heads, heads), q, k, v)
    out = shard(out, "dp", None, "model")
    return out.to(x.dtype) @ p["wo"]


def cross_kv(p, ctx, cfg):
    """K/V projections of a context sequence (encoder out / image tokens)."""
    B, T, _ = ctx.shape
    KV, hd = cfg.num_kv_heads, cfg.hd
    ctx = shard(ctx, "dp", None, None)      # the sequence whole on a rank
    k = reshape(ctx @ p["wk"], B, T, KV, hd)
    v = reshape(ctx @ p["wv"], B, T, KV, hd)
    if "bk" in p:
        k = k + reshape(p["bk"], KV, hd)
        v = v + reshape(p["bv"], KV, hd)
    return k, v


# -- decode-step attention -------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, KV, hd); model dtype or int8
    v: torch.Tensor     # (B, S_max, KV, hd)


_KV_SCALE = 16.0   # static symmetric scale for int8 KV quantization


def _kv_quant(x, dtype):
    if dtype != torch.int8:
        return x.to(dtype)
    return torch.clamp(torch.round(x.float() * _KV_SCALE),
                       -127, 127).to(torch.int8)


def _kv_dequant(x, dtype):
    if x.dtype != torch.int8:
        return x.to(dtype)
    return (x.float() / _KV_SCALE).to(dtype)


def decode_attention(p, x, cfg, cache: KVCache, cache_len, *, rope=True):
    """One-token decode against a KV cache; returns (out, cache).

    x: (B, 1, D); cache_len: int -- number of valid cache positions, one
    for the whole batch. The new key and value are written into ``cache``
    in place at position ``cache_len`` (clamped into the cache, as
    ``dynamic_update_slice`` clamps), and the same cache is returned.
    """
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // KV
    cache_len = int(cache_len)
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos, rope=rope)
    S = cache.k.shape[1]
    at = min(max(cache_len, 0), S - 1)
    cache.k[:, at] = _kv_quant(k[:, 0], cache.k.dtype)
    cache.v[:, at] = _kv_quant(v[:, 0], cache.v.dtype)
    heads = ("dp", None, "model", None)
    out = local(functools.partial(_decode_attend, cache_len=cache_len),
                ("dp", None, "model"), (heads, heads, heads),
                q, cache.k, cache.v)
    return out.to(x.dtype) @ p["wo"], cache


def _decode_attend(q, ck, cv, cache_len: int):
    """One query position against a cache's first ``cache_len + 1``
    positions: q (B, 1, H, hd), ck / cv (B, S, KV, hd) -> (B, 1, H hd)."""
    B, _, H, hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    G = H // KV
    qh = q.reshape(B, KV, G, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qh.float(),
                          _kv_dequant(ck, torch.float32)
                          ) * float(1.0 / np.sqrt(hd))
    valid = torch.arange(S, device=q.device) <= cache_len
    logits = torch.where(valid[None, None, None, :], logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs,
                       _kv_dequant(cv, torch.float32))
    return out.reshape(B, 1, H * hd)


def decode_cross_attention(p, x, cfg, ckv: KVCache):
    """One-token cross-attention against a fixed (precomputed) context KV."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.hd
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = reshape(q, B, 1, H, hd)
    heads = ("dp", None, "model", None)
    out = local(_cross_attend, ("dp", None, "model"), (heads, heads, heads),
                q, ckv.k, ckv.v)
    return out.to(x.dtype) @ p["wo"]


def _cross_attend(q, ck, cv):
    """One query position against a whole context: q (B, 1, H, hd),
    ck / cv (B, T, KV, hd) -> (B, 1, H hd)."""
    B, _, H, hd = q.shape
    KV = ck.shape[2]
    qh = q.reshape(B, KV, H // KV, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qh.float(),
                          ck.float()) * float(1.0 / np.sqrt(hd))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cv.float())
    return out.reshape(B, 1, H * hd)


# -- MLP -------------------------------------------------------------------------


def init_mlp(gen, cfg, dtype, device, d_ff: int = 0):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wg": _dense_init(gen, (D, Fd), dtype, device),
            "wu": _dense_init(gen, (D, Fd), dtype, device),
            "wd": _dense_init(gen, (Fd, D), dtype, device),
        }
    return {
        "wi": _dense_init(gen, (D, Fd), dtype, device),
        "wo": _dense_init(gen, (Fd, D), dtype, device),
    }


def apply_mlp(p, x, act: str):
    if act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]


# -- embeddings & loss -----------------------------------------------------------


def init_embeddings(gen, cfg, dtype, device):
    p = {"tok": _dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                            device, scale=np.sqrt(cfg.d_model))}
    if not cfg.tied_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                device)
    return p


def embed(p, tokens):
    if is_dtensor(p["tok"]):
        return _vocab_local(_embed_rows, p["tok"], ("model", None), tokens,
                            ("dp", None, None))
    return p["tok"][tokens.long()]


def _embed_rows(tok, ids, tokens):
    """The rows of a block of the table (``ids``: the block's row numbers)
    for ``tokens``; zero where a token's row lies in another block."""
    idx = tokens.long() - ids[:1].long()
    hit = (idx >= 0) & (idx < tok.shape[0])
    rows = tok[idx.clamp(0, tok.shape[0] - 1)]
    return rows * hit[..., None].to(rows.dtype)


def _vocab_local(fn, x, x_names, idx, out_names):
    """``fn(x's block, the block's token numbers, idx)`` on each rank
    (``pshard.local``), where ``x`` is split over the vocabulary at the dim
    ``x_names`` names "model": each model rank answers for the tokens its
    block holds, zeros for the others, and the sum over the model ranks is
    pending. ``idx`` keeps its data-parallel split, and the result has it.
    Megatron's vocab-parallel embedding and CE pick: DTensor's own gather
    and its backward fail on a tensor split over the gathered dim in some
    releases."""
    ids = torch.arange(x.shape[x_names.index("model")], device=idx.device)
    return local(fn, out_names, (x_names, ("model",),
                                 ("dp",) + (None,) * (idx.ndim - 1)),
                 x, ids, idx, partial="model")


def unembed_logits(p, h):
    if "head" in p:
        return local(torch.matmul, ("dp", None, "model"),
                     (("dp", None, None), (None, "model")), h, p["head"])
    return local(_times_transpose, ("dp", None, "model"),
                 (("dp", None, None), ("model", None)), h, p["tok"])


def _times_transpose(h, w):
    return h @ w.T


def chunked_ce_loss(p_emb, h, labels, *, chunk: int = 512):
    """Mean cross-entropy without materializing (B, S, V) logits.

    h: (B, S, D); labels: (B, S) int (-1 = ignore). Loops over S chunks,
    each rematerialized in the backward pass; per-chunk logits are
    (B, chunk, V).
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    n = S // chunk
    h = shard(h, "dp", None, None)          # the sequence whole on a rank
    hs = reshape(h, B, n, chunk, D).unbind(1)
    ls = labels.reshape(B, n, chunk).long().unbind(1)

    def chunk_ce(hc, lc):
        logits = unembed_logits(p_emb, hc).float()
        logits = shard(logits, "dp", None, "model")
        if is_dtensor(logits):
            lse, picked = _vocab_parallel_lse_pick(logits, lc)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1,
                                  torch.clamp(lc, min=0)[..., None])[..., 0]
        mask = (lc >= 0).float()
        return ((lse - picked) * mask).sum(), mask.sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for hc, lc in zip(hs, ls):
        t, c = _remat(chunk_ce, hc, lc)
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)



def _vocab_parallel_lse_pick(logits, labels):
    """Log-sum-exp and label logit of vocab-sharded logits (a DTensor),
    Megatron's vocab-parallel cross-entropy: each model rank reduces its
    block of the vocabulary (its max, then its sum of exponentials) and
    picks the labels its block holds (``_pick_sharded``); one all-reduce
    of a (batch, chunk) tensor each completes them. No rank holds more
    than its block of the logits. Within rounding of ``logsumexp`` /
    ``gather``."""
    m = _vocab_reduce(_block_max, "max", logits)
    s = _vocab_reduce(_block_sumexp, "sum", logits, m)
    return torch.log(s) + m, _pick_sharded(logits, labels)


def _block_max(logits):
    return logits.detach().amax(-1)


def _block_sumexp(logits, m):
    return torch.exp(logits - m[..., None]).sum(-1)


def _vocab_reduce(fn, op: str, logits, *rest):
    """``fn(logits, *rest)``, a reduction over the vocabulary, each rank on
    its block (``pshard.local``), then completed across the vocabulary's
    ranks by an all-reduce of ``op``; ``rest`` are whole over the vocab
    (placed as the result)."""
    part = local(fn, ("dp", None), (("dp", None, "model"),) +
                 (("dp", None),) * len(rest), logits, *rest,
                 partial="model", reduce=op)
    return shard(part, "dp", None)


def _pick_rows(logits, ids, labels):
    """The logit of each label in a block of the vocabulary (``ids``: the
    block's token numbers); zero where the label lies in another block."""
    idx = torch.clamp(labels, min=0).long() - ids[:1].long()
    hit = (idx >= 0) & (idx < logits.shape[-1])
    picked = torch.gather(logits, -1,
                          idx.clamp(0, logits.shape[-1] - 1)[..., None])
    return picked[..., 0] * hit.to(logits.dtype)


def _pick_sharded(logits, labels):
    """``gather`` of the labels' logits from vocab-sharded logits, each
    model rank on its block (``_vocab_local``)."""
    return _vocab_local(_pick_rows, logits, ("dp", None, "model"), labels,
                        ("dp", None))
