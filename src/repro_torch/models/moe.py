"""Mixture-of-Experts with GShard-style grouped one-hot dispatch (the port's
``repro/models/moe.py``).

The dispatch and combine tensors are ``(groups, group_size, experts,
capacity)``, as in the JAX package; capacity drops tokens slot-major (all
tokens' first choices claim buffer positions before any second choice),
and the Switch auxiliary load-balance loss comes out beside the output.
Where a torch op's contract differs from JAX's, the port keeps JAX's:

* the top-k is a stable descending sort, so tied router probabilities put
  the lower expert first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order among ties);
* a dropped slot (position >= capacity) has an all-zero one-hot row, as
  ``jax.nn.one_hot`` gives for an out-of-range index: the position is
  masked before ``one_hot``, which would raise on it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import _dense_init
from .pshard import local, reshape, shard, splits


def init_moe(gen, cfg, dtype, device):
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    p = {"router": _dense_init(gen, (D, E), dtype, device)}
    if cfg.act == "swiglu":
        p["wg"] = _dense_init(gen, (E, D, Fe), dtype, device)
        p["wu"] = _dense_init(gen, (E, D, Fe), dtype, device)
        p["wd"] = _dense_init(gen, (E, Fe, D), dtype, device)
    else:
        p["wi"] = _dense_init(gen, (E, D, Fe), dtype, device)
        p["wo"] = _dense_init(gen, (E, Fe, D), dtype, device)
    if m.shared_expert:
        p["shared"] = {
            "wg": _dense_init(gen, (D, Fe), dtype, device),
            "wu": _dense_init(gen, (D, Fe), dtype, device),
            "wd": _dense_init(gen, (Fe, D), dtype, device),
        }
    return p


def _capacity(group_size: int, top_k: int, num_experts: int, cf: float) -> int:
    c = int(np.ceil(group_size * top_k * cf / num_experts))
    return max(4, c)


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, xg, cfg):
    """Router of groups ``xg`` (G, gs, D): (probs (G, gs, E), gate values
    and expert indices (G, gs, K), each slot's position in its expert's
    buffer (G, gs, K), capacity C)."""
    m = cfg.moe
    G, gs, _ = xg.shape
    E, K = m.num_experts, m.top_k
    C = _capacity(gs, K, E, m.capacity_factor)
    logits = (xg @ p["router"]).float()                    # (G, gs, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, K)                 # (G, gs, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    # Position of each (token, slot) in its expert's capacity buffer:
    # flatten slots in (slot-major, token) order so top-1 picks win
    # positions. torch.cumsum of int32 gives int64; both are exact.
    sel = F.one_hot(gate_idx, E).to(torch.int32)           # (G, gs, K, E)
    sel_flat = reshape(sel.permute(0, 2, 1, 3), G, K * gs, E)
    pos_flat = torch.cumsum(sel_flat, dim=1) - sel_flat    # (G, K*gs, E)
    pos = reshape(pos_flat, G, K, gs, E).permute(0, 2, 1, 3)
    pos = (pos * sel).sum(-1)                              # (G, gs, K)
    return probs, gate_vals, gate_idx, sel, pos, C


def _dispatch(dispatch, xg):
    return torch.einsum("gtec,gtd->gecd", dispatch, xg)


def _combine(combine, ye):
    return torch.einsum("gtec,gecd->gtd", combine, ye)


def _experts(xe, *ws):
    """The experts' MLPs on their capacity buffers: (G, E, C, D) ->
    (G, E, C, D); ``ws`` is (wg, wu, wd) for SwiGLU, (wi, wo) for GELU."""
    if len(ws) == 3:
        wg, wu, wd = ws
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, wg))
        h = h * torch.einsum("gecd,edf->gecf", xe, wu)
        h = shard(h, "dp", "model", None, None)
        return torch.einsum("gecf,efd->gecd", h, wd)
    wi, wo = ws
    h = F.gelu(torch.einsum("gecd,edf->gecf", xe, wi), approximate="tanh")
    h = shard(h, "dp", "model", None, None)
    return torch.einsum("gecf,efd->gecd", h, wo)



def apply_moe(p, x, cfg):
    """x: (B, S, D) -> (y, aux_loss)."""
    m = cfg.moe
    B, S, D = x.shape
    E = m.num_experts
    tokens = B * S
    gs = min(m.group_size, tokens)
    assert tokens % gs == 0, "token count must divide into dispatch groups"
    G = tokens // gs

    xg = shard(reshape(x, G, gs, D), "dp", None, None)
    probs, gate_vals, gate_idx, sel, pos, C = _route(p, xg, cfg)

    # Load-balance auxiliary loss (Switch): E * sum_e f_e * P_e.
    me = probs.mean(dim=1)                                 # (G, E)
    ce = F.one_hot(gate_idx[..., 0], E).float().mean(dim=1)
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))

    keep = pos < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    # jax.nn.one_hot(pos, C) is a zero row for a dropped slot: mask it
    pos_oh = F.one_hot(torch.where(keep, pos, 0), C).to(x.dtype) * \
        keep[..., None].to(x.dtype)                        # (G, gs, K, C)
    # combine[g, t, e, c] = sum_k gate * onehot(e) * onehot(c); sel * gate
    # first keeps the largest intermediate at (G, gs, E, C)
    sel_gate = sel.to(x.dtype) * gate_vals.to(x.dtype)[..., None]
    combine = torch.einsum("gtke,gtkc->gtec", sel_gate, pos_oh)
    combine = shard(combine, "dp", None, "model", None)
    dispatch = shard((combine > 0).to(x.dtype), "dp", None, "model", None)

    xe = local(_dispatch, ("dp", "model", None, None),
               (("dp", None, "model", None), ("dp", None, None)),
               dispatch, xg)                               # (G, E, C, D)
    xe = shard(xe, "dp", "model", None, None)
    names = ("wg", "wu", "wd") if "wg" in p else ("wi", "wo")
    ws = [p[n] for n in names]
    # sharded: each rank runs its experts on their buffers where the model
    # axis divides E (expert parallelism, as param_spec splits E), else its
    # slice of every expert's hidden units (TP inside the experts: the
    # down projection a pending sum). (DTensor's own einsums fail in the
    # backward pass: they reshape blocks whose strides differ from the
    # whole tensor's.)
    if splits(E, "model"):
        x_n, w_n, part = ("dp", "model", None, None), \
            [("model", None, None)] * len(ws), None
    else:
        x_n, part = ("dp", None, None, None), "model"
        w_n = [(None, None, "model")] * (len(ws) - 1) + \
            [(None, "model", None)]
    ye = local(_experts, x_n, (x_n, *w_n), xe, *ws, partial=part)
    ye = shard(ye, "dp", "model", None, None)
    # each rank sums its experts' outputs, the sum over the model ranks
    # pending (DTensor folds the (expert, slot) contraction into one dim,
    # which some releases refuse for a split dim)
    y = local(_combine, ("dp", None, None), (
        ("dp", None, "model", None), ("dp", "model", None, None)),
        combine, ye, partial="model")

    if m.shared_expert:
        sh = p["shared"]
        y = y + (F.silu(xg @ sh["wg"]) * (xg @ sh["wu"])) @ sh["wd"]
    return reshape(y, B, S, D), aux
