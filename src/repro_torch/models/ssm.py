"""Mamba-2 style state-space layer using the SSD (state-space duality)
chunked algorithm [arXiv:2405.21060], with O(1)-state decode (the port's
``repro/models/ssm.py``).

Used by ``mamba2-130m`` (pure SSM) and the SSM layers of ``jamba-v0.1-52b``,
realized with SSD as in the JAX package (not Mamba-1's sequential selective
scan): intra-chunk work is matrix products, the inter-chunk recurrence a
short loop over sequence chunks, each chunk's body rematerialized in the
backward pass (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint``
whatever ``cfg.remat`` says). The causal conv is the sum of W shifted
inputs, JAX's summation order, not ``conv1d``. The chunk's cumulative
sums of ``dt * A`` are accumulated in float64 (``_cumsum64``; JAX: float32).
``A_log``, ``dt_bias`` and ``D_skip`` are float32 leaves whatever the
model's dtype.

Shapes: d_inner = expand * d_model; nh = d_inner / head_dim heads;
single B/C group (ngroups=1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import _dense_init
from .pshard import local, reshape, shard


def init_ssm(gen, cfg, dtype, device):
    s = cfg.ssm
    D = cfg.d_model
    din = s.expand * D
    nh = din // s.head_dim
    f32 = {"dtype": torch.float32, "device": device}
    return {
        # fused input projection: [x (din), z gate (din), B (N), C (N), dt (nh)]
        "w_in": _dense_init(gen, (D, 2 * din + 2 * s.d_state + nh), dtype,
                            device),
        "w_out": _dense_init(gen, (din, D), dtype, device),
        "conv_w": _dense_init(gen, (s.conv_width, din + 2 * s.d_state),
                              dtype, device, scale=np.sqrt(s.conv_width)),
        "conv_b": torch.zeros((din + 2 * s.d_state,), dtype=dtype,
                              device=device),
        "A_log": torch.log(torch.linspace(1.0, float(nh), nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "D_skip": torch.ones((nh,), **f32),
        "norm_scale": torch.ones((din,), dtype=dtype, device=device),
    }


def _split_proj(p, xproj, cfg):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_dim
    # jnp.split takes split points, torch.split sizes
    xz, Bc, Cc, dt = torch.split(xproj, [2 * din, s.d_state, s.d_state, nh],
                                 dim=-1)
    x, z = xz.chunk(2, dim=-1)
    return x, z, Bc, Cc, dt, din, nh


def _causal_conv(x, w, b):
    """Depthwise causal conv1d; x: (B, L, C), w: (W, C)."""
    W = w.shape[0]
    xpad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xpad[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _segsum(dtA):
    """Stable segment-sum: out[..., i, j] = sum_{j < s <= i} dtA[..., s].

    dtA: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums, -inf
    above the diagonal (so ``exp`` gives 0 there and a finite gradient).
    The cumulative sums and their differences are taken in float64 (see
    ``_cumsum64``).
    """
    Q = dtA.shape[-1]
    x = _cumsum64(dtA, -1)
    out = (x[..., :, None] - x[..., None, :]).to(dtA.dtype)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dtA.device))
    return torch.where(mask, out, -torch.inf)


def _cumsum64(x, dim: int):
    """``cumsum`` accumulated in float64. The chunk's decays are
    exponentials of differences of these sums, which reach tens in
    magnitude over a chunk: summed in float32, a difference keeps about
    1e-5 of relative accuracy, lost one way by torch's sequential CPU scan
    and another by its parallel CUDA scan. In float64 both devices give the
    decays to float32 rounding (and the port lands closer to the JAX
    package's float32 scan than a float32 sum on the CPU does)."""
    return torch.cumsum(x.double(), dim=dim)


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, W-1, din + 2N) rolling conv inputs
    ssm: torch.Tensor    # (B, nh, hd, N) recurrent state


def _chunk_step(state, xc, Bq, Cq, dtc, dtAc):
    """One SSD chunk: (B, Q, ...) inputs and the carried state (B, nh, hd,
    N) -> (new state, chunk output (B, Q, nh, hd))."""
    cum = _cumsum64(dtAc, 1)                               # (B, Q, nh)
    Lmat = torch.exp(_segsum(dtAc.transpose(1, 2)))        # (B, nh, Q, Q)
    scores = torch.einsum("bqn,bkn->bqk", Cq, Bq)          # (B, Q, Q)
    M = scores[:, None] * Lmat                             # (B, nh, Q, Q)
    M = M * dtc.transpose(1, 2)[:, :, None, :]             # weight by dt_k
    y_diag = torch.einsum("bhqk,bkhd->bqhd", M, xc)
    decay_in = torch.exp(cum.float())                      # (B, Q, nh)
    y_off = torch.einsum("bqn,bhdn->bqhd", Cq, state) * decay_in[..., None]
    decay_to_end = torch.exp((cum[:, -1:, :] - cum).float())   # (B, Q, nh)
    snew = torch.einsum("bqhd,bqn->bhdn",
                        xc * (decay_to_end * dtc)[..., None], Bq)
    state = state * torch.exp(cum[:, -1].float())[..., None, None] + snew
    state = shard(state, "dp", "model", None, None)
    return state, y_diag + y_off


# the symbolic names of _chunk_step's arguments and outputs: independent
# across batch and heads
_STATE = ("dp", "model", None, None)
_HEADS4 = ("dp", None, "model", None)
_HEADS3 = ("dp", None, "model")
_HEADS2 = ("dp", "model", None)
_CHUNK_IN = (_STATE, _HEADS4, ("dp", None, None), ("dp", None, None),
             _HEADS3, _HEADS3)


def ssd_forward(p, x_in, cfg):
    """Full-sequence SSD; x_in: (B, L, D) -> (B, L, D).

    Chunked: intra-chunk quasi-attention (matrix products) + inter-chunk
    state recurrence (a loop over L/chunk steps).
    """
    s = cfg.ssm
    B, L, D = x_in.shape
    Q = min(s.chunk, L)
    assert L % Q == 0, "sequence must be a multiple of the SSD chunk"
    nc = L // Q

    # whole on a rank before it is split into its parts (DTensor refuses,
    # in some releases, to split a dim sharded over the model axis)
    xproj = shard(x_in @ p["w_in"], "dp", None, None)
    x, z, Bc, Cc, dt, din, nh = _split_proj(p, xproj, cfg)
    hd, N = s.head_dim, s.d_state

    conv_in = torch.cat([x, Bc, Cc], dim=-1)
    conv_out = F.silu(local(_causal_conv, ("dp", None, None),
                            (("dp", None, None), (None, None), (None,)),
                            conv_in, p["conv_w"], p["conv_b"]))
    x, Bc, Cc = torch.split(conv_out, [din, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B, L, nh)
    A = -torch.exp(p["A_log"])                                     # (nh,)
    dtA = dt * A                                                   # (B, L, nh)

    xh = reshape(x, B, nc, Q, nh, hd).float()
    Br = reshape(Bc, B, nc, Q, N).float()
    Cr = reshape(Cc, B, nc, Q, N).float()
    dtr = reshape(dt, B, nc, Q, nh)
    dtAr = reshape(dtA, B, nc, Q, nh)

    xh = shard(xh, "dp", None, None, "model", None)
    dtr = shard(dtr, "dp", None, None, "model")
    dtAr = shard(dtAr, "dp", None, None, "model")

    # One chunk's decay matrix (B, nh, Q, Q) at a time; each chunk body is
    # recomputed in the backward pass instead of keeping all nc of them.
    def chunk(*args):
        return local(_chunk_step, (_STATE, _HEADS4), _CHUNK_IN, *args)

    step = chunk
    if torch.is_grad_enabled():
        def step(*args):
            return checkpoint(chunk, *args, use_reentrant=False)
    state = torch.zeros((B, nh, hd, N), dtype=torch.float32,
                        device=x_in.device)
    ys = []
    for c in range(nc):
        state, yc = step(state, xh[:, c], Br[:, c], Cr[:, c], dtr[:, c],
                         dtAr[:, c])
        ys.append(yc)
    y = reshape(torch.stack(ys, dim=1), B, L, nh, hd)
    y = y + reshape(xh, B, L, nh, hd) * p["D_skip"][None, None, :, None]
    y = reshape(y, B, L, din).to(x_in.dtype)
    # gated RMS norm (mamba2's norm-before-out)
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
         ).to(x_in.dtype) * p["norm_scale"]
    return y @ p["w_out"]


def ssm_init_state(cfg, batch: int, dtype, device=None) -> SSMState:
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_dim
    return SSMState(
        conv=torch.zeros((batch, s.conv_width - 1, din + 2 * s.d_state),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, nh, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device),
    )


def _recur(xh, dt, dtA, Bc, Cc, ssm, D_skip):
    """One step of the SSD recurrence: xh (B, nh, hd), dt and dt * A
    (B, nh), Bc / Cc (B, N), the state (B, nh, hd, N) -> (y (B, nh, hd),
    the new state)."""
    dec = torch.exp(dtA)                                          # (B, nh)
    ssm = ssm * dec[..., None, None] + torch.einsum(
        "bhd,bn->bhdn", xh * dt[..., None], Bc.float())
    y = torch.einsum("bn,bhdn->bhd", Cc.float(), ssm)
    return y + xh * D_skip[None, :, None], ssm


def ssd_decode_step(p, x_in, cfg, state: SSMState):
    """One-token recurrent step; x_in: (B, 1, D) -> (out, new_state)."""
    s = cfg.ssm
    B = x_in.shape[0]
    xproj = shard(x_in[:, 0] @ p["w_in"], "dp", None)
    x, z, Bc, Cc, dt, din, nh = _split_proj(p, xproj, cfg)
    hd, N = s.head_dim, s.d_state

    conv_in = torch.cat([x, Bc, Cc], dim=-1)                      # (B, C)
    hist = torch.cat([state.conv, conv_in[:, None]], dim=1)       # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    x, Bc, Cc = torch.split(conv_out, [din, N, N], dim=-1)
    new_conv = hist[:, 1:]

    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B, nh)
    A = -torch.exp(p["A_log"])
    xh = reshape(x, B, nh, hd).float()
    y, ssm = local(_recur, (_HEADS2, _STATE), (
        _HEADS2, ("dp", "model"), ("dp", "model"), ("dp", None),
        ("dp", None), _STATE, ("model",)), xh, dt, dt * A, Bc, Cc,
        state.ssm, p["D_skip"])
    y = reshape(y, B, din).to(x_in.dtype)
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
         ).to(x_in.dtype) * p["norm_scale"]
    out = (y @ p["w_out"])[:, None]
    return out, SSMState(conv=new_conv, ssm=ssm)
