"""Model configuration for the assigned architecture pool (the port's copy
of ``repro/models/config.py``; ``tdtype`` is the model's ``torch.dtype``).

One frozen dataclass drives every family: dense / MoE / SSM / hybrid /
enc-dec (audio) / VLM (cross-attention). Layer structure is expressed as a
repeating *pattern* of (mixer, mlp) kinds so the parameter stack can be
scanned (compile-time-compact HLO) while still expressing Jamba-style
interleaves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_n_layers: int = 1       # MoE replaces the MLP every n layers
    shared_expert: bool = False   # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    group_size: int = 512         # dispatch group (tokens); see models/moe.py


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 128              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "swiglu"           # swiglu | gelu
    qkv_bias: bool = False
    tied_embeddings: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every_n: int = 1         # hybrid: 1 attention layer per n (rest SSM)
    encoder_layers: int = 0       # enc-dec (whisper): encoder depth
    cross_attn_every_n: int = 0   # vlm: 1 cross-attn layer per n
    frontend_tokens: int = 0      # stubbed modality tokens (audio frames /
                                  # image patches), fed as embeddings
    max_seq_len: int = 131072
    kv_cache_dtype: str = ""   # "" => model dtype; "int8" => quantized cache
    dtype: str = "bfloat16"
    remat: bool = True            # activation checkpoint each block
    remat_policy: str = "full"    # "full" | "dots" (save matmul outputs)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    # -- layer pattern ---------------------------------------------------------

    def layer_pattern(self) -> Tuple[Tuple[str, str], ...]:
        """Repeating (mixer, mlp) pattern; len divides num_layers.

        mixer in {"attn", "ssm", "cross"}; mlp in {"dense", "moe"}.
        """
        n = self.num_layers
        plen = 1
        if self.attn_every_n > 1:
            plen = _lcm(plen, self.attn_every_n)
        if self.cross_attn_every_n > 0:
            plen = _lcm(plen, self.cross_attn_every_n)
        if self.moe is not None and self.moe.every_n_layers > 1:
            plen = _lcm(plen, self.moe.every_n_layers)
        while n % plen:
            plen += 1  # fall back to a pattern covering the full stack
            if plen >= n:
                plen = n
                break
        pat = []
        for i in range(plen):
            if self.attn_every_n > 1:
                # Jamba places its attention layer mid-block (index n//2).
                mixer = "attn" if i % self.attn_every_n == self.attn_every_n // 2 \
                    else "ssm"
            elif self.family == "ssm":
                mixer = "ssm"
            elif self.cross_attn_every_n > 0 and \
                    i % self.cross_attn_every_n == self.cross_attn_every_n - 1:
                mixer = "cross"
            else:
                mixer = "attn"
            if self.moe is not None and i % self.moe.every_n_layers == \
                    self.moe.every_n_layers - 1:
                mlp = "moe"
            else:
                mlp = "dense"
            pat.append((mixer, mlp))
        return tuple(pat)

    @property
    def num_pattern_repeats(self) -> int:
        return self.num_layers // len(self.layer_pattern())

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.hd, self.num_heads, self.num_kv_heads
        norm = D * (2 if self.norm == "layernorm" else 1)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        nmats = 3 if self.act == "swiglu" else 2
        dense_mlp = nmats * D * F
        ssm_p = 0
        if self.ssm is not None:
            din = self.ssm.expand * D
            nh = din // self.ssm.head_dim
            ssm_p = (D * (2 * din + 2 * self.ssm.d_state + nh)
                     + din * D
                     + self.ssm.conv_width * (din + 2 * self.ssm.d_state)
                     + (din + 2 * self.ssm.d_state)        # conv bias
                     + 3 * nh + din)                       # A, dt_b, Dskip, norm
        moe_mlp = 0
        if self.moe is not None:
            e = self.moe.num_experts
            fe = self.moe.d_ff_expert
            moe_mlp = e * nmats * D * fe + D * e
            if self.moe.shared_expert:
                moe_mlp += nmats * D * fe
        total = 0
        for mixer, mlp in self.layer_pattern():
            total += attn if mixer in ("attn", "cross") else ssm_p
            total += norm
            if mlp == "moe":
                total += moe_mlp + norm
            elif F > 0:
                total += dense_mlp + norm
            if self.family == "audio":   # decoder cross-attention sublayer
                total += attn + norm
        total *= self.num_pattern_repeats
        total += V * D * (1 if self.tied_embeddings else 2)
        total += self.encoder_layers * (attn + dense_mlp + 2 * norm)
        total += norm * (2 if self.encoder_layers else 1)  # final norm(s)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e = self.moe.num_experts
        fe = self.moe.d_ff_expert
        nmoe = sum(1 for _, m in self.layer_pattern() if m == "moe") \
            * self.num_pattern_repeats
        per_expert = (3 if self.act == "swiglu" else 2) * self.d_model * fe
        inactive = nmoe * (e - self.moe.top_k) * per_expert
        return full - inactive


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (arch x shape) cell of the assignment."""
    name: str              # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
