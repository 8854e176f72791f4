"""Architecture registry (the port's copy of ``repro/configs``): the 10
assigned configs + reduced smoke variants.

``get_config(arch)`` returns the full published config; ``get_config(arch,
smoke=True)`` returns a structurally-identical reduced config for CPU tests.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig, MoEConfig, SSMConfig, SHAPES  # noqa: F401

ARCHS = [
    "jamba_v0_1_52b",
    "whisper_large_v3",
    "qwen1_5_0_5b",
    "mistral_nemo_12b",
    "stablelm_1_6b",
    "phi3_mini_3_8b",
    "llama4_maverick_400b_a17b",
    "granite_moe_3b_a800m",
    "mamba2_130m",
    "llama_3_2_vision_90b",
]

# canonical ids as assigned (dash/dot form) -> module name
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "stablelm-1.6b": "stablelm_1_6b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mamba2-130m": "mamba2_130m",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
})
ALIASES.update({a: a for a in ARCHS})


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch)
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(set(ALIASES))}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()


def supported_shapes(cfg: ModelConfig) -> list[str]:
    """Shapes runnable for this arch (long_500k: sub-quadratic archs only,
    per the assignment; skips documented in DESIGN.md section 5)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        shapes.append("long_500k")
    return shapes
