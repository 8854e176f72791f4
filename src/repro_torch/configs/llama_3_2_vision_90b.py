"""llama-3.2-vision-90b [vlm]: 100L (80 self + 20 cross-attn image layers)
d=8192 64H (kv=8) ff=28672 V=128256; vision frontend stubbed (precomputed
patch embeddings). [hf:meta-llama/Llama-3.2-vision family]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256,
        cross_attn_every_n=5, frontend_tokens=1600,
        rope_theta=5e5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", family="vlm",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        cross_attn_every_n=5, frontend_tokens=16,
        max_seq_len=256, dtype="float32", remat=False,
    )
