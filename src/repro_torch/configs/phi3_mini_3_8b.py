"""phi3-mini-3.8b [dense]: 32L d=3072 32H (kv=32) ff=8192 V=32064,
RoPE SwiGLU GQA. [arXiv:2404.14219]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32064,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        max_seq_len=256, dtype="float32", remat=False,
    )
