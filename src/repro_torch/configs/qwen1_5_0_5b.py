"""qwen1.5-0.5b [dense]: 24L d=1024 16H (kv=16) ff=2816 V=151936, QKV bias.
[hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=2816, vocab_size=151936,
        qkv_bias=True, tied_embeddings=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        qkv_bias=True, tied_embeddings=True,
        max_seq_len=256, dtype="float32", remat=False,
    )
