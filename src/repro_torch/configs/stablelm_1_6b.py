"""stablelm-1.6b [dense]: 24L d=2048 32H (kv=32) ff=5632 V=100352.
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=5632, vocab_size=100352,
        norm="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, norm="layernorm",
        max_seq_len=256, dtype="float32", remat=False,
    )
