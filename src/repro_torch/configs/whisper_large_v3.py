"""whisper-large-v3 [audio]: enc-dec, 32L(+32L enc) d=1280 20H (kv=20)
ff=5120 V=51866; conv frontend stubbed (precomputed frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        norm="layernorm", act="gelu",
        encoder_layers=32, frontend_tokens=1500,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        norm="layernorm", act="gelu",
        encoder_layers=2, frontend_tokens=32,
        max_seq_len=256, dtype="float32", remat=False,
    )
