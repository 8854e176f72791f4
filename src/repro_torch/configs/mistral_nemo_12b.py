"""mistral-nemo-12b [dense]: 40L d=5120 32H (kv=8) ff=14336 V=131072,
head_dim=128, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131072,
        rope_theta=1e6, max_seq_len=131072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemo-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        max_seq_len=256, dtype="float32", remat=False,
    )
