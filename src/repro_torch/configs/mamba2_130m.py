"""mamba2-130m [ssm]: 24L d=768 attn-free, ssm_state=128, SSD.
[arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=256,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4,
                      chunk=16),
        max_seq_len=256, dtype="float32", remat=False,
    )
