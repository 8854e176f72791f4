"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (kv=8) ff=14336 V=65536,
MoE 16e top-2 every other layer, Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        attn_every_n=8,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                      every_n_layers=2),
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4),
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        attn_every_n=8,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      every_n_layers=2, group_size=64),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4,
                      chunk=16),
        max_seq_len=256, dtype="float32", remat=False,
    )
