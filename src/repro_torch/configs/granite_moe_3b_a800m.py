"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (kv=8) V=49155,
MoE 40e top-8 with per-expert ff=512. [hf:ibm-granite/granite-3.0 family]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        d_ff=512, vocab_size=49155,
        moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512,
                      every_n_layers=1, group_size=256),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        moe=MoEConfig(num_experts=5, top_k=3, d_ff_expert=64,
                      every_n_layers=1, group_size=64),
        max_seq_len=256, dtype="float32", remat=False,
    )
