"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (kv=8) ff=8192 V=202048,
MoE 128e top-1 + shared expert, MoE every other layer (400B total / ~17B
active). [hf:meta-llama/Llama-4 family]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202048,
        moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                      every_n_layers=2, shared_expert=True),
        rope_theta=5e5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=1, d_ff_expert=128,
                      every_n_layers=2, shared_expert=True, group_size=64),
        max_seq_len=256, dtype="float32", remat=False,
    )
