"""dbrx-132b — MoE, 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=16, experts_per_token=4, d_ff_expert=10752),
    source="hf:databricks/dbrx-base",
)
