"""qwen3-moe-30b-a3b — MoE, 128 experts top-8, GQA kv=4. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,  # qwen3 uses fixed 128-dim heads with q/k norm
    d_ff=768,      # per-expert FFN width (fine-grained experts)
    vocab_size=151936,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B",
)
