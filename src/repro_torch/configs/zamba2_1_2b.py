"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

38 mamba2 blocks with a shared (weight-tied) GQA attention block interleaved
every ``hybrid_attn_every`` layers.  In long-context (500k) mode the shared
attention runs sliding-window (hardware adaptation, see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk_size=64),
    hybrid_attn_every=6,
    source="arXiv:2411.15242",
)
