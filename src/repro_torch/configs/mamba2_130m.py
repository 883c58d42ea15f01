"""mamba2-130m — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,        # attention-free
    num_kv_heads=0,
    d_ff=0,             # mamba blocks subsume the MLP
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk_size=64),
    source="arXiv:2405.21060",
)
