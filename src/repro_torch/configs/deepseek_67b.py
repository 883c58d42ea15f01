"""deepseek-67b — dense llama-arch, GQA kv=8. [arXiv:2401.02954]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    source="arXiv:2401.02954",
)
