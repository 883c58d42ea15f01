"""llava-next-34b — VLM language backbone (anyres tiling vision stub).
[hf:llava-hf/llava-v1.6-mistral-7b-hf (arch pattern), 34B backbone]

The ViT/projector frontend is a STUB per assignment: input_specs() provides
precomputed patch embeddings (batch, num_patch_tokens, d_model) that the
backbone consumes as a prompt prefix.
"""
from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    vision=VisionConfig(num_patch_tokens=2880),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
