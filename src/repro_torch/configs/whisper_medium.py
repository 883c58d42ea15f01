"""whisper-medium — encoder-decoder, conv frontend stubbed. [arXiv:2212.04356]

input_specs() provides precomputed frame embeddings (batch, 1500, d_model)
for the encoder; num_layers refers to the DECODER stack (24); the encoder has
its own 24 layers per EncoderConfig.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=24, num_frames=1500),
    source="arXiv:2212.04356",
)
