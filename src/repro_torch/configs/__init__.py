from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHITECTURES, get_arch

__all__ = ["ModelConfig", "ARCHITECTURES", "get_arch"]
