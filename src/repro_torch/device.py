"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a machine without
    CUDA: the port never drops silently to the CPU (pass ``device="cpu"``
    to run there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev
