"""Argument checks and the ctypes call shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import build

# the kernels' ``dtype`` argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(tensors: Dict[str, torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when all lie on one CUDA device (the kernel runs).  Anything else
    raises: a CUDA tensor never reaches the plain version."""
    devices = {t.device for t in tensors.values()}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"inputs must all lie on the CPU or on one CUDA device, "
                     f"got {({k: str(t.device) for k, t in tensors.items()})}")


def check_cuda_inputs(kernel: str, floats: Dict[str, torch.Tensor],
                      ints: Dict[str, torch.Tensor],
                      int8s: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """Raise unless every float input shares one supported dtype, every
    index input is int32, every quantized input (``int8s``) is int8 and
    all are contiguous.  Returns the dtype code."""
    int8s = int8s or {}
    dtypes = {t.dtype for t in floats.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPE_CODES:
        raise TypeError(f"{kernel}: float inputs must share one dtype of "
                        f"{list(DTYPE_CODES)}, got "
                        f"{({k: t.dtype for k, t in floats.items()})}")
    for want, group in ((torch.int32, ints), (torch.int8, int8s)):
        for k, t in group.items():
            if t.dtype != want:
                raise TypeError(f"{kernel}: {k} must be {want}, got "
                                f"{t.dtype}")
    for k, t in {**floats, **ints, **int8s}.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {k} must be contiguous")
    return DTYPE_CODES[next(iter(dtypes))]


def launch(library: str, name: str, device: torch.device,
           pointers: Sequence[Optional[torch.Tensor]],
           ints: Sequence[int]) -> None:
    """Launch the C function ``name(pointers..., ints..., stream)`` of
    library ``library`` (``csrc/<library>.cu``) on the current stream of
    ``device`` (a ``None`` pointer passes NULL); raise if the launch was
    refused (its cudaGetLastError, returned, is not 0)."""
    lib = build.load(library)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * len(pointers)
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*[None if t is None else t.data_ptr() for t in pointers],
                *ints, stream)
    if rc != 0:
        err = getattr(lib, f"{library}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed: cuda error {rc} "
                           f"({err(rc).decode()})")
