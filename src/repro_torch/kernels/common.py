"""Argument checks and the ctypes call shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

# the kernels' ``dtype`` argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The tensor-core attention kernels (csrc/mma_attention.cuh): four warps of
# 16 query rows, 64-key tiles in a shared ring of stages per dtype,
# head_dim padded to one of the widths instantiated there.
MMA_THREADS = 128
MMA_ROWS = 64
MMA_TILE_KEYS = 64
MMA_STAGES = {torch.float32: 2, torch.bfloat16: 3}
MMA_D_PADS = (16, 32, 64, 80, 96, 128)


@dataclass(frozen=True)
class AttentionPlan:
    """Launch plan of a tensor-core attention kernel (flash, float paged
    prefill): one CTA per (query tile, KV head, sequence), its rows the GQA
    group's heads times ``tile_q`` positions.  The C entry points take
    ``tile_q``, ``d_pad`` and ``smem_bytes`` and refuse a plan they do not
    instantiate or whose bytes differ from their ring's."""
    group: int                  # query heads per KV head
    tile_q: int                 # positions per CTA
    rows: int                   # group * tile_q <= MMA_ROWS query rows
    d_pad: int                  # head_dim padded to an instantiated width
    grid: Tuple[int, int, int]  # (query tiles, KV heads, sequences)
    smem_bytes: int             # the K/V ring (+ q's TF32 parts in f32)


def attention_plan(B: int, H: int, KVH: int, L: int, D: int,
                   dtype: torch.dtype) -> AttentionPlan:
    """The plan for ``L`` query positions of ``H`` heads on ``KVH`` KV
    heads, head_dim ``D``, in ``dtype``.  The ring holds stages x (K, V) x
    64 key rows of ``d_pad`` elements plus 16 bytes (bank-conflict
    padding); in f32 each thread's q fragments follow, as TF32 high parts
    and residuals."""
    if not (B >= 1 and KVH >= 1 and H % KVH == 0 and H // KVH <= MMA_ROWS
            and L >= 1 and 1 <= D <= MMA_D_PADS[-1]):
        raise ValueError(f"no attention plan for B={B} H={H} KVH={KVH} "
                         f"L={L} D={D}")
    group = H // KVH
    tile_q = min(L, MMA_ROWS // group)
    d_pad = next(p for p in MMA_D_PADS if p >= D)
    esize = torch.empty((), dtype=dtype).element_size()
    smem = MMA_STAGES[dtype] * 2 * MMA_TILE_KEYS * (d_pad * esize + 16)
    if dtype == torch.float32:      # each thread's q, split for 3xTF32
        smem += 2 * MMA_THREADS * (d_pad // 2) * 4
    return AttentionPlan(group, tile_q, group * tile_q, d_pad,
                         (-(-L // tile_q), KVH, B), smem)


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
