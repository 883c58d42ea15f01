"""Argument checks and the ctypes call shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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

# The split-KV decode kernels (csrc/decode_mma.cuh) on the same core: one
# CTA per (split, KV head, sequence).  The split count fills at most
# SPLIT_CTAS_PER_SM CTAs on each of the H100's 132 SMs, fewer where shared
# memory holds fewer, so every CTA starts in the first wave; and no split
# takes fewer than SPLIT_MIN_KEYS keys, so a cache of at most that many
# keys a sequence runs one split and no merge.
H100_SMS = 132
SMEM_PER_SM = 232448        # bytes a CTA may use; each CTA also costs 1024
SPLIT_CTAS_PER_SM = 3
SPLIT_MIN_KEYS = 256
SPLIT_MAX = 64


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ring_bytes(d_pad: int, dtype: torch.dtype) -> int:
    """Shared bytes of a tensor-core kernel: its K/V ring and, in f32, each
    thread's q split for 3xTF32."""
    esize = torch.empty((), dtype=dtype).element_size()
    smem = MMA_STAGES[dtype] * 2 * MMA_TILE_KEYS * (d_pad * esize + 16)
    if dtype == torch.float32:
        smem += 2 * MMA_THREADS * (d_pad // 2) * 4
    return smem


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
    return AttentionPlan(group, tile_q, group * tile_q, d_pad,
                         (-(-L // tile_q), KVH, B), _ring_bytes(d_pad, dtype))


@dataclass(frozen=True)
class DecodePlan:
    """Launch plan of a split-KV decode kernel (float paged and dense
    decode): ``splits`` CTAs per (sequence, KV head), each over its share
    of the sequence's keys (``split_range``), their rows the GQA group
    padded to 16-row tiles (at ``group <= 16`` the four warps share one
    row tile and take interleaved 16-key slices of each 64-key tile; the
    kernel chooses that from the group itself).  With more than one split, the CTAs write f32 partials (O, m, l) to a workspace
    of ``workspace_floats`` and the last to arrive of each (sequence, KV
    head) merges them, counted on ``split_tickets``."""
    group: int                  # query heads per KV head
    d_pad: int                  # head_dim padded to an instantiated width
    splits: int                 # CTAs per (sequence, KV head)
    grid: Tuple[int, int, int]  # (splits, KV heads, sequences)
    smem_bytes: int             # the K/V ring (+ q's TF32 parts in f32)
    workspace_floats: int       # 0 when splits == 1


def decode_plan(B: int, H: int, KVH: int, cap: int, D: int,
                dtype: torch.dtype) -> DecodePlan:
    """The plan for one query token of ``H`` heads on ``KVH`` KV heads per
    sequence, over at most ``cap`` keys a sequence (``nb * bs`` pages or
    ``S`` rows).  It reads shapes only, never the lengths: the split count
    of a call is known on the host before the call and the same for every
    replay of a captured graph."""
    if not (B >= 1 and KVH >= 1 and H % KVH == 0 and H // KVH <= MMA_ROWS
            and cap >= 1 and 1 <= D <= MMA_D_PADS[-1]):
        raise ValueError(f"no decode plan for B={B} H={H} KVH={KVH} "
                         f"cap={cap} D={D}")
    group = H // KVH
    d_pad = next(p for p in MMA_D_PADS if p >= D)
    smem = _ring_bytes(d_pad, dtype)
    per_sm = min(SPLIT_CTAS_PER_SM, SMEM_PER_SM // (smem + 1024))
    splits = max(1, min(H100_SMS * per_sm // (B * KVH),
                        _cdiv(cap, SPLIT_MIN_KEYS), SPLIT_MAX))
    workspace = B * KVH * splits * group * (D + 2) if splits > 1 else 0
    return DecodePlan(group, d_pad, splits, (splits, KVH, B), smem,
                      workspace)


# per device: every ticket buffer handed out, the newest last (a captured
# CUDA graph may hold any of them, so none is freed)
_tickets: Dict[torch.device, List[torch.Tensor]] = {}


def split_tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters of the split-KV decode kernels
    on ``device``, one per (sequence, KV head).  They are zeroed once, and
    the CTA that merges a (sequence, KV head) resets its counter, so they
    read 0 at the start of every call and every graph replay.  The first
    buffer (and any larger one) is allocated outside graph capture only.
    The port issues its kernels on one stream per device: calls that
    overlapped in time on two streams would share counters."""
    held = _tickets.setdefault(device, [])
    if not held or held[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"split-KV decode: {n} arrival counters are needed on "
                f"{device}; call the kernel once outside CUDA-graph capture "
                f"first")
        held.append(torch.zeros(max(n, 1 << 16), dtype=torch.int32,
                                device=device))
    return held[-1]


def split_range(length: int, cap: int, splits: int,
                split: int) -> Tuple[int, int]:
    """Keys [lo, hi) of split ``split`` for a sequence of ``length`` keys
    (clamped to [0, cap]), as the kernels compute it on the device: the
    sequence uses ceil(n / SPLIT_MIN_KEYS) splits, at most ``splits`` and
    at least 1, each taking the same share rounded up to whole 64-key
    tiles; the splits past the last key get an empty range."""
    n = min(max(length, 0), cap)
    used = max(1, min(splits, _cdiv(n, SPLIT_MIN_KEYS)))
    share = max(MMA_TILE_KEYS,
                _cdiv(_cdiv(n, used), MMA_TILE_KEYS) * MMA_TILE_KEYS)
    lo = min(split * share, n)
    return lo, min(lo + share, n)


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
