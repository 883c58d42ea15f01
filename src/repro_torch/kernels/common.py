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
# int8 KV (csrc/mma_attention.cuh, Int8Layout): stages of int8 rows and
# their scales, converted into one tile pair of the compute dtype
INT8_STAGES = 3

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
    """Launch plan of a tensor-core attention kernel (flash, paged prefill
    in float and int8): one CTA per (query tile, KV head, sequence), its
    rows the GQA group's heads times ``tile_q`` positions.  The C entry points take
    ``tile_q``, ``d_pad`` and ``smem_bytes`` and refuse a plan they do not
    instantiate or whose bytes differ from their ring's."""
    group: int                  # query heads per KV head
    tile_q: int                 # positions per CTA
    rows: int                   # group * tile_q <= MMA_ROWS query rows
    d_pad: int                  # head_dim padded to an instantiated width
    grid: Tuple[int, int, int]  # (query tiles, KV heads, sequences)
    smem_bytes: int             # the K/V ring(s) (+ q's TF32 parts in f32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _esize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _q_split_bytes(d_pad: int, dtype: torch.dtype) -> int:
    """f32 only: each thread's q fragments split for 3xTF32 (TF32 high
    parts and residuals), kept in shared memory past the rings."""
    return 2 * MMA_THREADS * (d_pad // 2) * 4 if dtype == torch.float32 else 0


def _float_ring(d_pad: int, dtype: torch.dtype) -> int:
    """The float K/V ring (``Layout``): stages x (K, V) x 64 key rows of
    ``d_pad`` elements plus 16 bytes (bank-conflict padding)."""
    return MMA_STAGES[dtype] * 2 * MMA_TILE_KEYS * (d_pad * _esize(dtype) + 16)


def _int8_ring(d_pad: int, dtype: torch.dtype) -> int:
    """The int8 ring (``Int8Layout``): one converted (K, V) tile pair in
    ``dtype`` (rows of ``d_pad`` elements plus 16 bytes), then the int8
    stages (K and V rows of ``d_pad`` bytes, then one scale in ``dtype``
    per key for each)."""
    esize = _esize(dtype)
    conv = 2 * MMA_TILE_KEYS * (d_pad * esize + 16)
    stage = 2 * MMA_TILE_KEYS * d_pad + 2 * MMA_TILE_KEYS * esize
    return conv + INT8_STAGES * stage


def _ring_bytes(d_pad: int, dtype: torch.dtype) -> int:
    """Shared bytes of a float tensor-core kernel: its K/V ring and, in
    f32, each thread's q split for 3xTF32."""
    return _float_ring(d_pad, dtype) + _q_split_bytes(d_pad, dtype)


def _int8_ring_bytes(d_pad: int, dtype: torch.dtype) -> int:
    """Shared bytes of the int8 decode kernels: the int8 ring and, in f32,
    each thread's q split."""
    return _int8_ring(d_pad, dtype) + _q_split_bytes(d_pad, dtype)


def _int8_prefill_bytes(d_pad: int, dtype: torch.dtype) -> int:
    """Shared bytes of the int8 paged prefill (``PrefillInt8Layout``): the
    int8 prefix ring and the chunk's float ring from one base (one loop
    runs after the other), and in f32 q's split past the larger, where
    neither loop writes."""
    return (max(_float_ring(d_pad, dtype), _int8_ring(d_pad, dtype))
            + _q_split_bytes(d_pad, dtype))


def attention_plan(B: int, H: int, KVH: int, L: int, D: int,
                   dtype: torch.dtype, quant: bool = False) -> AttentionPlan:
    """The plan for ``L`` query positions of ``H`` heads on ``KVH`` KV
    heads, head_dim ``D``, in ``dtype``.  The ring holds stages x (K, V) x
    64 key rows of ``d_pad`` elements plus 16 bytes (bank-conflict
    padding); in f32 each thread's q fragments follow, as TF32 high parts
    and residuals.  With ``quant`` (the int8 paged prefill) the int8
    prefix ring and the float chunk ring share one base and q's parts
    follow the larger (``_int8_prefill_bytes``)."""
    if not (B >= 1 and KVH >= 1 and H % KVH == 0 and H // KVH <= MMA_ROWS
            and L >= 1 and 1 <= D <= MMA_D_PADS[-1]):
        raise ValueError(f"no attention plan for B={B} H={H} KVH={KVH} "
                         f"L={L} D={D}")
    group = H // KVH
    tile_q = min(L, MMA_ROWS // group)
    d_pad = next(p for p in MMA_D_PADS if p >= D)
    smem = (_int8_prefill_bytes if quant else _ring_bytes)(d_pad, dtype)
    return AttentionPlan(group, tile_q, group * tile_q, d_pad,
                         (-(-L // tile_q), KVH, B), smem)


@dataclass(frozen=True)
class DecodePlan:
    """Launch plan of a split-KV decode kernel (paged and dense decode,
    float or int8 KV): ``splits`` CTAs per (sequence, KV head), each over its share
    of the sequence's keys (``split_range``), their rows the GQA group
    padded to 16-row tiles (at ``group <= 16`` the four warps share one
    row tile and take interleaved 16-key slices of each 64-key tile; the
    kernel chooses that from the group itself).  With more than one split,
    the CTAs write f32 partials (O, m, l) to a workspace
    of ``workspace_floats`` and the last to arrive of each (sequence, KV
    head) merges them, counted on ``split_tickets``."""
    group: int                  # query heads per KV head
    d_pad: int                  # head_dim padded to an instantiated width
    splits: int                 # CTAs per (sequence, KV head)
    grid: Tuple[int, int, int]  # (splits, KV heads, sequences)
    smem_bytes: int             # the float or int8 ring (+ q's TF32 parts)
    workspace_floats: int       # 0 when splits == 1


def decode_plan(B: int, H: int, KVH: int, cap: int, D: int,
                dtype: torch.dtype, quant: bool = False) -> DecodePlan:
    """The plan for one query token of ``H`` heads on ``KVH`` KV heads per
    sequence, over at most ``cap`` keys a sequence (``nb * bs`` pages or
    ``S`` rows), q in ``dtype`` and the KV in ``dtype`` or, with
    ``quant``, int8 with scales in ``dtype``.  It reads shapes only, never
    the lengths: the split count of a call is known on the host before the
    call and the same for every replay of a captured graph."""
    if not (B >= 1 and KVH >= 1 and H % KVH == 0 and H // KVH <= MMA_ROWS
            and cap >= 1 and 1 <= D <= MMA_D_PADS[-1]):
        raise ValueError(f"no decode plan for B={B} H={H} KVH={KVH} "
                         f"cap={cap} D={D}")
    group = H // KVH
    d_pad = next(p for p in MMA_D_PADS if p >= D)
    smem = (_int8_ring_bytes if quant else _ring_bytes)(d_pad, dtype)
    per_sm = min(SPLIT_CTAS_PER_SM, SMEM_PER_SM // (smem + 1024))
    splits = max(1, min(H100_SMS * per_sm // (B * KVH),
                        _cdiv(cap, SPLIT_MIN_KEYS), SPLIT_MAX))
    workspace = B * KVH * splits * group * (D + 2) if splits > 1 else 0
    return DecodePlan(group, d_pad, splits, (splits, KVH, B), smem,
                      workspace)


# The SSD scan (csrc/ssd_scan.cu): eight warps a CTA (four for y, four for
# the state), one CTA per (slice of SSD_SLICE state columns, head,
# sequence); chunks of at most 128 rows, chunk and state padded to the
# 16-row mma tiles; two stages of the chunk's inputs where they fit, else
# one.
SSD_THREADS = 256
SSD_SLICE = 16
SSD_MAX_CHUNK = 128
SSD_STATE_ROW = 24          # floats a shared state row


@dataclass(frozen=True)
class SsdPlan:
    """Launch plan of the SSD scan: one CTA per (slice of ``slice_p``
    columns of P, head, sequence), each over every chunk of its sequence
    with its slice of the state.  The C entry point takes ``slice_p``,
    ``stages`` and ``smem_bytes`` and refuses a plan it does not
    instantiate or whose bytes differ from its layout."""
    slice_p: int                # state / output columns per CTA
    slices: int                 # ceil(P / slice_p)
    grid: Tuple[int, int, int]  # (slices, heads, sequences)
    q_pad: int                  # the chunk padded to 16 rows
    n_pad: int                  # the state padded to 16 rows
    stages: int                 # chunks in shared memory at once (2 or 1)
    smem_bytes: int             # stages of B, C, x, dt; states; cumsums


def _ssd_bytes(esize: int, q_pad: int, n_pad: int, stages: int) -> int:
    """``ssd::layout``: ``stages`` stages, each B and C (q_pad rows of
    n_pad elements plus 16 bytes), x's slice (q_pad rows of SSD_SLICE
    elements plus 8 bf16 or 4 f32 of pad) and dt (q_pad floats); two f32
    states of n_pad rows of SSD_STATE_ROW; each warp's cumsum or state
    weights (q_pad floats)."""
    stage = (2 * esize * q_pad * (n_pad + 16 // esize)
             + esize * q_pad * (SSD_SLICE + (4 if esize == 4 else 8))
             + 4 * q_pad)
    return (stages * stage + 4 * 2 * n_pad * SSD_STATE_ROW
            + 4 * (SSD_THREADS // 32) * q_pad)


def ssd_plan(B: int, L: int, H: int, P: int, G: int, N: int, Q: int,
             dtype: torch.dtype) -> SsdPlan:
    """The plan for x (B, L, H, P), B/C (B, L, G, N) in ``dtype`` and
    chunks of ``Q``; shapes only.  Two stages where their bytes fit a CTA,
    else one (f32 at large chunk x d_state); refused where one does not
    fit."""
    if not (B >= 1 and L >= 1 and H >= 1 and G >= 1 and H % G == 0
            and N >= 1 and P >= 1 and 1 <= Q <= SSD_MAX_CHUNK
            and L % Q == 0 and B <= 65535 and H <= 65535
            and dtype in DTYPE_CODES):
        raise ValueError(f"no SSD plan for B={B} L={L} H={H} P={P} G={G} "
                         f"N={N} chunk={Q} {dtype}: the kernel takes chunks "
                         f"of 1..{SSD_MAX_CHUNK} dividing L, heads a "
                         f"multiple of groups")
    esize = _esize(dtype)
    q_pad, n_pad = _cdiv(Q, 16) * 16, _cdiv(N, 16) * 16
    stages = 2 if _ssd_bytes(esize, q_pad, n_pad, 2) <= SMEM_PER_SM else 1
    smem = _ssd_bytes(esize, q_pad, n_pad, stages)
    if smem > SMEM_PER_SM:
        raise ValueError(f"no SSD plan for chunk {Q}, d_state {N} in "
                         f"{dtype}: one stage takes {smem} bytes of shared "
                         f"memory, over the {SMEM_PER_SM} a CTA may use")
    slices = _cdiv(P, SSD_SLICE)
    return SsdPlan(SSD_SLICE, slices, (slices, H, B), q_pad, n_pad, stages,
                   smem)


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


def split_buffers(plan: DecodePlan, device: torch.device, n: int
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The f32 workspace of a split-KV ``plan`` (``torch.empty``) and ``n``
    of its arrival tickets on ``device``; (None, None) for one split."""
    if plan.splits == 1:
        return None, None
    return (torch.empty(plan.workspace_floats, dtype=torch.float32,
                        device=device), split_tickets(device, n))


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
    """True when every tensor lies on the CPU (the plain version runs) or
    on the ``meta`` device, False when all lie on one CUDA device (the
    kernel runs).  Anything else raises: a CUDA tensor never reaches the
    plain version.  Meta tensors are the dry run's
    (``launch/dryrun.py``): no kernel can take them, since a kernel reads
    data through its pointers, so the plain version carries their shapes
    through, as the reference's dry run lowers its jnp path."""
    devices = {t.device for t in tensors.values()}
    if devices in ({torch.device("cpu")}, {torch.device("meta")}):
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
