"""Dense decode attention: one query token per sequence over its own slot
of a dense per-slot KV cache, in float and with int8 rows.

Replaces the Pallas TPU kernels
``src/repro/kernels/decode_attention.py::decode_attention`` and
``::decode_attention_quant`` with the hand-written CUDA kernels of
``csrc/decode_attention.cu`` (``sm_90a``), bound through ``ctypes``.

  q          (B, H, D)        float32 or bfloat16
  k/v        (B, KVH, S, D)   q's dtype (``decode_attention``) or int8
                              (``decode_attention_quant``)
  k/v_scale  (B, KVH, S)      int8 twin only: one scale per row in q's
                              dtype; a row is f32(x) * f32(scale)
  lengths    (B,) int32       valid rows INCLUDING the newest token (its
                              k/v already written at row lengths - 1)
  returns    (B, H, D)        q's dtype; 0 for a row with no valid key

What bounds both on the H100 is the live KV they read,
``2 * sum(min(lengths, S)) * KVH * D`` elements (plus the scales) at
3.35 TB/s: decode does 4 flops per element read.  The CTAs of a
(sequence, KV head) hold the whole GQA group, read each live row once and
stop at the last one (the tail is masked, not padded to a tile multiple).
The float kernel is the split-KV tensor-core decode of
``csrc/decode_mma.cuh``: several CTAs per (sequence, KV head) when S
exceeds 256 (the plan, ``common.decode_plan``, reads shapes only), 64-key
tiles by 16-byte ``cp.async``, the group's rows on ``mma.sync``, and the
last CTA of each (sequence, KV head) to finish merging the partials from
an f32 workspace.  The int8 twin keeps one CUDA-core CTA per (sequence,
KV head) and dequantizes rows as they enter its f32 shared tile, so the
device-memory read stays int8 plus scales.

On CPU tensors the wrappers run ``decode_attention_plain`` /
``decode_attention_quant_plain``, the same functions in plain PyTorch; on
CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import (check_cuda_inputs, decode_plan,
                                       launch, on_cpu, split_tickets)

# launches of the float and the int8 CUDA kernel in this process (the
# plain versions do not count); reset by whoever reads them
launches = 0
quant_launches = 0


def masked_softmax_attend(s: torch.Tensor, mask: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """softmax(s) @ v over the keys where ``mask`` holds, in f32; a row
    with no visible key gives 0 (denominator floored at 1e-20, as in the
    kernels)."""
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return torch.matmul(p, v) / denom


def dequantize_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 rows (..., D) times their per-row scales (...,), in f32 (the
    kernels' dequantization)."""
    return x.float() * scale.float()[..., None]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the float kernel (same contract), in f32."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, KVH, H // KVH, D).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)) / math.sqrt(D)
    live = torch.arange(S, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]                    # (B, S)
    out = masked_softmax_attend(s, live[:, None, None, :], v.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_quant_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel (same contract)."""
    return decode_attention_plain(q, dequantize_rows(k, k_scale),
                                  dequantize_rows(v, v_scale), lengths)


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, lengths: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, D) and k/v (B, KVH, S, "
                         f"D), got {tuple(q.shape)} and {tuple(k.shape)}")
    B, H, D = q.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D \
            or H % k.shape[1] or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if H // k.shape[1] > 64 or D > 128:
        raise ValueError(f"{name}: the kernel takes at most 64 query heads "
                         f"per KV head and head_dim <= 128, got "
                         f"{H // k.shape[1]} and {D}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Dense decode attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (contract in the module docstring)."""
    global launches
    if on_cpu({"q": q, "k": k, "v": v, "lengths": lengths}):
        return decode_attention_plain(q, k, v, lengths)
    dtype = check_cuda_inputs("decode_attention", {"q": q, "k": k, "v": v},
                              {"lengths": lengths})
    _check_shapes("decode_attention", q, k, v, lengths)
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    plan = decode_plan(B, H, KVH, S, D, q.dtype)
    out = torch.empty_like(q)
    ws = tickets = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                         device=q.device)
        tickets = split_tickets(q.device, B * KVH)
    launch("decode_attention", "decode_attention", q.device,
           [q, k, v, lengths, out, ws, tickets],
           [B, H, KVH, S, D, dtype, plan.splits, plan.d_pad,
            plan.smem_bytes])
    launches += 1
    return out


def decode_attention_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Dense decode attention over int8 k/v: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global quant_launches
    inputs = {"q": q, "k": k, "v": v, "k_scale": k_scale,
              "v_scale": v_scale, "lengths": lengths}
    if on_cpu(inputs):
        return decode_attention_quant_plain(q, k, v, k_scale, v_scale,
                                            lengths)
    dtype = check_cuda_inputs(
        "decode_attention_quant",
        {"q": q, "k_scale": k_scale, "v_scale": v_scale},
        {"lengths": lengths}, {"k": k, "v": v})
    _check_shapes("decode_attention_quant", q, k, v, lengths)
    if k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
        raise ValueError(f"decode_attention_quant: scales must be "
                         f"{tuple(k.shape[:3])}, got {tuple(k_scale.shape)} "
                         f"and {tuple(v_scale.shape)}")
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    launch("decode_attention", "decode_attention_quant", q.device,
           [q, k, v, k_scale, v_scale, lengths, out],
           [B, H, KVH, S, D, dtype])
    quant_launches += 1
    return out
