"""Paged decode attention: one query token per sequence over the KV page
pool (PagedAttention layout).

Replaces the Pallas TPU kernel
``src/repro/kernels/paged_decode_attention.py::paged_decode_attention``
with the hand-written CUDA kernel ``csrc/paged_decode_attention.cu``
(``sm_90a``), bound through ``ctypes``.

  q            (B, H, D)        float32 or bfloat16
  k/v_pages    (N, KVH, bs, D)  logical position p of sequence b lives in
                                page block_table[b, p // bs], row p % bs
  block_table  (B, nb) int32    ids >= N are sentinels (unallocated
                                blocks): reads clamp, the rows are masked
  lengths      (B,) int32       valid tokens INCLUDING the newest
  returns      (B, H, D)        q's dtype; 0 for a row with no valid key

What bounds it on the H100 is the live KV it must read,
``2 * sum(lengths) * KVH * D`` elements at 3.35 TB/s: decode does 4
flops per byte-sized element, far below the tensor-core line.  The kernel
reads every live page once per KV head (one CTA per (sequence, KV head)
holds the whole GQA group of queries), walks only the live blocks of the
block table, and keeps the softmax in f32 registers and shared memory, so
nothing is densified into device memory.

On a CPU tensor the wrapper runs ``paged_decode_attention_plain``, the
same function in plain PyTorch; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import check_cuda_inputs, launch, on_cpu

# launches of the CUDA kernel in this process (the plain version does not
# count); reset by whoever reads it
launches = 0


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Densify pages (N, KVH, bs, D) through block_table (B, nb) into
    (B, KVH, nb * bs, D) f32; sentinel ids clamp to a real page whose
    contents the caller masks."""
    N, KVH, bs, D = pages.shape
    B, nb = block_table.shape
    g = pages[block_table.long().clamp(0, N - 1)]          # (B, nb, KVH, bs, D)
    return g.permute(0, 2, 1, 3, 4).reshape(B, KVH, nb * bs, D).float()


def masked_softmax_attend(s: torch.Tensor, mask: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """softmax(s) @ v over the keys where ``mask`` holds, in f32; a row
    with no visible key gives 0 (denominator floored at 1e-20, as in the
    kernels)."""
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return torch.matmul(p, v) / denom


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract)."""
    B, H, D = q.shape
    KVH, bs = k_pages.shape[1], k_pages.shape[2]
    nb = block_table.shape[1]
    G = H // KVH
    k = gather_pages(k_pages, block_table)                 # (B, KVH, S, D)
    v = gather_pages(v_pages, block_table)
    qg = q.reshape(B, KVH, G, D).float()
    s = torch.matmul(qg, k.transpose(-1, -2)) / math.sqrt(D)   # (B, KVH, G, S)
    live = torch.arange(nb * bs, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]                    # (B, S)
    out = masked_softmax_attend(s, live[:, None, None, :], v)
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Paged decode attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (contract in the module docstring)."""
    global launches
    inputs = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
              "block_table": block_table, "lengths": lengths}
    if on_cpu(inputs):
        return paged_decode_attention_plain(q, k_pages, v_pages, block_table,
                                            lengths)
    dtype = check_cuda_inputs(
        "paged_decode_attention",
        {"q": q, "k_pages": k_pages, "v_pages": v_pages},
        {"block_table": block_table, "lengths": lengths})
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B, H, D) and pages (N, KVH, bs, D), got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, D = q.shape
    N, KVH, bs, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or H % KVH:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    if H // KVH > 64 or D > 128:
        raise ValueError(f"the kernel takes at most 64 query heads per KV "
                         f"head and head_dim <= 128, got {H // KVH} and {D}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.shape[1] < 1 or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_table must be (B, nb >= 1) and lengths (B,), "
                         f"got {tuple(block_table.shape)} and "
                         f"{tuple(lengths.shape)} for B={B}")
    nb = block_table.shape[1]
    out = torch.empty_like(q)
    launch("paged_decode_attention", "paged_decode_error_string", q.device,
           [q, k_pages, v_pages, block_table, lengths, out],
           [B, H, KVH, D, N, bs, nb, dtype])
    launches += 1
    return out
