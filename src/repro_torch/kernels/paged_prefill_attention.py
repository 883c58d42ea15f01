"""Paged prefill-chunk attention: the queries of one prompt chunk per
sequence attend the sequence's page-resident prefix and, causally, the
chunk's own keys.

Replaces the Pallas TPU kernel
``src/repro/kernels/paged_prefill_attention.py::paged_prefill_attention``
with the hand-written CUDA kernel ``csrc/paged_prefill_attention.cu``
(``sm_90a``), bound through ``ctypes``.

  q            (B, H, C, D)     row c at absolute position starts[b] + c
  k/v_pages    (N, KVH, bs, D)  the page pool (see paged_decode_attention)
  chunk_k/v    (B, KVH, C, D)   the chunk's own keys and values
  block_table  (B, nb) int32    ids >= N are sentinels: reads clamp
  starts       (B,) int32       tokens already in pages
  valid        (B,) int32       real tokens in the chunk, 0 = inactive row
  returns      (B, H, C, D)     q's dtype

Every prefix position < starts[b] is visible to every chunk query; chunk
key j is visible to query c iff j <= c and j < valid[b].  Rows at or past
valid[b] are garbage the caller ignores, as in the TPU kernel.

What bounds it on the H100 is the bytes it reads: the live prefix KV,
``2 * sum(starts) * KVH * D`` elements, plus q, the chunk's k/v and the
output, at 3.35 TB/s (at the engine's chunk lengths the flops stay under
the tensor-core line).  The kernel streams the prefix pages in place,
without densifying them, once per KV head and tile of at most 64 query
rows (the GQA group times a tile of chunk positions), and folds prefix and
chunk into one f32 online softmax.

On a CPU tensor the wrapper runs ``paged_prefill_attention_plain``; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import check_cuda_inputs, launch, on_cpu
from repro_torch.kernels.paged_decode_attention import (gather_pages,
                                                        masked_softmax_attend)

# launches of the CUDA kernel in this process (the plain version does not
# count); reset by whoever reads it
launches = 0


def paged_prefill_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  chunk_k: torch.Tensor,
                                  chunk_v: torch.Tensor,
                                  block_table: torch.Tensor,
                                  starts: torch.Tensor,
                                  valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract)."""
    B, H, C, D = q.shape
    KVH, bs = k_pages.shape[1], k_pages.shape[2]
    S = block_table.shape[1] * bs
    G = H // KVH
    dev = q.device
    k = torch.cat([gather_pages(k_pages, block_table), chunk_k.float()], dim=2)
    v = torch.cat([gather_pages(v_pages, block_table), chunk_v.float()], dim=2)
    qg = q.reshape(B, KVH, G, C, D).float()
    s = torch.matmul(qg, k[:, :, None].transpose(-1, -2)) \
        / math.sqrt(D)                                          # (B,KVH,G,C,S+C)
    starts = starts.to(dev)
    valid = valid.to(dev)
    prefix = (torch.arange(S, device=dev)[None, :] < starts[:, None])
    prefix = prefix[:, None, :].expand(B, C, S)
    c = torch.arange(C, device=dev)
    chunk = (c[None, :] <= c[:, None])[None] \
        & (c[None, None, :] < valid[:, None, None])             # (B, C, C)
    mask = torch.cat([prefix, chunk], dim=-1)[:, None, None]   # (B,1,1,C,S+C)
    out = masked_softmax_attend(s, mask, v[:, :, None])
    return out.reshape(B, H, C, D).to(q.dtype)


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, chunk_k: torch.Tensor,
                            chunk_v: torch.Tensor, block_table: torch.Tensor,
                            starts: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """Paged prefill-chunk attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (contract in the module docstring)."""
    global launches
    inputs = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
              "chunk_k": chunk_k, "chunk_v": chunk_v,
              "block_table": block_table, "starts": starts, "valid": valid}
    if on_cpu(inputs):
        return paged_prefill_attention_plain(q, k_pages, v_pages, chunk_k,
                                             chunk_v, block_table, starts,
                                             valid)
    dtype = check_cuda_inputs(
        "paged_prefill_attention",
        {"q": q, "k_pages": k_pages, "v_pages": v_pages, "chunk_k": chunk_k,
         "chunk_v": chunk_v},
        {"block_table": block_table, "starts": starts, "valid": valid})
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B, H, C, D) and pages (N, KVH, bs, D), "
                         f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, C, D = q.shape
    N, KVH, bs, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or H % KVH \
            or chunk_k.shape != (B, KVH, C, D) \
            or chunk_v.shape != chunk_k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"chunk k/v {tuple(chunk_k.shape)}/"
                         f"{tuple(chunk_v.shape)}")
    if H // KVH > 64 or D > 128:
        raise ValueError(f"the kernel takes at most 64 query heads per KV "
                         f"head and head_dim <= 128, got {H // KVH} and {D}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.shape[1] < 1 or tuple(starts.shape) != (B,) \
            or tuple(valid.shape) != (B,):
        raise ValueError(f"block_table must be (B, nb >= 1), starts and valid "
                         f"(B,), got {tuple(block_table.shape)}, "
                         f"{tuple(starts.shape)}, {tuple(valid.shape)}")
    nb = block_table.shape[1]
    out = torch.empty_like(q)
    launch("paged_prefill_attention", "paged_prefill_error_string", q.device,
           [q, k_pages, v_pages, chunk_k, chunk_v, block_table, starts, valid,
            out],
           [B, H, KVH, C, D, N, bs, nb, dtype])
    launches += 1
    return out
