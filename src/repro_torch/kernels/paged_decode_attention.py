"""Paged decode attention: one query token per sequence over the KV page
pool (PagedAttention layout), in float and with int8 pages.

Replaces the Pallas TPU kernels
``src/repro/kernels/paged_decode_attention.py::paged_decode_attention``
and ``::paged_decode_attention_quant`` with the hand-written CUDA kernels
of ``csrc/paged_decode_attention.cu`` (``sm_90a``), bound through
``ctypes``.

  q            (B, H, D)        float32 or bfloat16
  k/v_pages    (N, KVH, bs, D)  q's dtype, or int8 (the quant twin);
                                logical position p of sequence b lives in
                                page block_table[b, p // bs], row p % bs
  k/v_scale    (N, KVH, bs)     quant twin only: one scale per row in q's
                                dtype; a row is f32(x) * f32(scale)
  block_table  (B, nb) int32    ids >= N are sentinels (unallocated
                                blocks): reads clamp, the rows are masked
  lengths      (B,) int32       valid tokens INCLUDING the newest
  returns      (B, H, D)        q's dtype; 0 for a row with no valid key

What bounds it on the H100 is the live KV it must read,
``2 * sum(lengths) * KVH * D`` elements (plus the int8 twin's scales) at
3.35 TB/s: decode does 4 flops per element, far below the tensor-core
line.  Both kernels read every live page once per KV head (the CTAs of a
(sequence, KV head) hold the whole GQA group of queries) and walk only the
live blocks of the block table, so nothing is densified into device
memory.  The float kernel is the split-KV tensor-core decode of
``csrc/decode_mma.cuh``: the plan (``common.decode_plan``, from shapes
only) gives each (sequence, KV head) several CTAs when the table spans
more than 256 keys, each CTA gathers 64-key tiles by 16-byte ``cp.async``
and runs the group's rows on ``mma.sync``, and the last CTA of each
(sequence, KV head) to finish merges the partial softmaxes from an f32
workspace.  The int8 twin keeps one CUDA-core CTA per (sequence, KV head)
and dequantizes rows as they enter its f32 shared tile.

On CPU tensors the wrappers run ``paged_decode_attention_plain`` /
``paged_decode_attention_quant_plain``, the same functions in plain
PyTorch; on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (check_cuda_inputs, decode_plan,
                                       launch, on_cpu, split_tickets)
from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                  dequantize_rows)

# launches of the float and the int8 CUDA kernel in this process (the
# plain versions do not count); reset by whoever reads them
launches = 0
quant_launches = 0


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Densify pages (N, KVH, bs, ...) through block_table (B, nb) into
    (B, KVH, nb * bs, ...) f32; sentinel ids clamp to a real page whose
    contents the caller masks.  Takes k/v pages and scale pages alike."""
    N = pages.shape[0]
    g = pages[block_table.long().clamp(0, N - 1)]          # (B, nb, KVH, bs, ...)
    B, nb, KVH, bs = g.shape[:4]
    return g.movedim(2, 1).reshape((B, KVH, nb * bs) + g.shape[4:]).float()


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the float kernel (same contract)."""
    return decode_attention_plain(q, gather_pages(k_pages, block_table),
                                  gather_pages(v_pages, block_table), lengths)


def paged_decode_attention_quant_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                       v_pages: torch.Tensor,
                                       k_scale: torch.Tensor,
                                       v_scale: torch.Tensor,
                                       block_table: torch.Tensor,
                                       lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel (same contract)."""
    k = dequantize_rows(gather_pages(k_pages, block_table),
                        gather_pages(k_scale, block_table))
    v = dequantize_rows(gather_pages(v_pages, block_table),
                        gather_pages(v_scale, block_table))
    return decode_attention_plain(q, k, v, lengths)


def _check_shapes(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_table: torch.Tensor,
                  lengths: torch.Tensor) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, D) and pages (N, KVH, "
                         f"bs, D), got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B, H, D = q.shape
    KVH = k_pages.shape[1]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != D or H % KVH:
        raise ValueError(f"{name}: shape mismatch: q {tuple(q.shape)}, "
                         f"k_pages {tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    if H // KVH > 64 or D > 128:
        raise ValueError(f"{name}: the kernel takes at most 64 query heads "
                         f"per KV head and head_dim <= 128, got {H // KVH} "
                         f"and {D}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.shape[1] < 1 or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: block_table must be (B, nb >= 1) and "
                         f"lengths (B,), got {tuple(block_table.shape)} and "
                         f"{tuple(lengths.shape)} for B={B}")


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
    _check_shapes("paged_decode_attention", q, k_pages, v_pages, block_table,
                  lengths)
    B, H, D = q.shape
    N, KVH, bs, _ = k_pages.shape
    nb = block_table.shape[1]
    plan = decode_plan(B, H, KVH, nb * bs, D, q.dtype)
    out = torch.empty_like(q)
    ws = tickets = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                         device=q.device)
        tickets = split_tickets(q.device, B * KVH)
    launch("paged_decode_attention", "paged_decode_attention", q.device,
           [q, k_pages, v_pages, block_table, lengths, out, ws, tickets],
           [B, H, KVH, D, N, bs, nb, dtype, plan.splits, plan.d_pad,
            plan.smem_bytes])
    launches += 1
    return out


def paged_decode_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Paged decode attention over int8 pages: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global quant_launches
    inputs = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
              "k_scale": k_scale, "v_scale": v_scale,
              "block_table": block_table, "lengths": lengths}
    if on_cpu(inputs):
        return paged_decode_attention_quant_plain(q, k_pages, v_pages, k_scale,
                                                  v_scale, block_table,
                                                  lengths)
    dtype = check_cuda_inputs(
        "paged_decode_attention_quant",
        {"q": q, "k_scale": k_scale, "v_scale": v_scale},
        {"block_table": block_table, "lengths": lengths},
        {"k_pages": k_pages, "v_pages": v_pages})
    _check_shapes("paged_decode_attention_quant", q, k_pages, v_pages,
                  block_table, lengths)
    if k_scale.shape != k_pages.shape[:3] or v_scale.shape != k_scale.shape:
        raise ValueError(f"paged_decode_attention_quant: scale pages must be "
                         f"{tuple(k_pages.shape[:3])}, got "
                         f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
    B, H, D = q.shape
    N, KVH, bs, _ = k_pages.shape
    nb = block_table.shape[1]
    out = torch.empty_like(q)
    launch("paged_decode_attention", "paged_decode_attention_quant", q.device,
           [q, k_pages, v_pages, k_scale, v_scale, block_table, lengths, out],
           [B, H, KVH, D, N, bs, nb, dtype])
    quant_launches += 1
    return out
