"""Paged prefill-chunk attention: the queries of one prompt chunk per
sequence attend the sequence's page-resident prefix and, causally, the
chunk's own keys; in float and with int8 prefix pages.

Replaces the Pallas TPU kernels
``src/repro/kernels/paged_prefill_attention.py::paged_prefill_attention``
and ``::paged_prefill_attention_quant`` with the hand-written CUDA kernels
of ``csrc/paged_prefill_attention.cu`` (``sm_90a``), bound through
``ctypes``.

  q            (B, H, C, D)     row c at absolute position starts[b] + c
  k/v_pages    (N, KVH, bs, D)  the page pool (see paged_decode_attention),
                                q's dtype or int8 (the quant twin)
  k/v_scale    (N, KVH, bs)     quant twin only: per-row scales, q's dtype
  chunk_k/v    (B, KVH, C, D)   the chunk's own keys and values, q's dtype
                                in both twins: the fresh projections, not
                                a read-back of the int8 pages
  block_table  (B, nb) int32    ids >= N are sentinels: reads clamp
  starts       (B,) int32       tokens already in pages
  valid        (B,) int32       real tokens in the chunk, 0 = inactive row
  returns      (B, H, C, D)     q's dtype

Every prefix position < starts[b] is visible to every chunk query; chunk
key j is visible to query c iff j <= c and j < valid[b].  Rows at or past
valid[b] follow the same rule, as in the TPU kernel, whose q tiles that
start at or past valid[b] give zeros (``live_rows``: a chunk of up to 128
rows is one tile there, so only an inactive row is zero; a longer chunk
zeroes every row from the end of the tile that holds row valid[b] - 1).
Callers of a dense model ignore those rows, but an MoE layer routes them,
and they use expert capacity: the kernel and its plain version give them
the same values.  The wrappers pass ``reference_q_tile(C)`` to the kernel,
which keeps no copy of that tiling.

What bounds it on the H100 is the bytes it reads: the live prefix KV,
``2 * sum(starts) * KVH * D`` elements, plus q, the chunk's k/v and the
output, at 3.35 TB/s (at the engine's chunk lengths the flops stay under
the tensor-core line).  The kernels stream the prefix pages in place,
without densifying them, once per KV head and tile of at most 64 query
rows (the GQA group times a tile of chunk positions), and fold prefix and
chunk into one f32 online softmax.  Both kernels (plan:
``common.attention_plan``, with ``quant`` for the int8 twin) bring 64-key
tiles in by ``cp.async`` into a ring of shared stages and run both
products on the tensor cores (``mma.sync``: bf16, or 3xTF32 for f32).
The int8 twin brings its prefix rows in as int8 with their scales,
converts them exactly (unscaled) into bf16 / f32 tiles and applies the
k-scales to the scores and the v-scales to the probabilities in f32;
then the chunk's float tiles fold into the same softmax.

On CPU tensors the wrappers run ``paged_prefill_attention_plain`` /
``paged_prefill_attention_quant_plain``; on CUDA tensors they launch the
kernel or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.local import whole
from repro_torch.kernels.common import (attention_plan, check_cuda_inputs,
                                       launch, on_cpu)
from repro_torch.kernels.decode_attention import (dequantize_rows,
                                                  masked_softmax_attend)
from repro_torch.kernels.paged_decode_attention import gather_pages

# launches of the float and the int8 CUDA kernel in this process (the
# plain versions do not count); reset by whoever reads them
launches = 0
quant_launches = 0


def reference_q_tile(C: int) -> int:
    """Query rows per q tile of the reference's Pallas kernel
    (``auto_q_tile``): a chunk of up to 128 rows is one tile, a longer one
    the largest divisor in (16, 128], else one tile."""
    if C <= 128:
        return C
    return next((t for t in range(128, 16, -1) if C % t == 0), C)


def live_rows(C: int, valid: torch.Tensor) -> torch.Tensor:
    """(B,) the rows each sequence computes: those of the reference
    kernel's q tiles that start below ``valid`` (padding rows included,
    which an MoE layer routes); the rest are zeros, as there."""
    qt = reference_q_tile(C)
    vd = valid.long().clamp(0, C)
    return torch.where(vd > 0, ((vd + qt - 1) // qt * qt).clamp(max=C), 0)


def _prefill_plain(q: torch.Tensor, k_prefix: torch.Tensor,
                   v_prefix: torch.Tensor, chunk_k: torch.Tensor,
                   chunk_v: torch.Tensor, starts: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Both segments in f32: the dense prefix (B, KVH, S, D), masked to
    positions < starts, then the chunk's keys, causal and < valid; rows
    past ``live_rows`` zero."""
    B, H, C, D = q.shape
    KVH, S = k_prefix.shape[1], k_prefix.shape[2]
    G = H // KVH
    dev = q.device
    k = torch.cat([k_prefix, chunk_k.float()], dim=2)
    v = torch.cat([v_prefix, chunk_v.float()], dim=2)
    qg = whole(q, 1).reshape(B, KVH, G, C, D).float()   # heads unsharded
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
    out = masked_softmax_attend(s, mask, v[:, :, None]).reshape(B, H, C, D)
    live = c[None, :] < live_rows(C, valid)[:, None]            # (B, C)
    return (out * live[:, None, :, None]).to(q.dtype)


def paged_prefill_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  chunk_k: torch.Tensor,
                                  chunk_v: torch.Tensor,
                                  block_table: torch.Tensor,
                                  starts: torch.Tensor,
                                  valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the float kernel (same contract)."""
    return _prefill_plain(q, gather_pages(k_pages, block_table),
                          gather_pages(v_pages, block_table), chunk_k,
                          chunk_v, starts, valid)


def paged_prefill_attention_quant_plain(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor, chunk_k: torch.Tensor,
        chunk_v: torch.Tensor, block_table: torch.Tensor,
        starts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel (same contract): the
    prefix dequantized in f32, the chunk's keys as given."""
    k = dequantize_rows(gather_pages(k_pages, block_table),
                        gather_pages(k_scale, block_table))
    v = dequantize_rows(gather_pages(v_pages, block_table),
                        gather_pages(v_scale, block_table))
    return _prefill_plain(q, k, v, chunk_k, chunk_v, starts, valid)


def _check_shapes(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, chunk_k: torch.Tensor,
                  chunk_v: torch.Tensor, block_table: torch.Tensor,
                  starts: torch.Tensor, valid: torch.Tensor) -> None:
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, C, D) and pages (N, KVH, "
                         f"bs, D), got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B, H, C, D = q.shape
    KVH = k_pages.shape[1]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != D or H % KVH \
            or chunk_k.shape != (B, KVH, C, D) \
            or chunk_v.shape != chunk_k.shape:
        raise ValueError(f"{name}: shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"chunk k/v {tuple(chunk_k.shape)}/"
                         f"{tuple(chunk_v.shape)}")
    if H // KVH > 64 or D > 128:
        raise ValueError(f"{name}: the kernel takes at most 64 query heads "
                         f"per KV head and head_dim <= 128, got {H // KVH} "
                         f"and {D}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.shape[1] < 1 or tuple(starts.shape) != (B,) \
            or tuple(valid.shape) != (B,):
        raise ValueError(f"{name}: block_table must be (B, nb >= 1), starts "
                         f"and valid (B,), got {tuple(block_table.shape)}, "
                         f"{tuple(starts.shape)}, {tuple(valid.shape)}")


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
    _check_shapes("paged_prefill_attention", q, k_pages, v_pages, chunk_k,
                  chunk_v, block_table, starts, valid)
    B, H, C, D = q.shape
    N, KVH, bs, _ = k_pages.shape
    nb = block_table.shape[1]
    plan = attention_plan(B, H, KVH, C, D, q.dtype)
    out = torch.empty_like(q)
    launch("paged_prefill_attention", "paged_prefill_attention", q.device,
           [q, k_pages, v_pages, chunk_k, chunk_v, block_table, starts, valid,
            out],
           [B, H, KVH, C, D, N, bs, nb, dtype, plan.tile_q,
            reference_q_tile(C), plan.d_pad, plan.smem_bytes])
    launches += 1
    return out


def paged_prefill_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  k_scale: torch.Tensor,
                                  v_scale: torch.Tensor,
                                  chunk_k: torch.Tensor,
                                  chunk_v: torch.Tensor,
                                  block_table: torch.Tensor,
                                  starts: torch.Tensor,
                                  valid: torch.Tensor) -> torch.Tensor:
    """Paged prefill-chunk attention over an int8 prefix: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    global quant_launches
    inputs = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
              "k_scale": k_scale, "v_scale": v_scale, "chunk_k": chunk_k,
              "chunk_v": chunk_v, "block_table": block_table,
              "starts": starts, "valid": valid}
    if on_cpu(inputs):
        return paged_prefill_attention_quant_plain(
            q, k_pages, v_pages, k_scale, v_scale, chunk_k, chunk_v,
            block_table, starts, valid)
    dtype = check_cuda_inputs(
        "paged_prefill_attention_quant",
        {"q": q, "k_scale": k_scale, "v_scale": v_scale, "chunk_k": chunk_k,
         "chunk_v": chunk_v},
        {"block_table": block_table, "starts": starts, "valid": valid},
        {"k_pages": k_pages, "v_pages": v_pages})
    _check_shapes("paged_prefill_attention_quant", q, k_pages, v_pages,
                  chunk_k, chunk_v, block_table, starts, valid)
    if k_scale.shape != k_pages.shape[:3] or v_scale.shape != k_scale.shape:
        raise ValueError(f"paged_prefill_attention_quant: scale pages must "
                         f"be {tuple(k_pages.shape[:3])}, got "
                         f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
    B, H, C, D = q.shape
    N, KVH, bs, _ = k_pages.shape
    nb = block_table.shape[1]
    plan = attention_plan(B, H, KVH, C, D, q.dtype, quant=True)
    out = torch.empty_like(q)
    launch("paged_prefill_attention", "paged_prefill_attention_quant",
           q.device,
           [q, k_pages, v_pages, k_scale, v_scale, chunk_k, chunk_v,
            block_table, starts, valid, out],
           [B, H, KVH, C, D, N, bs, nb, dtype, plan.tile_q,
            reference_q_tile(C), plan.d_pad, plan.smem_bytes])
    quant_launches += 1
    return out
