"""GQA attention over the paged KV pool (PyTorch twin of the paged subset of
``src/repro/models/attention.py``).

The pool of one layer is ``{"k": (num_blocks + 1, KVH, block_size, D),
"v": ...}``: logical position ``p`` of a sequence lives in page
``block_table[p // block_size]`` at row ``p % block_size``.  Page
``num_blocks`` is a write sink: a write aimed at a sentinel page id
(``>= num_blocks``: inactive batch rows, blocks not yet allocated) lands
there instead of being dropped, which keeps the write a single
``index_put_`` with no host sync.  The sink is never read: the kernels see
only ``pool[:num_blocks]`` and clamp sentinel reads into it.

Pages are written in place BEFORE attention reads the pool.  The chunk's
writes land at positions ``>= starts`` while the prefix segment reads only
positions ``< starts``, so the attended values equal a pre-write read.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention
from repro_torch.models import layers


def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": layers.dense_init(gen, d, cfg.num_heads * hd, dtype, device),
        "wk": layers.dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wv": layers.dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wo": layers.dense_init(gen, cfg.num_heads * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros(width * hd, dtype=dtype, device=device)
    return p


def paged_kv_shape(cfg, num_blocks: int, block_size: int) -> Tuple[int, ...]:
    """Shape of one layer's k (or v) page pool: ``num_blocks`` pages plus
    the write sink."""
    return (num_blocks + 1, cfg.num_kv_heads, block_size,
            cfg.resolved_head_dim)


def _project_qkv(params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x: (B, L, d) -> q (B, L, H, hd), k/v (B, L, KVH, hd), with RoPE."""
    B, L, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, L, cfg.num_heads, hd)
    k = k.reshape(B, L, cfg.num_kv_heads, hd)
    v = v.reshape(B, L, cfg.num_kv_heads, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _write_pages(pool: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, page: torch.Tensor,
                 offset: torch.Tensor) -> None:
    """Scatter per-token k/v (..., KVH, D) into the pool at (page, offset),
    in place.  ``page``/``offset`` share the leading dims of k/v; sentinel
    page ids (>= num_blocks) are redirected to the write sink."""
    sink = pool["k"].shape[0] - 1
    page = torch.clamp(page, max=sink).long()
    offset = offset.long()
    pool["k"][page, :, offset] = k.to(pool["k"].dtype)
    pool["v"][page, :, offset] = v.to(pool["v"].dtype)


def attend_decode_paged(params, cfg, x: torch.Tensor, lengths: torch.Tensor,
                        block_table: torch.Tensor,
                        pool: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One-token decode against the paged KV pool (full attention).

    x: (B, 1, d); lengths: (B,) int32 tokens already cached (= the new
    token's position); block_table: (B, nb) int32.  The new token's k/v is
    written at page ``block_table[b, pos // bs]`` row ``pos % bs`` (to the
    sink when that block is unallocated) before the kernel attends the
    inclusive ``lengths + 1`` tokens.  Returns (B, 1, d).
    """
    B = x.shape[0]
    num_blocks, bs = pool["k"].shape[0] - 1, pool["k"].shape[2]
    nb = block_table.shape[1]
    q, k, v = _project_qkv(params, cfg, x, lengths[:, None])
    logical = lengths // bs
    page = torch.gather(block_table, 1,
                        logical.clamp(max=nb - 1)[:, None].long())[:, 0]
    page = torch.where(logical < nb, page, num_blocks)
    _write_pages(pool, k[:, 0], v[:, 0], page, lengths % bs)
    attn = paged_decode_attention(q[:, 0].contiguous(), pool["k"][:num_blocks],
                                  pool["v"][:num_blocks], block_table,
                                  lengths + 1)
    return attn.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim) \
        @ params["wo"]


def attend_prefill_chunk_paged(params, cfg, x: torch.Tensor,
                               positions: torch.Tensor, valid: torch.Tensor,
                               block_table: torch.Tensor,
                               pool: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One prefill chunk per row against the paged KV pool.

    x: (B, C, d) right-padded chunk; positions: (B, C) absolute positions
    (row b starts at ``starts[b] = positions[b, 0]``); valid: (B,) int32
    real tokens per row (0 = inactive: no writes, output ignored).  The
    chunk's k/v are written to their pages, then the kernel attends the
    page-resident prefix and the chunk causally.  Returns (B, C, d).
    """
    B, C, _ = x.shape
    num_blocks, bs = pool["k"].shape[0] - 1, pool["k"].shape[2]
    nb = block_table.shape[1]
    q, k, v = _project_qkv(params, cfg, x, positions)  # k/v: (B, C, KVH, hd)
    in_chunk = torch.arange(C, device=x.device)[None, :] < valid[:, None]
    logical = positions // bs
    page = torch.gather(block_table, 1, logical.clamp(0, nb - 1).long())
    page = torch.where(in_chunk & (logical < nb), page, num_blocks)
    _write_pages(pool, k, v, page, positions % bs)
    attn = paged_prefill_attention(
        q.transpose(1, 2).contiguous(), pool["k"][:num_blocks],
        pool["v"][:num_blocks], k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), block_table,
        positions[:, 0].to(torch.int32).contiguous(), valid)
    out = attn.transpose(1, 2).reshape(B, C, cfg.num_heads
                                       * cfg.resolved_head_dim)
    return out @ params["wo"]
