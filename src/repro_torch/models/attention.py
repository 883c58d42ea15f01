"""GQA attention (PyTorch twin of ``src/repro/models/attention.py``):
full-sequence training attention (``attend_train``), the single-shot
prefill that also fills a dense cache (``attend_prefill``), and attention
over the KV cache, the paged page pool and the dense per-slot cache, each
in float and with int8 KV (``cfg.kv_quant``).

Caches are dicts of tensors updated in place: ``{"k", "v"}``, plus
``{"k_scale", "v_scale"}`` (one scale per row, in the model's dtype) when
``cfg.kv_quant`` stores k/v as int8 rows (``_quantize_kv``).

**Paged pool** (one layer): ``k``/``v`` ``(num_blocks + 1, KVH,
block_size, D)``: logical position ``p`` of a sequence lives in page
``block_table[p // block_size]`` at row ``p % block_size``.  Page
``num_blocks`` is a write sink: a write aimed at a sentinel page id
(``>= num_blocks``: inactive batch rows, blocks not yet allocated) lands
there instead of being dropped, which keeps the write a single
``index_put_`` with no host sync.  The sink is never read: the kernels see
only ``pool[:num_blocks]`` and clamp sentinel reads into it.  Pages are
written in place BEFORE attention reads the pool: the chunk's writes land
at positions ``>= starts`` while the prefix segment reads only positions
``< starts``, so the attended values equal a pre-write read.

**Dense cache** (one layer): ``k``/``v`` ``(B, KVH, S, D)`` with ``S =
cache_len(cfg, max_seq)``, the reference's shape: column ``s`` holds
position ``s`` (full attention) or the latest position ``p`` with ``p %
S == s`` (rolling sliding-window cache).  A chunk or decode write puts
each token at column ``p % S`` of its row with one ``scatter_`` per leaf
(``_write_dense``).  The writes JAX drops as out of range (inactive
chunk tokens, positions past S under full attention, finished slots
idling at ``lengths == S`` in a decode burst) write back the value their
column held, gathered before the write: their column ``p % S`` is one no
kept write of the row takes, since a row's C writes fall on C distinct
columns while ``C <= S`` (checked), so no scatter sees a duplicate
index.  On a mesh that shards ``kv_seq`` each shard writes the columns
it owns and writes back the rest, as GSPMD partitions the reference's
``.at[...].set(mode="drop")``; the single-shot prefill replaces every
column with one ``copy_``.  A rolling chunk step may overwrite slots its
own queries still attend, so it reads the cache BEFORE the write (the
reference's functional read); full attention reads after it, as the
paged pool does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

import math

from repro_torch.distributed.local import (complete, localize,
                                          shard_span, whole)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_quant)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_quant)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_quant)
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


def attention_param_axes(cfg) -> Dict[str, Tuple[str, ...]]:
    """Logical sharding axes per leaf of ``init_attention``'s dict (the
    reference's ``attention_param_axes``)."""
    p = {
        "wq": ("embed", "heads_x_dim"),
        "wk": ("embed", "kv_heads_x_dim"),
        "wv": ("embed", "kv_heads_x_dim"),
        "wo": ("heads_x_dim", "embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads_x_dim",)
        p["bk"] = ("kv_heads_x_dim",)
        p["bv"] = ("kv_heads_x_dim",)
    return p


def paged_kv_shape(cfg, num_blocks: int, block_size: int) -> Tuple[int, ...]:
    """Shape of one layer's k (or v) page pool: ``num_blocks`` pages plus
    the write sink."""
    return (num_blocks + 1, cfg.num_kv_heads, block_size,
            cfg.resolved_head_dim)


def cache_len(cfg, max_seq: int) -> int:
    """Materialized dense cache length: rolling window for SWA, else
    max_seq."""
    if cfg.sliding_window is not None:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def dense_kv_shape(cfg, batch: int, max_seq: int) -> Tuple[int, ...]:
    """Shape of one layer's dense k (or v) cache: ``cache_len`` columns
    per sequence, as the reference's ``init_kv_cache``."""
    return (batch, cfg.num_kv_heads, cache_len(cfg, max_seq),
            cfg.resolved_head_dim)


def kv_buffers(cfg, shape: Tuple[int, ...], dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeroed cache leaves for k/v rows of ``shape`` (..., D): ``dtype``
    rows, or int8 rows with ``dtype`` scales of ``shape[:-1]`` when
    ``cfg.kv_quant``."""
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=dtype,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=dtype,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 values, per-row scale in x's dtype), bit for bit
    the reference's: f32 amax, scale floored at 1e-8, round half to even,
    clip to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(x.dtype)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def _cuts(x: torch.Tensor, dim: int, groups: int) -> bool:
    """Whether ``x`` is a DTensor whose mesh axes split dimension ``dim``
    into pieces that cut ``groups`` equal groups of it (their sizes
    multiply to no divisor of ``groups``): a view that splits ``dim``
    into the groups then has no sharding, and DTensor's would gather
    every axis, the batch's too."""
    if not isinstance(x, DTensor):
        return False
    pieces = math.prod(x.device_mesh.size(i)
                       for i, p in enumerate(x.placements) if p.is_shard(dim))
    return groups % pieces != 0


def _split_heads(x: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """x (B, L, heads * hd) -> (B, L, heads, hd).  Where the mesh axes
    that split the last dimension cut a head (granite's 8 KV heads,
    qwen3-moe's 4, on 16 "model" shards), those axes alone are gathered
    first (``whole``); where the heads divide, the view splits them."""
    if _cuts(x, x.ndim - 1, heads):
        x = whole(x, x.ndim - 1)
    return x.reshape(*x.shape[:-1], heads, hd)


def _project_qkv(params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x: (B, L, d) -> q (B, L, H, hd), k/v (B, L, KVH, hd), with RoPE."""
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = _split_heads(q, cfg.num_heads, hd)
    k = _split_heads(k, cfg.num_kv_heads, hd)
    v = _split_heads(v, cfg.num_kv_heads, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B, H, Lq, D), k/v: (B, KVH, Lkv, D), GQA by head-group reshape;
    mask broadcastable to (B, 1, Lq, Lkv), True = attend.  Scores and
    softmax in f32, probabilities cast to v's dtype for the value product,
    as the reference's ``_sdpa``.  On a mesh it runs shard-local
    (``_sdpa_local``)."""
    if isinstance(q, DTensor):
        return _sdpa_local(q, k, v, mask)
    B, H, Lq, D = q.shape
    KVH = k.shape[1]
    qg = q.reshape(B, KVH, H // KVH, Lq, D)
    scores = torch.matmul(qg.float(), k[:, :, None].float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(D))
    if mask is not None:
        scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v[:, :, None])
    return out.reshape(B, H, Lq, D).to(v.dtype)


def _sdpa_local(q: DTensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor]) -> DTensor:
    """``_sdpa`` on a mesh, on each device's own query heads, as XLA
    splits the reference's heads over KV heads and groups at once
    (``distributed/local.py``): k and v follow q's batch split, and its
    head split where that keeps whole KV heads; where the mesh axes that
    split q's heads cut a KV head's group of them (qwen3-moe's 8 query
    heads a KV head on 16 "model" shards), k and v are whole over those
    axes (``_split_heads`` has gathered them there) and each device takes
    the KV heads its query heads belong to.  The output keeps q's split:
    no query is gathered and the output's gradient needs no reduction.
    Where k and v are whole over an axis that splits q, they serve this
    device's queries alone, and their gradients are partial sums there,
    reduced where the k/v split's gather is undone.  (DTensor's own group
    view and its batched products fall back under some torch versions.)"""
    mesh, pl = q.device_mesh, q.placements
    group = q.shape[1] // k.shape[1]
    cut = _cuts(q, 1, k.shape[1])
    kv_pl = [p if p.is_shard(0) or (p.is_shard(1) and not cut)
             else Replicate() for p in pl]
    grad_pl = [Partial() if p.is_shard() and not r.is_shard() else r
               for p, r in zip(pl, kv_pl)]
    k, v = (localize(t, mesh, kv_pl, grad_pl) for t in (k, v))
    if mask is not None:        # q's batch and query splits where it has them
        mask = localize(mask, mesh, [
            p if p.is_shard() and p.dim in (0, 2) and mask.shape[p.dim] > 1
            else Replicate() for p in pl])
    if cut:
        first, n = shard_span(q, 1)
        kv = first // group
        if kv == (first + n - 1) // group:  # heads of one KV head's group
            k, v = k[:, kv:kv + 1], v[:, kv:kv + 1]
        else:                               # each query head's KV head
            kv = torch.arange(first, first + n, device=k.device) // group
            k, v = k[:, kv], v[:, kv]
    out = _sdpa(localize(q, mesh, pl), k, v, mask)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _sdpa_q_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int],
                    chunk: int) -> torch.Tensor:
    """Query-chunked exact attention: the peak score tensor is (B, KVH,
    group, chunk, Lkv) instead of (B, KVH, group, L, L); chunks run one
    after another, as the reference's ``lax.map``."""
    B, H, L, D = q.shape
    Lkv = k.shape[2]
    if L % chunk:
        raise ValueError(f"sequence {L} is not a multiple of chunk {chunk}")
    outs = []
    for q_off in range(0, L, chunk):
        if window is not None:
            mask = layers.sliding_window_mask(chunk, Lkv, q_off, window,
                                              q.device)[None, None]
        elif causal:
            mask = layers.causal_mask(chunk, Lkv, q_off, q.device)[None, None]
        else:
            mask = None
        outs.append(_sdpa(q[:, :, q_off:q_off + chunk], k, v, mask))
    return torch.cat(outs, dim=2)


def attend_train(params, cfg, x: torch.Tensor, positions: torch.Tensor,
                 *, bidirectional: bool = False) -> torch.Tensor:
    """Full-sequence attention. x: (B, L, d); positions: (1 or B, L).

    Three routes, as the reference's: the flash kernel under
    ``cfg.use_pallas_attention`` (causal, with the model's window); the
    query-chunked path when ``cfg.train_attn_chunk`` divides L and is
    shorter; else ``_sdpa`` with a causal, window or no mask."""
    B, L, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    q = q.transpose(1, 2)                                    # (B, H, L, D)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    chunk = cfg.train_attn_chunk
    if cfg.use_pallas_attention and not bidirectional:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, window=cfg.sliding_window)
    elif chunk is not None and not bidirectional and L % chunk == 0 \
            and L > chunk:
        out = _sdpa_q_chunked(q, k, v, causal=True,
                              window=cfg.sliding_window, chunk=chunk)
    else:
        if bidirectional:
            mask = None
        elif cfg.sliding_window is not None:
            mask = layers.sliding_window_mask(L, L, 0, cfg.sliding_window,
                                              x.device)[None, None]
        else:
            mask = layers.causal_mask(L, L, 0, x.device)[None, None]
        out = _sdpa(q, k, v, mask)
    out = out.transpose(1, 2).reshape(B, L, cfg.num_heads
                                      * cfg.resolved_head_dim)
    return complete(out @ params["wo"])


def attend_prefill(params, cfg, x: torch.Tensor, positions: torch.Tensor,
                   cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Causal (or sliding-window) attention over a whole prompt that starts
    at position 0, filling the dense per-slot ``cache`` in place.

    x: (B, L, d); positions: (1 or B, L), ``[0, L)``.  The attention is
    ``_sdpa`` over the prompt, as the reference computes it outside any
    kernel.  Every one of the cache's S = ``cache_len`` columns is
    replaced, as the reference builds a new cache: position p at column
    p, the rest zeroed (the prompt fits, L <= S); a rolling window shorter
    than the prompt keeps the last S positions, position p at column
    ``p % S``.  Returns (B, L, d).
    """
    B, L, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)  # k/v: (B, L, KVH, hd)
    if cfg.sliding_window is not None:
        mask = layers.sliding_window_mask(L, L, 0, cfg.sliding_window,
                                          x.device)[None, None]
    else:
        mask = layers.causal_mask(L, L, 0, x.device)[None, None]
    out = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                mask)
    out = out.transpose(1, 2).reshape(B, L, cfg.num_heads
                                      * cfg.resolved_head_dim)

    S = cache["k"].shape[2]
    if cfg.sliding_window is not None and L > S:
        # the last S positions, each at its rolling column
        _fill_dense(cfg, cache, k[:, L - S:], v[:, L - S:], L % S)
    elif L > S:
        raise ValueError(f"a prompt of {L} tokens does not fit the cache's "
                         f"{S} columns")
    else:
        _fill_dense(cfg, cache, k, v, 0)
    return complete(out @ params["wo"])


def _kv_rows(cfg, k: torch.Tensor, v: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """The values each cache leaf takes for k/v rows: the rows, or int8
    rows and their scales when ``cfg.kv_quant``."""
    if cfg.kv_quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def _fill_dense(cfg, cache: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, shift: int) -> None:
    """Replace every column of the dense per-slot cache, in place: row i
    of k/v (B, n, KVH, D), n <= S, at column ``(i + shift) % S``, columns
    n and on zero (int8 rows and their scales quantized first, then
    padded with zeros, as the reference pads).  One ``copy_`` per leaf,
    which a DTensor cache takes shard by shard."""
    for name, val in _kv_rows(cfg, k, v).items():
        leaf = cache[name]
        val = val.transpose(1, 2).to(leaf.dtype)          # (B, KVH, n[, D])
        pad = leaf.shape[2] - val.shape[2]
        if pad:
            val = torch.cat([val, torch.zeros_like(val[:, :, :1]).expand(
                *val.shape[:2], pad, *val.shape[3:])], dim=2)
        if shift:
            val = torch.cat([val[:, :, -shift:], val[:, :, :-shift]], dim=2)
        leaf.copy_(val)


def _write_dense(cfg, cache: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, positions: torch.Tensor,
                 keep: Optional[torch.Tensor]) -> None:
    """Write per-token k/v (B, n, KVH, D) of ``positions`` (B, n) into the
    dense per-slot cache, in place, quantizing first for int8 leaves:
    each token at column ``positions % S`` of its row where ``keep`` (B,
    n) holds (None: everywhere), the column's own value written back
    where it does not.

    A row's n columns are distinct while ``n <= S`` (n consecutive
    positions modulo S), so a dropped write's column is one no kept write
    of its row takes, and writing its old value back leaves it as it was:
    the drop costs a gather and a select a leaf, and the scatter sees no
    duplicate index (torch leaves the winner of duplicates undefined).
    The columns are worked out once for every leaf; a DTensor cache
    writes each shard's own (``_write_shard``)."""
    rows = _kv_rows(cfg, k, v)
    if isinstance(cache["k"], DTensor):
        for name, val in rows.items():
            _write_shard(cache[name], val.transpose(1, 2), positions, keep)
        return
    S = cache["k"].shape[2]
    col, keep = _columns(positions, keep, S, S, 0)
    for name, val in rows.items():
        leaf = cache[name]
        _scatter_columns(leaf, val.transpose(1, 2).to(leaf.dtype), col, keep)


def _columns(positions: torch.Tensor, keep: Optional[torch.Tensor], S: int,
             S_local: int, first: int
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The column (B, n) int64 among the ``S_local`` held here (from
    ``first`` of S) that each write takes, and where it lands (None:
    everywhere).  Off a mesh ``S_local == S``; on one, a write lands
    where the shard owns its column ``positions % S``, and every column
    is ``positions % S_local``, distinct within a row while ``n <=
    S_local`` (``S_local`` divides S and ``first`` is a multiple of it)."""
    n = positions.shape[1]
    if n > S_local:
        raise ValueError(
            f"{n} writes a row need C <= S: a chunk of {n} tokens would put "
            f"two of them in one of the cache's {S_local} columns"
            + (" on a shard" if S_local != S else ""))
    if S_local != S:
        col = torch.remainder(positions, S)
        own = (col >= first) & (col < first + S_local)
        keep = own if keep is None else keep & own
    return torch.remainder(positions, S_local).long(), keep


def _scatter_columns(leaf: torch.Tensor, val: torch.Tensor, col: torch.Tensor,
                     keep: Optional[torch.Tensor]) -> None:
    """``val`` (B, KVH, n[, D]) into ``leaf`` (B, KVH, S[, D]) at ``col``
    (B, n) of each row, the old value where ``keep`` does not hold."""
    idx = col[:, None, :]
    if val.dim() == 4:
        idx = idx[..., None]
    idx = idx.expand(val.shape)
    if keep is not None:
        keep = keep[:, None, :, None] if val.dim() == 4 else keep[:, None]
        val = torch.where(keep, val, leaf.gather(2, idx))
    leaf.scatter_(2, idx, val)


def _write_shard(leaf: DTensor, val: torch.Tensor, positions: torch.Tensor,
                 keep: Optional[torch.Tensor]) -> None:
    """``_write_dense`` of one DTensor leaf, on this rank's shard
    (``distributed/local.py``): ``val`` (B, KVH, n[, D]) with the leaf's
    rows and heads and all n columns, ``positions``/``keep`` with its
    rows; a write lands where the shard owns its column.  No gather of
    the cache and no fallback, as GSPMD partitions the reference's
    ``.at[...].set(mode="drop")``."""
    mesh, pl = leaf.device_mesh, leaf.placements
    first, S_local = shard_span(leaf, 2)
    val = localize(val, mesh, [Replicate() if p.is_shard(2) else p
                               for p in pl]).to(leaf.dtype)
    rows = [p if p.is_shard(0) else Replicate() for p in pl]
    positions = localize(positions, mesh, rows)
    if keep is not None:
        keep = localize(keep, mesh, rows)
    col, keep = _columns(positions, keep, leaf.shape[2], S_local, first)
    _scatter_columns(leaf.to_local(), val, col, keep)


def _write_pages(cfg, pool: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, page: torch.Tensor,
                 offset: torch.Tensor) -> None:
    """Scatter per-token k/v (..., KVH, D) into the pool at (page, offset),
    in place, quantizing first for int8 leaves.  ``page``/``offset`` share
    the leading dims of k/v; sentinel page ids (>= num_blocks) are
    redirected to the write sink."""
    sink = pool["k"].shape[0] - 1
    page = torch.clamp(page, max=sink).long()
    offset = offset.long()
    for name, val in _kv_rows(cfg, k, v).items():
        pool[name][page, :, offset] = val.to(pool[name].dtype)


def _live_pages(cfg, pool: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The pool without its sink page, as the kernels take it: (k, v) or
    (k, v, k_scale, v_scale)."""
    n = pool["k"].shape[0] - 1
    names = ("k", "v", "k_scale", "v_scale") if cfg.kv_quant else ("k", "v")
    return tuple(pool[name][:n] for name in names)


def attend_decode_paged(params, cfg, x: torch.Tensor, lengths: torch.Tensor,
                        block_table: torch.Tensor,
                        pool: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One-token decode against the paged KV pool (full attention).

    x: (B, 1, d); lengths: (B,) int32 tokens already cached (= the new
    token's position); block_table: (B, nb) int32.  The new token's k/v is
    written at page ``block_table[b, pos // bs]`` row ``pos % bs`` (to the
    sink when that block is unallocated) before the kernel (its int8 twin
    for an int8 pool) attends the inclusive ``lengths + 1`` tokens.
    Returns (B, 1, d).
    """
    B = x.shape[0]
    num_blocks, bs = pool["k"].shape[0] - 1, pool["k"].shape[2]
    nb = block_table.shape[1]
    q, k, v = _project_qkv(params, cfg, x, lengths[:, None])
    logical = lengths // bs
    page = torch.gather(block_table, 1,
                        logical.clamp(max=nb - 1)[:, None].long())[:, 0]
    page = torch.where(logical < nb, page, num_blocks)
    _write_pages(cfg, pool, k[:, 0], v[:, 0], page, lengths % bs)
    kernel = paged_decode_attention_quant if cfg.kv_quant \
        else paged_decode_attention
    attn = kernel(q[:, 0].contiguous(), *_live_pages(cfg, pool), block_table,
                  lengths + 1)
    out = attn.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim)
    return complete(out @ params["wo"])


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
    _write_pages(cfg, pool, k, v, page, positions % bs)
    # the chunk's own keys are the fresh float projections, never a
    # read-back of (int8) pages
    kernel = paged_prefill_attention_quant if cfg.kv_quant \
        else paged_prefill_attention
    attn = kernel(
        q.transpose(1, 2).contiguous(), *_live_pages(cfg, pool),
        k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        block_table, positions[:, 0].to(torch.int32).contiguous(), valid)
    out = attn.transpose(1, 2).reshape(B, C, cfg.num_heads
                                       * cfg.resolved_head_dim)
    return complete(out @ params["wo"])


# ---------------------------------------------------------------------------
# dense per-slot cache
# ---------------------------------------------------------------------------

def _read_dense(cfg, cache: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's k/v (B, KVH, S, D): the leaves of a float cache, or int8
    rows dequantized to ``dtype`` (the reference's non-kernel paths cast to
    the activations' dtype)."""
    if cfg.kv_quant:
        return (_dequantize_kv(cache["k"], cache["k_scale"], dtype),
                _dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def attend_prefill_chunk(params, cfg, x: torch.Tensor,
                         positions: torch.Tensor, valid: torch.Tensor,
                         cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One prefill chunk per row against the dense per-slot cache.

    x: (B, C, d) right-padded chunk; positions: (B, C) absolute positions
    (row b starts at ``starts[b] = positions[b, 0]``); valid: (B,) real
    tokens per row (0 = inactive: no writes, output ignored).  The chunk's
    k/v are written at their slots (``pos % S`` for a rolling SWA cache;
    inactive tokens and, under full attention, positions past S dropped,
    as JAX drops them; ``C <= S``); attention runs over two segments, the
    pre-chunk cache and the chunk's own fresh keys, with the reference's
    masks.  A rolling
    cache is read before the write (the chunk may overwrite slots its
    queries still attend); full attention after it (its writes land at
    slots the cache segment masks).  Returns (B, C, d).
    """
    B, C, _ = x.shape
    S = cache["k"].shape[2]
    swa = cfg.sliding_window is not None
    q, k, v = _project_qkv(params, cfg, x, positions)  # k/v: (B, C, KVH, hd)
    starts = positions[:, 0]
    qh = q.transpose(1, 2)                                       # (B, H, C, hd)
    kh = k.transpose(1, 2)                                       # (B, KVH, C, hd)
    vh = v.transpose(1, 2)

    def both_segments():
        old_k, old_v = _read_dense(cfg, cache, x.dtype)
        return torch.cat([old_k, kh], dim=2), torch.cat([old_v, vh], dim=2)

    in_chunk = torch.arange(C, device=x.device)[None, :] < valid[:, None]
    keep = in_chunk if swa else in_chunk & (positions < S)
    if swa:
        k_all, v_all = both_segments()                # the pre-write cache
    _write_dense(cfg, cache, k, v, positions, keep)
    if not swa:
        k_all, v_all = both_segments()

    q_pos = positions[:, :, None]                                # (B, C, 1)
    s_idx = torch.arange(S, device=x.device)[None, None, :]      # (1, 1, S)
    if swa:
        # slot s of the pre-chunk cache holds the largest position
        # p <= start - 1 with p % S == s (negative: never written)
        prev = (starts - 1)[:, None, None]
        p_s = prev - torch.remainder(prev - s_idx, S)
        cache_mask = (p_s >= 0) & (p_s > q_pos - cfg.sliding_window)
    else:
        cache_mask = (s_idx < starts[:, None, None]).expand(B, C, S)
    j_idx = torch.arange(C, device=x.device)[None, None, :]
    p_j = starts[:, None, None] + j_idx
    chunk_mask = (p_j <= q_pos) & (j_idx < valid[:, None, None])
    if swa:
        chunk_mask = chunk_mask & (p_j > q_pos - cfg.sliding_window)
    mask = torch.cat([cache_mask, chunk_mask], dim=-1)[:, None]

    out = _sdpa(qh, k_all, v_all, mask)
    out = out.transpose(1, 2).reshape(B, C, cfg.num_heads
                                      * cfg.resolved_head_dim)
    return complete(out @ params["wo"])


def attend_decode(params, cfg, x: torch.Tensor, lengths: torch.Tensor,
                  cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One-token decode against the dense per-slot cache.

    x: (B, 1, d); lengths: (B,) int32 tokens already cached (= the new
    token's position).  The new token's k/v is written at slot ``lengths``
    (``lengths % S`` rolling; dropped at ``lengths >= S`` under full
    attention, as JAX drops it: a finished slot idling in a burst), then
    full attention runs the dense decode kernel (its int8 twin for an int8
    cache) over the inclusive ``lengths + 1`` rows, and a rolling SWA cache
    masks slots by the position they hold, in plain ops, as the reference
    does outside Pallas.  Returns (B, 1, d).
    """
    B = x.shape[0]
    S = cache["k"].shape[2]
    q, k, v = _project_qkv(params, cfg, x, lengths[:, None])
    swa = cfg.sliding_window is not None
    _write_dense(cfg, cache, k, v, lengths[:, None],
                 None if swa else (lengths < S)[:, None])
    if not swa:
        # a finished slot idling in a burst sits at lengths == S: its
        # count clamps to the S columns (the reference's mask passes them)
        kv_valid = torch.clamp(lengths + 1, max=S)
        q1 = q[:, 0].contiguous()
        if cfg.kv_quant:
            attn = decode_attention_quant(q1, cache["k"], cache["v"],
                                          cache["k_scale"], cache["v_scale"],
                                          kv_valid)
        else:
            attn = decode_attention(q1, cache["k"], cache["v"], kv_valid)
    else:
        kv_pos = torch.arange(S, device=x.device)[None, :]
        held = lengths[:, None] - torch.remainder(lengths[:, None] - kv_pos, S)
        live = (held >= 0) & (held >= lengths[:, None] - (S - 1))
        k_all, v_all = _read_dense(cfg, cache, x.dtype)
        attn = _sdpa(q.transpose(1, 2), k_all, v_all,
                     live[:, None, None, :])[:, :, 0]
    out = attn.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim)
    return complete(out @ params["wo"])
