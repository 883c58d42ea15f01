"""Dense decoder-only transformer LM over the paged KV pool (PyTorch twin of
the paged serving subset of ``src/repro/models/transformer.py``).

Params are nested dicts: ``{"embed", "final_norm", ["lm_head"], "blocks":
[per-layer dict, ...]}`` — one dict per layer instead of the reference's
leaves stacked on a leading ``layers`` axis for ``lax.scan`` (the forward
is a Python loop over layers; ``models/convert.py`` unstacks reference
params).  The KV cache is ``{"k", "v"}`` of shape (layers, num_blocks + 1,
KVH, block_size, D) and is updated in place.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.models import attention, layers


def init_block(gen: torch.Generator, cfg, dtype: torch.dtype,
               device: torch.device):
    return {
        "attn_norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "attn": attention.init_attention(gen, cfg, dtype, device),
        "mlp_norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "mlp": layers.init_swiglu_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                      device),
    }


def init_lm(gen: torch.Generator, cfg, dtype: torch.dtype,
            device: torch.device):
    """Random weights drawn on ``device`` from ``gen`` (a generator of that
    device), at the reference's scales (``src/repro/models/layers.py``)."""
    p = {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                   device),
        "blocks": [init_block(gen, cfg, dtype, device)
                   for _ in range(cfg.num_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         dtype, device)
    return p


def init_paged_cache(cfg, num_blocks: int, block_size: int,
                     dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Stacked per-layer page pools: (layers, num_blocks + 1, KVH,
    block_size, D) each for k and v (page ``num_blocks`` is the write
    sink, see ``models/attention.py``)."""
    shape = (cfg.num_layers,) + attention.paged_kv_shape(cfg, num_blocks,
                                                         block_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _layer_pools(cache: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    return [{"k": k, "v": v} for k, v in zip(cache["k"], cache["v"])]


def _block(cfg, x: torch.Tensor, bp, attend) -> torch.Tensor:
    h = layers.rms_norm(x, bp["attn_norm"], cfg.rms_norm_eps)
    x = x + attend(bp["attn"], h)
    h = layers.rms_norm(x, bp["mlp_norm"], cfg.rms_norm_eps)
    return x + layers.swiglu_mlp(bp["mlp"], h)


def prefill_chunk_paged(params, cfg, tokens: torch.Tensor,
                        starts: torch.Tensor, valid: torch.Tensor,
                        block_table: torch.Tensor,
                        cache: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunk of a chunked prefill over a continuous batch.

    tokens: (B, C) right-padded chunk tokens; starts: (B,) int32 tokens
    already cached; valid: (B,) int32 real tokens per row (0 = inactive
    row); block_table: (B, nb) int32.  Returns (logits at each row's last
    valid position (B, V), the cache updated in place) — the logits mean
    something only for rows whose chunk ends their prompt.
    """
    x = layers.embed_tokens(params, tokens)
    B, C, _ = x.shape
    positions = starts[:, None] + torch.arange(C, dtype=torch.int32,
                                               device=x.device)[None, :]
    for bp, pool in zip(params["blocks"], _layer_pools(cache)):
        x = _block(cfg, x, bp, lambda ap, h: attention.attend_prefill_chunk_paged(
            ap, cfg, h, positions, valid, block_table, pool))
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = torch.clamp(valid.long() - 1, 0, C - 1)
    x_last = x[torch.arange(B, device=x.device), last]
    return layers.unembed(params, cfg, x_last), cache


def decode_step_paged(params, cfg, tokens: torch.Tensor,
                      lengths: torch.Tensor, block_table: torch.Tensor,
                      cache: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B,) int32; lengths: (B,) int32 current cache fill per
    sequence; block_table: (B, nb) int32.  Returns (logits (B, V), the
    cache updated in place)."""
    x = layers.embed_tokens(params, tokens[:, None])
    for bp, pool in zip(params["blocks"], _layer_pools(cache)):
        x = _block(cfg, x, bp, lambda ap, h: attention.attend_decode_paged(
            ap, cfg, h, lengths, block_table, pool))
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return layers.unembed(params, cfg, x[:, 0]), cache
