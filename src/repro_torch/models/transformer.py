"""Decoder-only transformer LM, dense, MoE or VLM backbone (PyTorch twin
of ``src/repro/models/transformer.py``): the training loss (``loss_fn``),
the single-shot prefill into the dense per-slot cache (``prefill``, with a
VLM's projected patch embeddings as a prompt prefix), and chunked prefill
and decode over the paged KV pool or the dense per-slot cache.  An MoE
block (``cfg.moe``) runs ``models/moe.py::apply_moe`` in place of the
SwiGLU MLP; its aux loss is summed in training and dropped in serving, as
in the reference.

Params are nested dicts: ``{"embed", "final_norm", ["lm_head"],
["vision_proj"], "blocks": [per-layer dict, ...]}`` (a block holds
``"moe"`` in place of ``"mlp"`` for an MoE model) — one dict per layer
instead of the reference's leaves stacked on a leading ``layers`` axis
for ``lax.scan`` (the forward
is a Python loop over layers; ``models/convert.py`` unstacks reference
params).  The KV cache stacks each layer's leaves (``models/attention.py``)
on a leading ``layers`` axis — ``{"k", "v"}`` plus ``{"k_scale",
"v_scale"}`` for int8 KV — and is updated in place.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.local import complete_grad, whole
from repro_torch.models import attention, layers, moe as moe_lib


def init_block(gen: torch.Generator, cfg, dtype: torch.dtype,
               device: torch.device):
    p = {
        "attn_norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "attn": attention.init_attention(gen, cfg, dtype, device),
        "mlp_norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = layers.init_swiglu_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                          device)
    return p


def block_param_axes(cfg):
    """Logical sharding axes of one ``init_block`` dict."""
    p = {
        "attn_norm": ("embed",),
        "attn": attention.attention_param_axes(cfg),
        "mlp_norm": ("embed",),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_param_axes(cfg)
    else:
        p["mlp"] = {"gate": ("embed", "ff"), "up": ("embed", "ff"),
                    "down": ("ff", "embed")}
    return p


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
    if cfg.vision is not None:
        in_dim = cfg.vision.patch_embed_dim or cfg.d_model
        p["vision_proj"] = layers.dense_init(gen, in_dim, cfg.d_model, dtype,
                                             device)
    return p


def lm_param_axes(cfg):
    """Logical sharding axes of ``init_lm``'s tree, one block dict per
    layer (a per-layer leaf has no ``layers`` dimension, where the
    reference's stacked leaves leave theirs unnamed)."""
    ax = {
        "embed": ("vocab", "embed"),
        "blocks": [block_param_axes(cfg) for _ in range(cfg.num_layers)],
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed", "vocab")
    if cfg.vision is not None:
        ax["vision_proj"] = ("embed", "embed_in")
    return ax


def init_paged_cache(cfg, num_blocks: int, block_size: int,
                     dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Stacked per-layer page pools: (layers, num_blocks + 1, KVH,
    block_size, D) for k and v (page ``num_blocks`` is the write sink, see
    ``models/attention.py``), int8 with (layers, num_blocks + 1, KVH,
    block_size) scale pools when ``cfg.kv_quant``."""
    shape = (cfg.num_layers,) + attention.paged_kv_shape(cfg, num_blocks,
                                                         block_size)
    return attention.kv_buffers(cfg, shape, dtype, device)


def init_cache(cfg, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Stacked per-layer dense caches: (layers, batch, KVH, cache_len, D)
    for k and v, int8 with (layers, batch, KVH, cache_len) scales when
    ``cfg.kv_quant``, the reference's shapes."""
    shape = (cfg.num_layers,) + attention.dense_kv_shape(cfg, batch, max_seq)
    return attention.kv_buffers(cfg, shape, dtype, device)


def _ffn(cfg, bp, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's feed-forward: the MoE layer (out, aux) or the SwiGLU
    MLP (out, None)."""
    if cfg.moe is not None:
        return moe_lib.apply_moe(bp["moe"], cfg, h)
    return layers.swiglu_mlp(bp["mlp"], h), None


def _sub_block_input(h: torch.Tensor) -> torch.Tensor:
    """A sub-block's normed input on a mesh (plain tensors pass as they
    are): whole over the sequence, where ``shard_activations_seq`` splits
    the residual there, gathered once here rather than by each
    projection; and its gradient completed once (``complete_grad``), the
    projections' partial sums over "model" summed first.  (Split on the
    sequence, the gather's backward reduce-scatters it onto the split.)"""
    return whole(complete_grad(h), 1)


def _block_train(cfg, x: torch.Tensor, positions: torch.Tensor,
                 bp) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of the training forward, each sub-block's normed input
    made ready for the mesh by ``_sub_block_input``."""
    h = _sub_block_input(layers.rms_norm(x, bp["attn_norm"],
                                         cfg.rms_norm_eps))
    x = x + attention.attend_train(bp["attn"], cfg, h, positions)
    h = _sub_block_input(layers.rms_norm(x, bp["mlp_norm"],
                                         cfg.rms_norm_eps))
    out, aux = _ffn(cfg, bp, h)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def _seq_shard(cfg, x: torch.Tensor) -> torch.Tensor:
    """With ``cfg.shard_activations_seq``, the residual stream between
    blocks sharded on the sequence over the mesh's ``"model"`` axis (the
    reference's lever: the saved remat residuals shrink by the TP degree):
    a DTensor ``x`` is redistributed to Shard(1) on that axis, its other
    axes' placements kept.  Activations on no such mesh raise, as the
    reference's constraint does outside a mesh."""
    if not cfg.shard_activations_seq:
        return x
    mesh = getattr(x, "device_mesh", None)
    names = mesh.mesh_dim_names or () if mesh is not None else ()
    if "model" not in names:
        raise RuntimeError(
            "shard_activations_seq requires a non-empty mesh with a 'model' "
            "axis: the activations are not DTensors on one (place the "
            "params with distributed/sharding.py)")
    from torch.distributed.tensor import Shard
    placements = list(x.placements)
    placements[names.index("model")] = Shard(1)
    return x.redistribute(mesh, placements)


def forward_train(params, cfg, x_embeds: torch.Tensor,
                  positions: torch.Tensor, *, remat: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_embeds: (B, L, d) -> (hidden (B, L, d), total_aux_loss).

    A Python loop over the per-layer dicts takes the place of the
    reference's ``lax.scan``; with ``remat`` each block runs under
    ``torch.utils.checkpoint``, which keeps only its input and reruns its
    forward in the backward pass (the reference's ``jax.checkpoint``).  The
    aux loss is the MoE layers' sum (0 for a dense model)."""
    x = _seq_shard(cfg, x_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in params["blocks"]:
        x, a = layers.remat_call(remat, _block_train, cfg, x, positions, bp)
        x = _seq_shard(cfg, x)
        aux = aux + a
    # the unembedding's input, as a sub-block's
    return _sub_block_input(layers.rms_norm(x, params["final_norm"],
                                            cfg.rms_norm_eps)), aux


def embed_vlm(params, cfg, tokens: torch.Tensor,
              patch_embeds: torch.Tensor) -> torch.Tensor:
    """VLM input: precomputed patch embeddings (the vision frontend is a
    stub) projected and prepended to the token embeddings."""
    tok = layers.embed_tokens(params, tokens)
    patches = patch_embeds @ params["vision_proj"]
    return torch.cat([patches.to(tok.dtype), tok], dim=1)


def loss_fn(params, cfg, batch: Dict[str, torch.Tensor], *,
            remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy plus the MoE aux loss, ``ce +
    aux_loss_weight * aux / num_layers``.  batch: {"tokens": (B, S+1)
    integer[, "patch_embeds": (B, P, d_in)]}; a VLM's patch prefix is
    dropped before the loss.  Returns (loss, {"ce", "aux"}), 0-dim f32
    tensors."""
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.vision is not None:
        x = embed_vlm(params, cfg, inputs, batch["patch_embeds"])
        n_prefix = x.shape[1] - inputs.shape[1]
    else:
        x = layers.embed_tokens(params, inputs)
        n_prefix = 0
    L = x.shape[1]
    positions = torch.arange(L, device=x.device)[None, :]
    hidden, aux = forward_train(params, cfg, x, positions, remat=remat)
    hidden = hidden[:, n_prefix:]
    ce = layers.next_token_ce(layers.unembed(params, cfg, hidden).float(),
                              targets)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    total = ce + aux_w * aux / max(cfg.num_layers, 1)
    return total, {"ce": ce, "aux": aux}


def _layer_caches(cache: Dict[str, torch.Tensor]
                  ) -> List[Dict[str, torch.Tensor]]:
    """One dict of views per layer, over every leaf of the stacked cache."""
    n = next(iter(cache.values())).shape[0]
    return [{name: leaf[i] for name, leaf in cache.items()} for i in range(n)]


def _forward(params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
             attend: Callable) -> torch.Tensor:
    """Every block over x; ``attend(attn_params, h, layer_cache)`` is the
    attention of one layer.  Returns the final-normed hidden states."""
    for bp, layer in zip(params["blocks"], _layer_caches(cache)):
        h = layers.rms_norm(x, bp["attn_norm"], cfg.rms_norm_eps)
        x = x + attend(bp["attn"], h, layer)
        h = layers.rms_norm(x, bp["mlp_norm"], cfg.rms_norm_eps)
        x = x + _ffn(cfg, bp, h)[0]
    return layers.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def prefill(params, cfg, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor],
            patch_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-shot prefill of whole prompts from position 0.  tokens: (B,
    L); ``cache``: a dense per-slot cache of batch B (``init_cache``); a
    VLM takes ``patch_embeds`` (B, P, d_in), whose projections fill cache
    positions 0..P-1 ahead of the text.  Returns (the last position's
    logits (B, V), the cache filled in place)."""
    if cfg.vision is not None:
        if patch_embeds is None:
            raise ValueError(f"{cfg.name} needs patch_embeds to prefill")
        x = embed_vlm(params, cfg, tokens, patch_embeds)
    else:
        x = layers.embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _forward(params, cfg, x, cache,
                 lambda ap, h, layer: attention.attend_prefill(
                     ap, cfg, h, positions, layer))
    return layers.unembed(params, cfg, x[:, -1]), cache


def _chunk(params, cfg, tokens: torch.Tensor, starts: torch.Tensor,
           valid: torch.Tensor, cache: Dict[str, torch.Tensor],
           attend: Callable) -> torch.Tensor:
    """One prefill chunk; ``attend(attn_params, h, positions, layer_cache)``.
    Returns the logits at each row's last valid position (B, V)."""
    x = layers.embed_tokens(params, tokens)
    B, C, _ = x.shape
    positions = starts[:, None] + torch.arange(C, dtype=torch.int32,
                                               device=x.device)[None, :]
    x = _forward(params, cfg, x, cache,
                 lambda ap, h, layer: attend(ap, h, positions, layer))
    last = torch.clamp(valid.long() - 1, 0, C - 1)
    return layers.unembed(params, cfg, x[torch.arange(B, device=x.device),
                                         last])


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
    return _chunk(params, cfg, tokens, starts, valid, cache,
                  lambda ap, h, positions, pool:
                  attention.attend_prefill_chunk_paged(
                      ap, cfg, h, positions, valid, block_table, pool)), cache


def decode_step_paged(params, cfg, tokens: torch.Tensor,
                      lengths: torch.Tensor, block_table: torch.Tensor,
                      cache: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B,) int32; lengths: (B,) int32 current cache fill per
    sequence; block_table: (B, nb) int32.  Returns (logits (B, V), the
    cache updated in place)."""
    x = _forward(params, cfg, layers.embed_tokens(params, tokens[:, None]),
                 cache, lambda ap, h, pool: attention.attend_decode_paged(
                     ap, cfg, h, lengths, block_table, pool))
    return layers.unembed(params, cfg, x[:, 0]), cache


def prefill_chunk(params, cfg, tokens: torch.Tensor, starts: torch.Tensor,
                  valid: torch.Tensor, cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``prefill_chunk_paged`` against the dense per-slot cache: row b of
    the batch is slot b of the cache."""
    return _chunk(params, cfg, tokens, starts, valid, cache,
                  lambda ap, h, positions, layer:
                  attention.attend_prefill_chunk(ap, cfg, h, positions, valid,
                                                 layer)), cache


def decode_step(params, cfg, tokens: torch.Tensor, lengths: torch.Tensor,
                cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``decode_step_paged`` against the dense per-slot cache."""
    x = _forward(params, cfg, layers.embed_tokens(params, tokens[:, None]),
                 cache, lambda ap, h, layer: attention.attend_decode(
                     ap, cfg, h, lengths, layer))
    return layers.unembed(params, cfg, x[:, 0]), cache
