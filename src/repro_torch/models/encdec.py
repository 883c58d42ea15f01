"""Whisper-style encoder-decoder, whisper-medium (PyTorch twin of
``src/repro/models/encdec.py``).  [arXiv:2212.04356]

The conv/mel frontend is a stub, as in the reference: callers give
precomputed frame embeddings (B, num_frames, d_model).  The encoder's
blocks are bidirectional (sinusoidal positions added to the frames); the
decoder's blocks are causal self-attention with a KV cache, then
cross-attention to the encoder's output, then a GELU MLP; every norm is a
layer norm.  As in the reference, the decoder uses RoPE instead of
whisper's learned positions.

Params are ``{"embed", "enc_blocks": [...], "enc_final_s", "enc_final_b",
"dec_blocks": [...], "final_s", "final_b"}``, one dict per layer
(``models/convert.py`` unstacks the reference's two stacks; the encoder
has ``cfg.encoder.num_layers``, the decoder ``cfg.num_layers``).  The
cache is ``{"self": {"k", "v"[, "k_scale", "v_scale"]}, "cross_k",
"cross_v"}``: the decoder's dense per-slot self-attention caches
(``models/attention.py``) and each layer's cross K/V (layers, B, KVH,
num_frames, D), all updated in place.

The encoder and the cross-attention run plain ``_sdpa``, as the reference
runs jnp outside any kernel; the decoder's self-attention decode runs the
dense decode kernel (its int8 twin for ``cfg.kv_quant``), and in training
its ``attend_train`` runs the flash kernel under
``cfg.use_pallas_attention``.  The training loss encodes the frames once,
outside any remat boundary, and makes each decoder layer, its cross K/V
included, a remat boundary, as the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed.local import complete
from repro_torch.models import attention, layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm(cfg, dtype, device, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}_s": torch.ones(cfg.d_model, dtype=dtype, device=device),
            f"{prefix}_b": torch.zeros(cfg.d_model, dtype=dtype,
                                       device=device)}


def _init_cross_attn(gen, cfg, dtype, device) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": layers.dense_init(gen, d, cfg.num_heads * hd, dtype, device),
        "wk": layers.dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wv": layers.dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wo": layers.dense_init(gen, cfg.num_heads * hd, d, dtype, device),
    }


def init_enc_block(gen, cfg, dtype, device):
    return {
        **_norm(cfg, dtype, device, "attn_norm"),
        "attn": attention.init_attention(gen, cfg, dtype, device),
        **_norm(cfg, dtype, device, "mlp_norm"),
        "mlp": layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                    device),
    }


def init_dec_block(gen, cfg, dtype, device):
    return {
        **_norm(cfg, dtype, device, "self_norm"),
        "self_attn": attention.init_attention(gen, cfg, dtype, device),
        **_norm(cfg, dtype, device, "cross_norm"),
        "cross_attn": _init_cross_attn(gen, cfg, dtype, device),
        **_norm(cfg, dtype, device, "mlp_norm"),
        "mlp": layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                    device),
    }


def init_encdec_lm(gen: torch.Generator, cfg, dtype: torch.dtype,
                   device: torch.device):
    """Random weights drawn on ``device`` from ``gen`` (a generator of that
    device), at the reference's scales."""
    return {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                   device),
        "enc_blocks": [init_enc_block(gen, cfg, dtype, device)
                       for _ in range(cfg.encoder.num_layers)],
        **_norm(cfg, dtype, device, "enc_final"),
        "dec_blocks": [init_dec_block(gen, cfg, dtype, device)
                       for _ in range(cfg.num_layers)],
        **_norm(cfg, dtype, device, "final"),
    }


# ---------------------------------------------------------------------------
# encoder and cross attention
# ---------------------------------------------------------------------------

def _ln(cfg, x: torch.Tensor, p, prefix: str) -> torch.Tensor:
    return layers.layer_norm(x, p[f"{prefix}_s"], p[f"{prefix}_b"],
                             cfg.rms_norm_eps)


def encdec_param_axes(cfg):
    """Logical sharding axes of ``init_encdec_lm``'s tree, one block dict
    per encoder and decoder layer."""
    attn_ax = attention.attention_param_axes(cfg)
    mlp_ax = {"fc1": ("embed", "ff"), "b1": ("ff",),
              "fc2": ("ff", "embed"), "b2": ("embed",)}
    enc = {
        "attn_norm_s": ("embed",), "attn_norm_b": ("embed",),
        "attn": attn_ax,
        "mlp_norm_s": ("embed",), "mlp_norm_b": ("embed",),
        "mlp": mlp_ax,
    }
    dec = {
        "self_norm_s": ("embed",), "self_norm_b": ("embed",),
        "self_attn": attn_ax,
        "cross_norm_s": ("embed",), "cross_norm_b": ("embed",),
        "cross_attn": {"wq": ("embed", "heads_x_dim"),
                       "wk": ("embed", "kv_heads_x_dim"),
                       "wv": ("embed", "kv_heads_x_dim"),
                       "wo": ("heads_x_dim", "embed")},
        "mlp_norm_s": ("embed",), "mlp_norm_b": ("embed",),
        "mlp": mlp_ax,
    }
    return {
        "embed": ("vocab", "embed"),
        "enc_blocks": [enc for _ in range(cfg.encoder.num_layers)],
        "enc_final_s": ("embed",), "enc_final_b": ("embed",),
        "dec_blocks": [dec for _ in range(cfg.num_layers)],
        "final_s": ("embed",), "final_b": ("embed",),
    }


def encode(params, cfg, frame_embeds: torch.Tensor) -> torch.Tensor:
    """frame_embeds: (B, F, d), precomputed (the conv frontend stub) ->
    the encoder's output (B, F, d)."""
    B, F, d = frame_embeds.shape
    x = frame_embeds + layers.sinusoidal_positions(
        F, d, frame_embeds.device)[None].to(frame_embeds.dtype)
    positions = torch.arange(F, device=x.device)[None, :]
    for bp in params["enc_blocks"]:
        h = _ln(cfg, x, bp, "attn_norm")
        x = x + attention.attend_train(bp["attn"], cfg, h, positions,
                                       bidirectional=True)
        h = _ln(cfg, x, bp, "mlp_norm")
        x = x + layers.gelu_mlp(bp["mlp"], h)
    return _ln(cfg, x, params, "enc_final")


def cross_kv(bp_cross, cfg, enc_out: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """The encoder output's cross K/V, each (B, KVH, F, D)."""
    B, F, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ bp_cross["wk"]).reshape(B, F, cfg.num_kv_heads, hd)
    v = (enc_out @ bp_cross["wv"]).reshape(B, F, cfg.num_kv_heads, hd)
    return {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}


def cross_attend(bp_cross, cfg, x: torch.Tensor,
                 ckv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: (B, L, d) attends every frame of ``ckv`` (no mask)."""
    B, L, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ bp_cross["wq"]).reshape(B, L, cfg.num_heads, hd).transpose(1, 2)
    out = attention._sdpa(q, ckv["k"], ckv["v"], None)
    out = out.transpose(1, 2).reshape(B, L, cfg.num_heads * hd)
    return complete(out @ bp_cross["wo"])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, object]:
    """Zeroed self-attention caches (layers, B, KVH, max_seq, D) (int8
    with scales for ``cfg.kv_quant``) and cross K/V (layers, B, KVH,
    num_frames, D) in ``dtype``."""
    shape = (cfg.num_layers,) + attention.dense_kv_shape(cfg, batch, max_seq)
    cross = (cfg.num_layers, batch, cfg.num_kv_heads,
             cfg.encoder.num_frames, cfg.resolved_head_dim)
    return {"self": attention.kv_buffers(cfg, shape, dtype, device),
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device)}


def _dec_block(cfg, x: torch.Tensor, bp, self_attend,
               ckv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One decoder block over x; ``self_attend(attn_params, h)`` is its
    self-attention, ``ckv`` its cross K/V."""
    h = _ln(cfg, x, bp, "self_norm")
    x = x + self_attend(bp["self_attn"], h)
    h = _ln(cfg, x, bp, "cross_norm")
    x = x + cross_attend(bp["cross_attn"], cfg, h, ckv)
    h = _ln(cfg, x, bp, "mlp_norm")
    return x + layers.gelu_mlp(bp["mlp"], h)


def _decode_layers(params, cfg, x: torch.Tensor, cache, self_attend,
                   cross) -> torch.Tensor:
    """Every decoder block over x.  ``self_attend(attn_params, h,
    layer_cache)`` is the self-attention over the layer's cache views;
    ``cross(i, cross_params)`` gives layer i's cross K/V."""
    for i, bp in enumerate(params["dec_blocks"]):
        layer = {name: leaf[i] for name, leaf in cache["self"].items()}
        x = _dec_block(cfg, x, bp,
                       lambda ap, h: self_attend(ap, h, layer),
                       cross(i, bp["cross_attn"]))
    return _ln(cfg, x, params, "final")


def _dec_block_full(cfg, x: torch.Tensor, positions: torch.Tensor, bp,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """One decoder block over a whole sequence (training), its cross K/V
    computed from ``enc_out`` inside it."""
    return _dec_block(cfg, x, bp,
                      lambda ap, h: attention.attend_train(ap, cfg, h,
                                                           positions),
                      cross_kv(bp["cross_attn"], cfg, enc_out))


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """Next-token cross-entropy of the decoder over the encoded frames.
    batch: {"tokens": (B, S+1) integer, "frame_embeds": (B, F, d)}.
    Returns (loss, {"ce", "aux"}), 0-dim f32 tensors."""
    tokens = batch["tokens"].long()
    enc_out = encode(params, cfg, batch["frame_embeds"])
    x = layers.embed_tokens(params, tokens[:, :-1])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for bp in params["dec_blocks"]:
        x = layers.remat_call(remat, _dec_block_full, cfg, x, positions, bp,
                              enc_out)
    return layers.tied_lm_loss(params, cfg, _ln(cfg, x, params, "final"),
                               tokens[:, 1:])


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    return layers.mask_padded_logits(x @ params["embed"].T, cfg.vocab_size)


def prefill(params, cfg, tokens: torch.Tensor, cache,
            frame_embeds: torch.Tensor = None
            ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """The encoder over ``frame_embeds`` (B, F, d), then the decoder over
    whole prompts ``tokens`` (B, L) from position 0, filling the self
    caches and writing each layer's cross K/V, in place.  Returns (the last
    position's logits (B, V), the cache)."""
    if frame_embeds is None:
        raise ValueError(f"{cfg.name} needs frame_embeds to prefill")
    enc_out = encode(params, cfg, frame_embeds)
    x = layers.embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def cross(i, bp_cross):
        ckv = cross_kv(bp_cross, cfg, enc_out)
        cache["cross_k"][i].copy_(ckv["k"])
        cache["cross_v"][i].copy_(ckv["v"])
        return ckv

    x = _decode_layers(params, cfg, x, cache,
                       lambda ap, h, layer: attention.attend_prefill(
                           ap, cfg, h, positions, layer), cross)
    return _logits(params, cfg, x[:, -1]), cache


def decode_step(params, cfg, tokens: torch.Tensor, lengths: torch.Tensor,
                cache) -> Tuple[torch.Tensor, Dict[str, object]]:
    """tokens (B,) int32; lengths (B,) int32 tokens already in the self
    caches.  Returns (logits (B, V), the cache updated in place)."""
    x = layers.embed_tokens(params, tokens[:, None])
    x = _decode_layers(params, cfg, x, cache,
                       lambda ap, h, layer: attention.attend_decode(
                           ap, cfg, h, lengths, layer),
                       lambda i, _: {"k": cache["cross_k"][i],
                                     "v": cache["cross_v"][i]})
    return _logits(params, cfg, x[:, 0]), cache
