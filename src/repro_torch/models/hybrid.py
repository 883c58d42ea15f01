"""Zamba2-style hybrid LM, zamba2-1.2b (PyTorch twin of
``src/repro/models/hybrid.py``): a Mamba2 backbone plus ONE weight-tied
attention block applied after every ``hybrid_attn_every``-th layer.
[arXiv:2411.15242]

Params are ``{"embed", "final_norm", "blocks": [{"norm", "mamba": {...}},
...], "shared_attn": {"attn_norm", "attn", "mlp_norm", "mlp"}}``: one dict
per mamba layer (``models/convert.py`` unstacks the reference's) and the
shared block stored once, not stacked.  The state is ``{"conv": (layers,
B, W-1, C), "ssm": (layers, B, H, N, P) float32, "kv": {"k", "v"[,
"k_scale", "v_scale"]}}``, the KV leaves a dense per-slot cache
(``models/attention.py``) for each application site on a leading
``sites`` axis; both serving paths update it in place.

The prefill runs every mamba layer's full form from a zero state (its scan
is the CUDA SSD kernel on a CUDA tensor) and each site's ``attend_prefill``
(plain ``_sdpa``, as the reference's jnp path); the decode step runs the
recurrent mamba step and each site's ``attend_decode``, the dense decode
kernel (its int8 twin for ``cfg.kv_quant``).  Training runs every mamba
layer's full form from a zero state (the SSD kernel on a CUDA tensor,
differentiated through its plain version) and each site's
``attend_train`` (the flash kernel under ``cfg.use_pallas_attention``),
each mamba layer and each application of the shared block a remat
boundary; the shared block's gradient sums over its sites.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.models import attention, layers, ssm as ssm_lib, ssm_lm


def attn_sites(cfg) -> List[int]:
    """Layer indices after which the shared attention block runs."""
    return [i for i in range(cfg.num_layers)
            if (i + 1) % cfg.hybrid_attn_every == 0]


def init_hybrid_lm(gen: torch.Generator, cfg, dtype: torch.dtype,
                   device: torch.device):
    """Random weights drawn on ``device`` from ``gen`` (a generator of that
    device), at the reference's scales: mamba2's LM and the shared
    block."""
    params = ssm_lm.init_ssm_lm(gen, cfg, dtype, device)
    ones = lambda: torch.ones(cfg.d_model, dtype=dtype, device=device)
    params["shared_attn"] = {
        "attn_norm": ones(),
        "attn": attention.init_attention(gen, cfg, dtype, device),
        "mlp_norm": ones(),
        "mlp": layers.init_swiglu_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                      device),
    }
    return params


def hybrid_param_axes(cfg):
    """Logical sharding axes of ``init_hybrid_lm``'s tree: mamba2's, and
    the shared block's once."""
    ax = ssm_lm.ssm_lm_param_axes(cfg)
    ax["shared_attn"] = {
        "attn_norm": ("embed",),
        "attn": attention.attention_param_axes(cfg),
        "mlp_norm": ("embed",),
        "mlp": {"gate": ("embed", "ff"), "up": ("embed", "ff"),
                "down": ("ff", "embed")},
    }
    return ax


def forward_train(params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                  remat: bool = True) -> torch.Tensor:
    """x: (B, L, d) embeddings -> the final-normed hidden states (B, L, d).

    Each mamba layer, and each application of the shared block, is a
    remat boundary, as the reference's: the SSD's intra-chunk decay
    tensors (B, nc, Q, Q, H) would otherwise persist across 38 layers."""
    sites = set(attn_sites(cfg))
    for i, bp in enumerate(params["blocks"]):
        x = layers.remat_call(remat, ssm_lm.block_train, cfg, x, bp)
        if i in sites:
            x = layers.remat_call(remat, _shared_attn_full, params, cfg, x,
                                  positions)
    return layers.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """Next-token cross-entropy.  batch: {"tokens": (B, S+1) integer}.
    Returns (loss, {"ce", "aux"}), 0-dim f32 tensors."""
    tokens = batch["tokens"].long()
    x = layers.embed_tokens(params, tokens[:, :-1])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    hidden = forward_train(params, cfg, x, positions, remat=remat)
    return layers.tied_lm_loss(params, cfg, hidden, tokens[:, 1:])


def init_state(cfg, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, object]:
    """mamba2's state (zero conv histories in ``dtype`` and f32 SSM states
    on a leading ``layers`` axis) and one zeroed dense KV cache of
    ``cache_len`` columns per site on a leading ``sites`` axis."""
    state = ssm_lm.init_state(cfg, batch, max_seq, dtype, device)
    shape = (len(attn_sites(cfg)),) + attention.dense_kv_shape(cfg, batch,
                                                               max_seq)
    state["kv"] = attention.kv_buffers(cfg, shape, dtype, device)
    return state


def _shared_block(params, cfg, x: torch.Tensor, attend) -> torch.Tensor:
    """The shared attention block; ``attend(attn_params, h)`` is its
    attention at this site."""
    sp = params["shared_attn"]
    h = layers.rms_norm(x, sp["attn_norm"], cfg.rms_norm_eps)
    x = x + attend(sp["attn"], h)
    h = layers.rms_norm(x, sp["mlp_norm"], cfg.rms_norm_eps)
    return x + layers.swiglu_mlp(sp["mlp"], h)


def _shared_attn_full(params, cfg, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """The shared block over a whole sequence (training)."""
    return _shared_block(params, cfg, x, lambda ap, h: attention.attend_train(
        ap, cfg, h, positions))


def _run(params, cfg, x: torch.Tensor, state, mamba, attend) -> torch.Tensor:
    """Every layer over x.  ``mamba(block_params, h, layer_state)`` returns
    (out, new layer state); ``attend(attn_params, h, site_cache)`` is the
    site attention over that site's KV views."""
    sites = attn_sites(cfg)
    for i, bp in enumerate(params["blocks"]):
        h = layers.rms_norm(x, bp["norm"], cfg.rms_norm_eps)
        out, st = mamba(bp["mamba"], h,
                        {"conv": state["conv"][i], "ssm": state["ssm"][i]})
        state["conv"][i].copy_(st["conv"])
        state["ssm"][i].copy_(st["ssm"])
        x = x + out
        if i in sites:
            site = {name: leaf[sites.index(i)]
                    for name, leaf in state["kv"].items()}
            x = _shared_block(params, cfg, x,
                              lambda ap, h: attend(ap, h, site))
    return x


def prefill(params, cfg, tokens: torch.Tensor, state
            ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """Single-shot prefill of whole prompts from position 0 (each mamba
    layer from a zero state, as the reference's).  tokens: (B, L);
    ``state``: ``init_state`` of batch B.  Returns (the last position's
    logits (B, V), the state filled in place)."""
    x = layers.embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _run(params, cfg, x, state,
             lambda mp, h, st: ssm_lib.mamba_block_full(mp, cfg, h),
             lambda ap, h, site: attention.attend_prefill(ap, cfg, h,
                                                          positions, site))
    return ssm_lm._logits(params, cfg, x[:, -1]), state


def decode_step(params, cfg, tokens: torch.Tensor, lengths: torch.Tensor,
                state) -> Tuple[torch.Tensor, Dict[str, object]]:
    """tokens (B,) int32; lengths (B,) int32 tokens already cached (the
    sites' position).  Returns (logits (B, V), the state updated in
    place)."""
    x = layers.embed_tokens(params, tokens[:, None])
    x = _run(params, cfg, x, state,
             lambda mp, h, st: ssm_lib.mamba_block_step(mp, cfg, h, st),
             lambda ap, h, site: attention.attend_decode(ap, cfg, h, lengths,
                                                         site))
    return ssm_lm._logits(params, cfg, x[:, 0]), state
