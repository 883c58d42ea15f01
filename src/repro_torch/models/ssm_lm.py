"""Attention-free Mamba2 LM, mamba2-130m (PyTorch twin of
``src/repro/models/ssm_lm.py``): the training loss, single-shot prefill
and the recurrent decode step.  [arXiv:2405.21060]

Params are ``{"embed", "final_norm", "blocks": [{"norm", "mamba": {...}},
...]}``, one dict per layer (``models/convert.py`` unstacks the
reference's).  The state stacks each layer's leaves on a leading
``layers`` axis, ``{"conv": (layers, B, W-1, C), "ssm": (layers, B, H, N,
P) float32}``, and both serving paths update it in place.  Training runs
each layer's full form from a zero state (``forward_train``), its scan
the SSD kernel on a CUDA tensor, differentiated through the kernel's
plain version (``kernels/ssd_scan.py::SSDScan``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import layers, ssm as ssm_lib


def init_ssm_lm(gen: torch.Generator, cfg, dtype: torch.dtype,
                device: torch.device):
    """Random weights drawn on ``device`` from ``gen`` (a generator of that
    device), at the reference's scales."""
    return {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                   device),
        "blocks": [{"norm": torch.ones(cfg.d_model, dtype=dtype,
                                       device=device),
                    "mamba": ssm_lib.init_mamba_block(gen, cfg, dtype,
                                                      device)}
                   for _ in range(cfg.num_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
    }


def ssm_lm_param_axes(cfg):
    """Logical sharding axes of ``init_ssm_lm``'s tree, one block dict per
    layer."""
    return {
        "embed": ("vocab", "embed"),
        "blocks": [{"norm": ("embed",), "mamba": ssm_lib.mamba_param_axes(cfg)}
                   for _ in range(cfg.num_layers)],
        "final_norm": ("embed",),
    }


def block_train(cfg, x: torch.Tensor, bp) -> torch.Tensor:
    """One residual mamba layer over a whole sequence, from a zero state
    (the state it ends in is dropped)."""
    h = layers.rms_norm(x, bp["norm"], cfg.rms_norm_eps)
    out, _ = ssm_lib.mamba_block_full(bp["mamba"], cfg, h)
    return x + out


def forward_train(params, cfg, x: torch.Tensor, *,
                  remat: bool = True) -> torch.Tensor:
    """x: (B, L, d) embeddings -> the final-normed hidden states (B, L, d).
    A Python loop over the per-layer dicts takes the place of the
    reference's ``lax.scan``; with ``remat`` each layer is a remat
    boundary."""
    for bp in params["blocks"]:
        x = layers.remat_call(remat, block_train, cfg, x, bp)
    return layers.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """Next-token cross-entropy.  batch: {"tokens": (B, S+1) integer}.
    Returns (loss, {"ce", "aux"}), 0-dim f32 tensors."""
    tokens = batch["tokens"].long()
    hidden = forward_train(params, cfg,
                           layers.embed_tokens(params, tokens[:, :-1]),
                           remat=remat)
    return layers.tied_lm_loss(params, cfg, hidden, tokens[:, 1:])


def init_state(cfg, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero conv histories in ``dtype`` and f32 SSM states, stacked on a
    leading ``layers`` axis (``max_seq`` is unused: the state is
    position-free)."""
    conv = ssm_lib.init_conv_state(cfg, batch, dtype, device)
    ssst = ssm_lib.init_ssm_state(cfg, batch, device)
    return {"conv": conv[None].repeat(cfg.num_layers, 1, 1, 1),
            "ssm": ssst[None].repeat(cfg.num_layers, 1, 1, 1, 1)}


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return layers.mask_padded_logits(x @ params["embed"].T, cfg.vocab_size)


def _run(block, params, cfg, x: torch.Tensor,
         state: Dict[str, torch.Tensor]) -> torch.Tensor:
    for i, bp in enumerate(params["blocks"]):
        h = layers.rms_norm(x, bp["norm"], cfg.rms_norm_eps)
        out, st = block(bp["mamba"], cfg, h,
                        {"conv": state["conv"][i], "ssm": state["ssm"][i]})
        x = x + out
        state["conv"][i].copy_(st["conv"])
        state["ssm"][i].copy_(st["ssm"])
    return x


def prefill(params, cfg, tokens: torch.Tensor,
            state: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, L) -> (logits of the last position, state)."""
    x = _run(ssm_lib.mamba_block_full, params, cfg,
             layers.embed_tokens(params, tokens), state)
    return _logits(params, cfg, x[:, -1]), state


def decode_step(params, cfg, tokens: torch.Tensor, lengths: torch.Tensor,
                state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B,) -> (logits, state); ``lengths`` is unused (the SSM state
    is position-free)."""
    del lengths
    x = _run(ssm_lib.mamba_block_step, params, cfg,
             layers.embed_tokens(params, tokens[:, None]), state)
    return _logits(params, cfg, x[:, 0]), state
