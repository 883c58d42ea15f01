"""Random weights from the seed, made by the benchmark and handed to both
sides: the port serves them, the reference (``reference.py``) reads the
same tensors once the window has closed.

They are drawn on the device with one ``torch.Generator`` of that device,
one call per kind of leaf over all layers at once, in the dtype they are
served in, and laid out as the port's parameter tree
(``models/transformer.py``: ``x @ w`` with ``w`` of shape (in, out), one
dict per layer; a layer's leaf is a view of the stacked draw).  Normal at
the port's initializer scales: ``1/sqrt(fan_in)`` for projections, 0.02
for the embedding, ones for the norms.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _draw(gen: torch.Generator, shape, std: float, dtype, device
          ) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(std)


def make_weights(model: dict, seed: int, dtype: torch.dtype,
                 device: torch.device) -> Dict:
    """The parameter tree of ``model`` (a configuration's ``"model"``
    sizes) from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    L, d = model["num_layers"], model["d_model"]
    H, KVH = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    vp = padded_vocab(model["vocab_size"])
    draw = lambda shape, std: _draw(gen, shape, std, dtype, device)  # noqa: E731

    params = {"embed": draw((vp, d), 0.02),
              "final_norm": torch.ones(d, dtype=dtype, device=device)}
    if not model.get("tie_embeddings", False):
        params["lm_head"] = draw((d, vp), 1.0 / math.sqrt(d))
    wq = draw((L, d, H * hd), 1.0 / math.sqrt(d))
    wk = draw((L, d, KVH * hd), 1.0 / math.sqrt(d))
    wv = draw((L, d, KVH * hd), 1.0 / math.sqrt(d))
    wo = draw((L, H * hd, d), 1.0 / math.sqrt(H * hd))
    moe = model.get("moe")
    if moe:
        E, Fe = moe["num_experts"], moe["d_ff_expert"]
        ffn = {"router": draw((L, d, E), 1.0 / math.sqrt(d)),
               "gate": draw((L, E, d, Fe), 1.0 / math.sqrt(d)),
               "up": draw((L, E, d, Fe), 1.0 / math.sqrt(d)),
               "down": draw((L, E, Fe, d), 1.0 / math.sqrt(Fe))}
    else:
        F = model["d_ff"]
        ffn = {"gate": draw((L, d, F), 1.0 / math.sqrt(d)),
               "up": draw((L, d, F), 1.0 / math.sqrt(d)),
               "down": draw((L, F, d), 1.0 / math.sqrt(F))}
    ones = torch.ones(d, dtype=dtype, device=device)
    params["blocks"] = [
        {"attn_norm": ones.clone(), "mlp_norm": ones.clone(),
         "attn": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]},
         ("moe" if moe else "mlp"): {k: v[i] for k, v in ffn.items()}}
        for i in range(L)]
    return params


def padded_vocab(vocab_size: int) -> int:
    """The embedding's rows: the vocabulary padded to a multiple of 256,
    as the port pads it (``ModelConfig.padded_vocab``); the padding's
    logits are masked, and the reference reads the real rows only."""
    return -(-vocab_size // 256) * 256
