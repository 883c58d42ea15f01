"""The decoder family: a decoder-only transformer with full causal
attention on every layer, dense or with a dropless top-k mixture of
experts, as the port's ``models/transformer.py`` serves granite-3-2b and
dbrx-132b.

Per layer: RMS norm, q/k/v projections, rotary embedding, causal
attention with grouped KV heads, the output projection, RMS norm, then a
SwiGLU MLP or the mixture (``reference.py``'s parts).  Final RMS norm and
the (tied) unembedding over the real vocabulary.  ``precision="fp8"`` is
the control: every weight and activation product (projections, MLP,
experts, unembedding) on float8 operands.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from qlm_bench import reference, weights
from qlm_bench.reference import Matmul, rms_norm, rope, swiglu


def accepts(cfg) -> None:
    """Refuses a port configuration that this reference does not compute:
    biases, a window, int8 KV, or a block other than dense or MoE."""
    if cfg.qkv_bias or cfg.sliding_window or cfg.kv_quant \
            or cfg.arch_type not in ("dense", "moe"):
        raise ValueError(f"{cfg.name}: the reference computes a dense "
                         f"or MoE decoder with full float attention only")


def attention_layers(model: dict) -> list:
    """One group: every layer attends over its whole context."""
    H = model["num_heads"]
    D = model.get("head_dim") or model["d_model"] // H
    return [(model["num_layers"], H, model["num_kv_heads"], D, None)]


def make_weights(model: dict, seed: int, dtype: torch.dtype,
                 device: torch.device) -> Dict:
    """The parameter tree of ``model`` from ``seed``."""
    gen = weights.generator(seed, device)
    L, d = model["num_layers"], model["d_model"]
    H, KVH = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    vp = weights.padded_vocab(model["vocab_size"])

    def draw(shape, std):
        return weights.draw(gen, shape, std, dtype, device)

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


def logits(model: dict, weights: Dict, tokens: torch.Tensor,
           first: int = 0, precision: str = "f32") -> torch.Tensor:
    """float32 logits over the real vocabulary at positions ``first``..
    ``len(tokens) - 1`` of one sequence (``tokens`` (L,), from position 0)."""
    mm = Matmul(precision)
    eps = model.get("rms_norm_eps", 1e-5)
    theta = model.get("rope_theta", 10000.0)
    H, KVH = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // H
    V = model["vocab_size"]
    x = weights["embed"][tokens.long()].float()
    L = x.shape[0]
    for bp in weights["blocks"]:
        a = bp["attn"]
        h = rms_norm(x, bp["attn_norm"], eps)
        q = rope(mm(h, a["wq"]).view(L, H, hd), theta)
        kk = rope(mm(h, a["wk"]).view(L, KVH, hd), theta)
        vv = mm(h, a["wv"]).view(L, KVH, hd)
        x = x + mm(reference.attention(q, kk, vv).reshape(L, H * hd),
                   a["wo"])
        h = rms_norm(x, bp["mlp_norm"], eps)
        if "moe" in bp:
            x = x + reference.moe(mm, h, bp["moe"],
                                  model["moe"]["experts_per_token"])
        else:
            m = bp["mlp"]
            x = x + swiglu(mm, h, m["gate"], m["up"], m["down"])
    x = rms_norm(x[first:], weights["final_norm"], eps)
    head = weights["embed"][:V].T if model.get("tie_embeddings", False) \
        else weights["lm_head"][:, :V]
    return mm(x, head)
