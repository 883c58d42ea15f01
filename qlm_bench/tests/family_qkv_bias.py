"""An architecture family that the tests drop into a copy of the benchmark
as ``families/qkv-bias-decoder.py``: the decoder family with q/k/v
biases, as the port serves qwen1.5-32b (``models/attention.py``: the
biases added to the projections before the rotary embedding)."""
from __future__ import annotations

from typing import Dict

import torch

from qlm_bench import reference, weights
from qlm_bench.families import decoder
from qlm_bench.reference import Matmul, rms_norm, rope, swiglu

attention_layers = decoder.attention_layers


def accepts(cfg) -> None:
    if not cfg.qkv_bias or cfg.sliding_window or cfg.kv_quant \
            or cfg.arch_type != "dense":
        raise ValueError(f"{cfg.name}: the reference computes a dense "
                         f"decoder with q/k/v biases only")


def make_weights(model: dict, seed: int, dtype: torch.dtype,
                 device: torch.device) -> Dict:
    """The decoder's tree, and ``bq``, ``bk``, ``bv`` in each layer's
    ``attn``, drawn from the seed's second generator."""
    params = decoder.make_weights(model, seed, dtype, device)
    gen = weights.generator(seed + 1, device)
    L, H, KVH = model["num_layers"], model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // H
    for name, heads in (("bq", H), ("bk", KVH), ("bv", KVH)):
        b = weights.draw(gen, (L, heads * hd), 0.5, dtype, device)
        for bp, row in zip(params["blocks"], b):
            bp["attn"][name] = row
    return params


def logits(model: dict, weights: Dict, tokens: torch.Tensor,
           first: int = 0, precision: str = "f32") -> torch.Tensor:
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
        q = rope((mm(h, a["wq"]) + a["bq"].float()).view(L, H, hd), theta)
        k = rope((mm(h, a["wk"]) + a["bk"].float()).view(L, KVH, hd), theta)
        v = (mm(h, a["wv"]) + a["bv"].float()).view(L, KVH, hd)
        x = x + mm(reference.attention(q, k, v).reshape(L, H * hd), a["wo"])
        h = rms_norm(x, bp["mlp_norm"], eps)
        m = bp["mlp"]
        x = x + swiglu(mm, h, m["gate"], m["up"], m["down"])
    x = rms_norm(x[first:], weights["final_norm"], eps)
    head = weights["embed"][:V].T if model.get("tie_embeddings", False) \
        else weights["lm_head"][:, :V]
    return mm(x, head)
