"""The plain reference: a decoder-only transformer in float32 PyTorch,
written from the architecture, importing nothing of the port.

It reads a configuration's ``"model"`` sizes and the weights that
``weights.py`` made (the tensors the port served, in their served dtype;
each layer's are cast to float32 here, one layer at a time, so the whole
model never sits on the card in float32).  Per layer: RMS norm, q/k/v
projections, rotary embedding on halves (rotate-half form), causal
attention with grouped KV heads at ``1/sqrt(head_dim)``, the output
projection, RMS norm, then a SwiGLU MLP or a dropless top-k mixture of
experts (softmax router in float32, top k with ties to the lower index,
weights renormalised over the chosen k, each expert's SwiGLU over exactly
the tokens routed to it).  Final RMS norm and the (tied) unembedding over
the real vocabulary.

``precision="fp8"`` is the control: every weight and activation product
(projections, MLP, experts, unembedding) takes float8 e4m3 operands, the
activations scaled per row and the weights per output column, products
accumulated in float32; attention, norms and the router stay float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Matmul:
    """``a @ w`` in float32, or on float8 operands for the control."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            a, w = _fp8(a, -1), _fp8(w, -2)
        return a @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (L, heads, hd) at positions 0..L-1."""
    L, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block: int = 1024) -> torch.Tensor:
    """Causal attention, q (L, H, hd), k/v (L, KVH, hd), in query blocks."""
    L, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)       # (H, L, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s in range(0, L, block):
        e = min(L, s + block)
        scores = q[s:e].transpose(0, 1) @ k[:, :e].transpose(1, 2) \
            / math.sqrt(hd)                                  # (H, b, e)
        pos = torch.arange(s, e, device=q.device)[:, None]
        scores = scores.masked_fill(
            torch.arange(e, device=q.device)[None, :] > pos, float("-inf"))
        out[s:e] = (torch.softmax(scores, -1) @ v[:, :e]).transpose(0, 1)
    return out


def swiglu(mm: Matmul, x: torch.Tensor, gate, up, down) -> torch.Tensor:
    return mm(F.silu(mm(x, gate)) * mm(x, up), down)


def moe(mm: Matmul, x: torch.Tensor, p: Dict, k: int) -> torch.Tensor:
    """Dropless top-k: every token's k chosen experts, each over exactly
    its tokens."""
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(p["gate"].shape[0]):
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(mm, x[tok], p["gate"][e], p["up"][e], p["down"][e])
            out.index_add_(0, tok, y * top_p[tok, slot, None])
    return out


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
        x = x + mm(attention(q, kk, vv).reshape(L, H * hd), a["wo"])
        h = rms_norm(x, bp["mlp_norm"], eps)
        if "moe" in bp:
            x = x + moe(mm, h, bp["moe"], model["moe"]["experts_per_token"])
        else:
            m = bp["mlp"]
            x = x + swiglu(mm, h, m["gate"], m["up"], m["down"])
    x = rms_norm(x[first:], weights["final_norm"], eps)
    head = weights["embed"][:V].T if model.get("tie_embeddings", False) \
        else weights["lm_head"][:, :V]
    return mm(x, head)


def served_gaps(model: dict, weights: Dict, prompt, served,
                precision: Optional[str] = None) -> torch.Tensor:
    """For one request: at each served token, how far its float32 logit
    lies below the float32 reference's best (0 where it is the best).
    With ``precision`` (the control) the token judged at each position is
    the one that reference in that precision puts first, on the same
    prompt and served tokens, in place of the served one."""
    device = weights["embed"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]),
                          dtype=torch.long, device=device)
    first = len(prompt) - 1
    ref = logits(model, weights, seq, first)
    if precision is None:
        judged = torch.as_tensor(list(served), dtype=torch.long,
                                 device=device)
    else:
        judged = logits(model, weights, seq, first, precision).argmax(-1)
    best = ref.max(-1).values
    return best - ref.gather(1, judged[:, None])[:, 0]
