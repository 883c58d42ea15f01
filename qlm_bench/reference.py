"""The plain reference's parts, in float32 PyTorch, written from the
architecture and importing nothing of the port: the families'
``logits`` (``families/<family>.py``) are made of them.

The weights are the tensors the port served, in their served dtype; each
product casts its weight to float32 (``Matmul``), one layer at a time, so
the whole model never sits on the card in float32.  Rotary embedding on
halves (rotate-half form), causal attention with grouped KV heads at
``1/sqrt(head_dim)``, a SwiGLU MLP, and a dropless top-k mixture of
experts (softmax router in float32, top k with ties to the lower index,
weights renormalised over the chosen k, each expert's SwiGLU over exactly
the tokens routed to it).

``Matmul("fp8")`` is the control's product: float8 e4m3 operands, the
activations scaled per row and the weights per output column, products
accumulated in float32; attention, norms and the router stay float32.
"""
from __future__ import annotations

import math
from typing import Dict

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
