"""Flash (self-)attention of a whole sequence, causal or sliding-window,
with GQA: the attention of the training path (``attend_train`` under
``cfg.use_pallas_attention``).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention`` with the
hand-written CUDA kernel of ``csrc/flash_attention.cu`` (``sm_90a``),
bound through ``ctypes``.

  q        (B, H, Lq, D)     float32 or bfloat16
  k/v      (B, KVH, Lkv, D)  q's dtype; query head h reads KV head
                             h // (H // KVH)
  returns  (B, H, Lq, D)     q's dtype

The contract is the reference kernel's: query position i and key position
j both count from 0 (top-left alignment); key j is visible to query i iff
j <= i when ``causal`` and j > i - window when ``window`` is set; scores
are (q . k) / sqrt(D) in f32, masked scores -1e30, the softmax denominator
floored at 1e-20.  A row that sees no key (only possible when Lq > Lkv
under a window) gives 0, as the port's other kernels do; the reference's
jnp oracle would give the mean of v there.  On the training path Lq ==
Lkv, so every row sees its own key.

What bounds the kernel on the H100 at the training path's shapes is the
arithmetic, 4 flops per (query head, visible key, dimension): about half
the square when causal, against q, k, v and out moved once.  One CTA per
(sequence, KV head, tile of positions) holds the GQA group's rows (the
plan of ``common.attention_plan``), brings 64-key tiles in by ``cp.async``
into a ring of shared stages, runs both products on the tensor cores
(``mma.sync``: bf16, or 3xTF32 for f32, which keeps f32 accuracy) into an
f32 online softmax held in registers, and walks only the key tiles one of
its rows can see.

``flash_attention`` is a ``torch.autograd.Function``: its forward launches
the kernel on CUDA tensors (or raises) and runs ``flash_attention_plain``
on CPU tensors; its backward recomputes ``flash_attention_plain`` from the
saved q, k and v and differentiates that.  The reference has no backward
kernel (its Pallas kernel has no VJP at all), so the port has none either.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed.local import whole
from repro_torch.kernels.common import (attention_plan, check_cuda_inputs,
                                       launch, on_cpu)
from repro_torch.kernels.decode_attention import masked_softmax_attend

# launches of the CUDA kernel in this process (the plain version does not
# count; a block recomputed under remat launches again); reset by whoever
# reads it
launches = 0


def visible_keys(Lq: int, Lkv: int, causal: bool, window: Optional[int],
                 device) -> torch.Tensor:
    """(Lq, Lkv) bool: key j visible to query i (positions from 0)."""
    i = torch.arange(Lq, device=device)[:, None]
    j = torch.arange(Lkv, device=device)[None, :]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (j > i - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract), in f32; the
    heads split unsharded, as ``decode_attention_plain``'s."""
    B, H, Lq, D = q.shape
    KVH, Lkv = k.shape[1], k.shape[2]
    qg = whole(q, 1).reshape(B, KVH, H // KVH, Lq, D).float()
    s = torch.matmul(qg, k[:, :, None].float().transpose(-1, -2)) \
        / math.sqrt(D)                                    # (B,KVH,G,Lq,Lkv)
    mask = visible_keys(Lq, Lkv, causal, window, q.device)
    out = masked_softmax_attend(s, mask, v[:, :, None].float())
    return out.reshape(B, H, Lq, D).to(q.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    global launches
    dtype = check_cuda_inputs("flash_attention", {"q": q, "k": k, "v": v}, {})
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, H, Lq, D) and k/v "
                         f"(B, KVH, Lkv, D), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, H, Lq, D = q.shape
    KVH, Lkv = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D or H % KVH:
        raise ValueError(f"flash_attention: shape mismatch: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if H // KVH > 64 or D > 128 or min(Lq, Lkv) < 1:
        raise ValueError(f"flash_attention: the kernel takes at most 64 "
                         f"query heads per KV head, head_dim <= 128 and "
                         f"non-empty sequences, got {H // KVH}, {D}, "
                         f"Lq {Lq}, Lkv {Lkv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    plan = attention_plan(B, H, KVH, Lq, D, q.dtype)
    out = torch.empty_like(q)
    launch("flash_attention", "flash_attention", q.device, [q, k, v, out],
           [B, H, KVH, Lq, Lkv, D, int(causal),
            0 if window is None else int(window), dtype, plan.tile_q,
            plan.d_pad, plan.smem_bytes])
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA tensors) or the plain version (CPU
    tensors).  Backward: autograd through the plain version, recomputed
    from the saved q, k, v alone, so a block recomputed under remat needs
    nothing of the first forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        if on_cpu({"q": q, "k": k, "v": v}):
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, causal=ctx.causal,
                                        window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention (contract in the module docstring), differentiable
    in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, window)
