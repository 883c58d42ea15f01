"""Top-k MoE layer with capacity-bounded scatter dispatch (PyTorch twin of
``src/repro/models/moe.py``).

Router: softmax over expert logits in f32, top-k, probabilities
renormalised over the chosen experts; Switch-style load-balance aux loss.
Dispatch: every (token, choice) pair gets a slot in its expert's buffer
of ``capacity`` rows by a stable sort of the expert ids; pairs past the
capacity drop (the residual carries their token).  The experts' SwiGLU
runs as batched products over all E experts, as the reference's einsums
do, and the combine adds each token's k weighted outputs.

What the port keeps bit for bit, and how:
  * top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks
    them: a stable descending sort, first k (``torch.topk`` promises no
    order among equal values on CUDA);
  * the slot order is the reference's: each token's index repeated k
    times (``jnp.repeat``), ``argsort(stable=True)``, ``searchsorted(side=
    "left")``, so the capacity drop falls on the same pairs.  The capacity
    counts every row of the batch, padding and inactive rows included;
  * the combine adds the k slices of the (T, k, d) pair outputs in index
    order into zeros of the activation dtype, each add rounding as the
    reference's scatter-add does, with no atomics (``index_add_`` on CUDA
    adds in no fixed order, which would break bitwise replay).

No host sync and no data-dependent shape: the capacity comes from shapes,
the dispatched buffer is ``(E * C + 1, d)`` with the overflow row last,
and no mask indexing, ``nonzero`` or ``.item()`` runs here, so a decode
step with MoE blocks is capturable as a CUDA graph.  The reference
computes these products as plain einsums outside any Pallas kernel, so
no hand-written kernel takes their place.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """Router (fan-in init) and stacked expert weights, truncated normal at
    the reference's scales: gate/up (E, d, F) at 1/sqrt(d), down (E, F, d)
    at 1/sqrt(F)."""
    moe = cfg.moe
    d = cfg.d_model
    E, Fe = moe.num_experts, moe.d_ff_expert

    def trunc(shape, std):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w * std).to(dtype)

    return {
        "router": layers.dense_init(gen, d, E, dtype, device),
        "gate": trunc((E, d, Fe), 1.0 / math.sqrt(d)),
        "up": trunc((E, d, Fe), 1.0 / math.sqrt(d)),
        "down": trunc((E, Fe, d), 1.0 / math.sqrt(Fe)),
    }


def moe_param_axes(cfg) -> Dict[str, Tuple[str, ...]]:
    """Logical sharding axes of ``init_moe``'s leaves (the reference's)."""
    return {
        "router": ("embed", "experts"),
        "gate": ("experts", "embed", "moe_ff"),
        "up": ("experts", "embed", "moe_ff"),
        "down": ("experts", "moe_ff", "embed"),
    }


def _topk_routing(logits: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: (T, E) -> (weights (T, k) f32, expert_ids (T, k) int64,
    aux_loss 0-dim f32)."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    sorted_p, sorted_ids = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    top_p, top_ids = sorted_p[:, :k], sorted_ids[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # Switch aux loss: E * sum_e (fraction_tokens_e * mean_prob_e)
    one_hot = F.one_hot(top_ids, E).float()                  # (T, k, E)
    tokens_per_expert = one_hot.sum(dim=(0, 1)) / (T * k)
    mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(tokens_per_expert * mean_prob)
    return top_p, top_ids, aux


def _dispatch_slots(expert_ids: torch.Tensor, capacity: int, E: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """expert_ids: (N,) -> (keep (N,) bool, slot (N,) int64) by stable-sort
    counting: a pair's position is its rank among the pairs of its
    expert, in pair order."""
    N = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)
    sorted_expert = expert_ids[order].contiguous()
    idx = torch.arange(N, device=expert_ids.device)
    seg_start = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    pos_sorted = idx - seg_start
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < capacity      # capacity drop (overflow pairs ride the residual)
    slot = expert_ids * capacity + torch.where(keep, pos, 0)
    return keep, slot


def _expert_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, i) @ (E, i, o) -> (E, C, o) in f32, the reference's
    ``preferred_element_type=jnp.float32``: on a card half operands
    accumulate into an f32 output (``bmm``'s ``out_dtype``); the CPU runs
    f32 (a half product there rounds to its dtype first)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a, w).float()


def _moe_tokens(params, xf: torch.Tensor, weights: torch.Tensor,
                expert_ids: torch.Tensor, capacity: int, E: int,
                k: int) -> torch.Tensor:
    """Scatter dispatch, expert SwiGLU and ordered combine for one flat
    token block xf: (T, d)."""
    T, d = xf.shape
    flat_expert = expert_ids.reshape(-1)                     # (T*k,)
    flat_weight = weights.reshape(-1)
    flat_token = torch.arange(T, device=xf.device)[:, None].expand(
        T, k).reshape(-1)                                   # jnp.repeat

    keep, slot = _dispatch_slots(flat_expert, capacity, E)
    safe_slot = torch.where(keep, slot, E * capacity)        # overflow row

    dispatched = xf.new_zeros((E * capacity + 1, d))
    dispatched = dispatched.index_put((safe_slot,), xf[flat_token])
    dispatched = dispatched[:-1].reshape(E, capacity, d)

    gate = F.silu(_expert_mm(dispatched, params["gate"]))
    up = _expert_mm(dispatched, params["up"])
    expert_out = _expert_mm((gate * up).to(xf.dtype), params["down"])

    flat_out = expert_out.reshape(E * capacity, d)
    pair_out = torch.where(keep[:, None],
                           flat_out[torch.where(keep, slot, 0)], 0.0)
    pair_out = (pair_out * flat_weight[:, None].to(pair_out.dtype)
                ).to(xf.dtype).reshape(T, k, d)
    out = torch.zeros((T, d), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        out = out + pair_out[:, j]
    return out


def apply_moe(params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> (out (B, L, d), aux_loss 0-dim f32).

    With ``moe.dispatch_groups = G`` (and T divisible by G) the tokens are
    dispatched in G groups of T/G, each with its own capacity, as the
    reference's vmap over groups."""
    moe = cfg.moe
    B, L, d = x.shape
    T = B * L
    E, k = moe.num_experts, moe.experts_per_token
    xf = x.reshape(T, d)

    logits = xf @ params["router"]
    weights, expert_ids, aux = _topk_routing(logits, k)     # (T, k)

    G = moe.dispatch_groups or 1
    if G == 1 or T % G != 0:
        capacity = max(int(math.ceil(T * k / E * moe.capacity_factor)), k)
        out = _moe_tokens(params, xf, weights, expert_ids, capacity, E, k)
        return out.reshape(B, L, d), aux.float()

    Tg = T // G
    capacity = max(int(math.ceil(Tg * k / E * moe.capacity_factor)), k)
    out = torch.cat([
        _moe_tokens(params, xf[g * Tg:(g + 1) * Tg],
                    weights[g * Tg:(g + 1) * Tg],
                    expert_ids[g * Tg:(g + 1) * Tg], capacity, E, k)
        for g in range(G)])
    return out.reshape(B, L, d), aux.float()
