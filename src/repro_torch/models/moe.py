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
    times (``jnp.repeat``), ``argsort(stable=True)``, and each pair's rank
    among its expert's pairs; the rank's segment start comes from
    per-expert counts (an exclusive cumsum), the integers the reference's
    ``searchsorted(side="left")`` gives, so the capacity drop falls on the
    same pairs.  The capacity counts every row of the batch, padding and
    inactive rows included;
  * the combine adds the k slices of the (T, k, d) pair outputs in index
    order into zeros of the activation dtype, each add rounding as the
    reference's scatter-add does, with no atomics (``index_add_`` on CUDA
    adds in no fixed order, which would break bitwise replay).

With ``dispatch_groups`` G the tokens run as one batched ``(G, T / G)``
dispatch, the counterpart of the reference's ``jax.vmap`` over groups:
the sort, ranking, dispatch scatter and combine work within a group.
On a mesh whose data axes split the groups, they run on each device's
own groups (``distributed/local.py``: DTensor has no strategy for some
of these ops along a split axis), and each device dispatches into its
own experts' rows alone: the expert products carry the (groups: data,
experts: "model") sharding, the combine leaves each device a partial
sum over its experts, which one all-reduce completes, as GSPMD lowers
the reference's, and the dispatch buffer's gradient stays on its device
(the tokens' gradient is a partial sum over the experts, completed once
with the block's).  The router runs on each device's own tokens, its
sort local.

No host sync and no data-dependent shape: the capacity comes from shapes,
the dispatched buffer is ``(E * C + 1, d)`` with the overflow row last,
and no mask indexing, ``nonzero`` or ``.item()`` runs here, so a decode
step with MoE blocks is capturable as a CUDA graph.  The reference
computes these products as plain einsums outside any Pallas kernel, so
no hand-written kernel takes their place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import tracing
from repro_torch.distributed.local import complete, localize, placed, span
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
    aux_loss 0-dim f32).  On a mesh it runs on each device's own tokens
    (``_topk_routing_local``)."""
    if isinstance(logits, DTensor):
        return _topk_routing_local(logits, k)
    T, E = logits.shape
    probs, top_p, top_ids, one_hot = _route(logits, k)
    # Switch aux loss: E * sum_e (fraction_tokens_e * mean_prob_e)
    tokens_per_expert = one_hot.sum(dim=(0, 1)) / (T * k)
    mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(tokens_per_expert * mean_prob)
    return top_p, top_ids, aux


def _route(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """(probabilities (T, E) f32, the top k renormalised (T, k), their
    experts (T, k), the choices one-hot (T, k, E) f32) of ``logits``."""
    probs = torch.softmax(logits.float(), dim=-1)
    sorted_p, sorted_ids = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    top_p, top_ids = sorted_p[:, :k], sorted_ids[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_ids, F.one_hot(top_ids, logits.shape[-1]).float()


def _topk_routing_local(logits: DTensor, k: int
                        ) -> Tuple[DTensor, DTensor, DTensor]:
    """``_topk_routing`` on a mesh, on each device's own tokens: the
    logits' expert axis gathered once, the sort and its backward local
    (no torch version's propagator sees them), the weights and experts
    split as the tokens are, and the aux loss's two (E,) sums over the
    tokens completed by one all-reduce each."""
    mesh, (T, E) = logits.device_mesh, logits.shape
    tokens = [p if p.is_shard(0) else Replicate() for p in logits.placements]
    probs, top_p, top_ids, one_hot = _route(localize(logits, mesh, tokens),
                                            k)
    over = [Partial() if p.is_shard(0) else Replicate() for p in tokens]
    choices, prob_sum = (complete(DTensor.from_local(t, mesh, over,
                                                     run_check=False))
                         for t in (one_hot.sum(dim=(0, 1)),
                                   probs.sum(dim=0)))
    aux = E * torch.sum(choices / (T * k) * (prob_sum / T))
    top_p, top_ids = (DTensor.from_local(t, mesh, tokens, run_check=False)
                      for t in (top_p, top_ids))
    return top_p, top_ids, aux


def _dispatch_slots(expert_ids: torch.Tensor, capacity: int, E: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """expert_ids: (..., N) -> (keep (..., N) bool, slot (..., N) int64)
    along the last axis, by stable-sort counting: a pair's position is
    its rank among the pairs of its expert, in pair order.  The first
    sorted index of each expert is the exclusive cumsum of the per-expert
    counts (the reference's ``searchsorted(side="left")``)."""
    N = expert_ids.shape[-1]
    order = torch.argsort(expert_ids, dim=-1, stable=True)
    sorted_expert = torch.gather(expert_ids, -1, order)
    counts = (sorted_expert[..., None] == torch.arange(
        E, device=expert_ids.device)).sum(dim=-2)             # (..., E)
    seg_start = torch.gather(torch.cumsum(counts, dim=-1) - counts, -1,
                             sorted_expert)
    pos_sorted = torch.arange(N, device=expert_ids.device) - seg_start
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
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
    with tracing.span("moe.dispatch"):
        flat_expert = expert_ids.reshape(-1)                 # (T*k,)
        flat_token = torch.arange(T, device=xf.device)[:, None].expand(
            T, k).reshape(-1)                               # jnp.repeat

        keep, slot = _dispatch_slots(flat_expert, capacity, E)
        safe_slot = torch.where(keep, slot, E * capacity)    # overflow row

        dispatched = xf.new_zeros((E * capacity + 1, d))
        dispatched = dispatched.index_put((safe_slot,), xf[flat_token])
        dispatched = dispatched[:-1].reshape(E, capacity, d)

    with tracing.span("moe.experts"):
        gate = F.silu(_expert_mm(dispatched, params["gate"]))
        up = _expert_mm(dispatched, params["up"])
        expert_out = _expert_mm((gate * up).to(xf.dtype), params["down"])

    with tracing.span("moe.combine"):
        flat_weight = weights.reshape(-1)
        flat_out = expert_out.reshape(E * capacity, d)
        pair_out = torch.where(keep[:, None],
                               flat_out[torch.where(keep, slot, 0)], 0.0)
        pair_out = (pair_out * flat_weight[:, None].to(pair_out.dtype)
                    ).to(xf.dtype).reshape(T, k, d)
        out = torch.zeros((T, d), dtype=xf.dtype, device=xf.device)
        for j in range(k):
            out = out + pair_out[:, j]
    return out


def _dispatch_groups(xg: torch.Tensor, eg: torch.Tensor, capacity: int,
                     E: int, first: int = 0, rows: Optional[int] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """The pair-axis half of a grouped dispatch, within each group: xg (G,
    Tg, d), eg (G, Tg, k) -> (dispatched (G, rows, d), keep (G, Tg * k),
    slot (G, Tg * k)).  Each token's row repeated k times (``jnp.repeat``)
    lands at its pair's slot where the slot is one of the ``rows`` (all E
    * C by default) from ``first``: a device's own experts' on a mesh;
    dropped pairs, and the pairs of other rows, at the overflow row, cut
    off."""
    G, Tg, d = xg.shape
    k = eg.shape[-1]
    rows = E * capacity if rows is None else rows
    keep, slot = _dispatch_slots(eg.reshape(G, Tg * k), capacity, E)
    here = keep & (slot >= first) & (slot < first + rows)
    safe = torch.where(here, slot - first, rows)             # overflow row
    dispatched = xg.new_zeros((G, rows + 1, d)).scatter(
        1, safe[..., None].expand(G, Tg * k, d),
        xg.repeat_interleave(k, dim=1))
    return dispatched[:, :-1], keep, slot


def _combine_groups(flat_out: torch.Tensor, keep: torch.Tensor,
                    slot: torch.Tensor, wg: torch.Tensor, first: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """The combine within each group: flat_out (G, R, d) f32 holds expert
    rows [first, first + R) of the groups' E * C (all of them off a mesh);
    each pair takes its slot's row where it owns it, weighted, and each
    token adds its k pairs in choice order into zeros of ``dtype`` (the
    ordered combine of ``_moe_tokens``).  Returns (G, Tg, d): the sum over
    the experts held here."""
    G, R, d = flat_out.shape
    Tg, k = wg.shape[1:]
    owned = keep & (slot >= first) & (slot < first + R)
    rows = torch.gather(flat_out, 1, torch.where(owned, slot - first, 0)[
        ..., None].expand(G, Tg * k, d))
    pair_out = torch.where(owned[..., None], rows, 0.0)
    pair_out = (pair_out * wg.reshape(G, Tg * k, 1).to(pair_out.dtype)
                ).to(dtype).reshape(G, Tg, k, d)
    out = torch.zeros((G, Tg, d), dtype=dtype, device=flat_out.device)
    for j in range(k):
        out = out + pair_out[:, :, j]
    return out


def _group_placements(xf, G: int) -> list:
    """Placements of the tokens xf (T, d) for a dispatch in G groups: the
    token axis split over the mesh axes that split it now, outer first,
    as long as their sizes multiply to a divisor of G (each device then
    holds whole groups: the data axes, where the batch is split); every
    other axis replicated."""
    mesh, out, pieces = xf.device_mesh, [], 1
    for mdim, p in enumerate(xf.placements):
        if p.is_shard(0) and G % (pieces * mesh.size(mdim)) == 0:
            out.append(p)
            pieces *= mesh.size(mdim)
        else:
            out.append(Replicate())
    return out


def _moe_groups(params, xg: torch.Tensor, wg: torch.Tensor,
                eg: torch.Tensor, capacity: int, E: int) -> torch.Tensor:
    """G dispatch groups as one batched dispatch: xg (G, Tg, d), wg / eg
    (G, Tg, k) -> (G, Tg, d).  On a mesh the pair-axis halves run on each
    device's own groups (the placements of xg's group axis) and its own
    experts (the mesh axes that split the experts' weights and not the
    groups): the dispatch writes only its experts' rows, so the dispatch
    buffer's gradient stays on the device, and the tokens' gradient, like
    the combine's result, is a partial sum over the experts' axes."""
    G, Tg, d = xg.shape
    C = capacity
    with tracing.span("moe.dispatch"):
        if isinstance(xg, DTensor):
            mesh, groups = xg.device_mesh, xg.placements
            experts = [g if g.is_shard(0) else Shard(1) if w.is_shard(0)
                       else Replicate()
                       for g, w in zip(groups, params["gate"].placements)]
            # what reads this device's experts' rows alone: a partial sum
            # over the experts' axes
            partial = [Partial() if p.is_shard(1) else p for p in experts]
            first, rows = span(mesh, experts, 1, E * C)
            dispatched, keep, slot = _dispatch_groups(
                localize(xg, mesh, groups, partial),
                localize(eg, mesh, groups), C, E, first, rows)
            dispatched = DTensor.from_local(dispatched, mesh, experts,
                                            run_check=False)
        else:
            dispatched, keep, slot = _dispatch_groups(xg, eg, C, E)
    with tracing.span("moe.experts"):
        # (G, E, C, d) -> (E, G * C, d): the experts' batched products
        a = dispatched.reshape(G, E, C, d).transpose(0, 1).reshape(
            E, G * C, d)
        gate = F.silu(_expert_mm(a, params["gate"]))
        up = _expert_mm(a, params["up"])
        expert_out = _expert_mm((gate * up).to(xg.dtype), params["down"])
        flat_out = expert_out.reshape(E, G, C, d).transpose(0, 1).reshape(
            G, E * C, d)
    with tracing.span("moe.combine"):
        if not isinstance(flat_out, DTensor):
            return _combine_groups(flat_out, keep, slot, wg, 0, xg.dtype)
        # the combine reads the weights of this device's experts' pairs
        # alone
        out = _combine_groups(localize(flat_out, mesh, experts), keep, slot,
                              localize(wg, mesh, groups, partial), first,
                              xg.dtype)
        return DTensor.from_local(out, mesh, partial, run_check=False)


def apply_moe(params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> (out (B, L, d), aux_loss 0-dim f32).

    With ``moe.dispatch_groups = G`` (and T divisible by G) the tokens are
    dispatched in G groups of T/G, each with its own capacity, as one
    batched dispatch (``_moe_groups``), the reference's vmap over
    groups."""
    moe = cfg.moe
    B, L, d = x.shape
    T = B * L
    E, k = moe.num_experts, moe.experts_per_token
    xf = x.reshape(T, d)

    with tracing.span("moe.route"):
        logits = xf @ params["router"]
        weights, expert_ids, aux = _topk_routing(logits, k)  # (T, k)

    G = moe.dispatch_groups or 1
    if G == 1 or T % G != 0:
        capacity = max(int(math.ceil(T * k / E * moe.capacity_factor)), k)
        out = _moe_tokens(params, xf, weights, expert_ids, capacity, E, k)
        return complete(out.reshape(B, L, d)), aux.float()

    Tg = T // G
    capacity = max(int(math.ceil(Tg * k / E * moe.capacity_factor)), k)
    if isinstance(xf, DTensor):
        groups = _group_placements(xf, G)
        xf, weights, expert_ids = (placed(t, xf.device_mesh, groups)
                                   for t in (xf, weights, expert_ids))
    out = _moe_groups(params, xf.reshape(G, Tg, d),
                      weights.reshape(G, Tg, k),
                      expert_ids.reshape(G, Tg, k), capacity, E
                      ).reshape(B, L, d)
    # the combine's one all-reduce, after the view back to (B, L, d): the
    # view's gradient then comes back whole over the experts' axes, where
    # one split finer than the groups would fall back
    return complete(out), aux.float()
