"""The yardstick's arithmetic: the card's peaks, what an attention launch
must move and compute, and the model FLOPs of a token.

``attn_bytes`` and ``bound`` are copies of ``chip_smoke.py``'s; the
prefill's work counts what the inputs need (the valid rows' queries and
outputs, the prefix and the chunk's keys), not the padding rows a kernel
may compute besides.
"""
from __future__ import annotations

from typing import Sequence

# one NVIDIA H100 SXM (data sheet, dense rates at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def attn_bytes(esize: int, *, H: int, KVH: int, D: int, q_rows: int,
               kv_rows: int, chunk_rows: int = 0, out_rows=None) -> float:
    """Bytes an attention call must move: q (``q_rows`` query tokens) and
    out (``out_rows``, default ``q_rows``), the live k/v rows and a
    prefill chunk's own k/v."""
    out_rows = q_rows if out_rows is None else out_rows
    return ((q_rows + out_rows) * H * D * esize + 2 * kv_rows * KVH * D * esize
            + 2 * chunk_rows * KVH * D * esize)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a call on the card: bytes at the HBM rate or
    operations at the bf16 tensor-core rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def decode_least_s(esize: int, H: int, KVH: int, D: int,
                   contexts: Sequence[int]) -> float:
    """One paged decode launch: each live sequence's query against its
    ``context`` keys (its cached tokens and the new one)."""
    kv = sum(contexts)
    return bound_s(attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=len(contexts),
                              kv_rows=kv), 4.0 * H * D * kv)


def prefill_least_s(esize: int, H: int, KVH: int, D: int,
                    starts: Sequence[int], valid: Sequence[int]) -> float:
    """One paged prefill launch: each row's ``valid`` chunk tokens against
    its ``starts`` cached tokens and, causally, the chunk's own."""
    flops = 4.0 * H * D * sum(v * s + v * (v + 1) / 2
                              for s, v in zip(starts, valid))
    rows = sum(valid)
    return bound_s(attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=rows,
                              kv_rows=sum(starts), chunk_rows=rows), flops)


def token_flops(model: dict, context: int, logits: bool) -> float:
    """Model FLOPs of one token at position ``context - 1``: two per
    multiply-add of every projection it passes (a mixture's router and
    its top-k experts only), attention over its ``context`` keys (QK and
    PV), and the unembedding when it yields ``logits``."""
    d, H, KVH = model["d_model"], model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    proj = d * H * hd * 2 + d * KVH * hd * 2
    moe = model.get("moe")
    if moe:
        ffn = moe["experts_per_token"] * 3 * d * moe["d_ff_expert"] \
            + d * moe["num_experts"]
    else:
        ffn = 3 * d * model["d_ff"]
    per_layer = 2.0 * (proj + ffn) + 4.0 * H * hd * context
    head = 2.0 * d * model["vocab_size"] if logits else 0.0
    return model["num_layers"] * per_layer + head


def prompt_flops(model: dict, start: int, end: int, logits: bool) -> float:
    """Model FLOPs of prompt positions ``start``..``end - 1``, each as
    ``token_flops`` at its own context; with ``logits`` the last one
    yields the first token's logits."""
    if end <= start:
        return 0.0
    n = end - start
    base = token_flops(model, 0, False)
    d, H = model["d_model"], model["num_heads"]
    hd = model.get("head_dim") or d // H
    contexts = (end * (end + 1) - start * (start + 1)) / 2
    return (n * base + model["num_layers"] * 4.0 * H * hd * contexts
            + (2.0 * d * model["vocab_size"] if logits else 0.0))
