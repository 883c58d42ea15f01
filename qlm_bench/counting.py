"""The yardstick's arithmetic: the card's peaks, what an attention launch
must move and compute, and the model FLOPs of a token.

``attn_bytes`` and ``bound`` are copies of ``chip_smoke.py``'s; the
prefill's work counts what the inputs need (the valid rows' queries and
outputs, the prefix and the chunk's keys), not the padding rows a kernel
may compute besides.  A layer with a ``window`` attends, at position
``p``, over the keys in ``(p - window, p]``; ``window`` None is full
attention.  ``layers`` are a family's ``attention_layers(model)``:
``(count, H, KVH, D, window)`` groups.
"""
from __future__ import annotations

from typing import Optional, Sequence

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


def keys(a: int, b: int, window: Optional[int]) -> float:
    """Keys read by the queries at contexts ``a + 1``..``b`` (positions
    ``a``..``b - 1``): ``min(context, window)`` each."""
    if window is None or b <= window:
        return (b * (b + 1) - a * (a + 1)) / 2
    if a >= window:
        return (b - a) * window
    return (window * (window + 1) - a * (a + 1)) / 2 + (b - window) * window


def decode_least_s(esize: int, H: int, KVH: int, D: int,
                   contexts: Sequence[int], window: Optional[int] = None
                   ) -> float:
    """One paged decode launch: each live sequence's query against its
    ``context`` keys (its cached tokens and the new one), or the last
    ``window`` of them."""
    kv = sum(contexts) if window is None \
        else sum(min(c, window) for c in contexts)
    return bound_s(attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=len(contexts),
                              kv_rows=kv), 4.0 * H * D * kv)


def prefill_least_s(esize: int, H: int, KVH: int, D: int,
                    starts: Sequence[int], valid: Sequence[int],
                    window: Optional[int] = None) -> float:
    """One paged prefill launch: each row's ``valid`` chunk tokens against
    its ``starts`` cached tokens and, causally, the chunk's own; with a
    ``window``, the cached tokens the chunk's first query still reads."""
    if window is None:
        work = sum(v * s + v * (v + 1) / 2 for s, v in zip(starts, valid))
        prefix = sum(starts)
    else:
        work = sum(keys(s, s + v, window) for s, v in zip(starts, valid))
        prefix = sum(min(s, window - 1) for s in starts)
    flops = 4.0 * H * D * work
    rows = sum(valid)
    return bound_s(attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=rows,
                              kv_rows=prefix, chunk_rows=rows), flops)


def token_flops(model: dict, layers, context: int, logits: bool) -> float:
    """Model FLOPs of one token at position ``context - 1``: two per
    multiply-add of every projection it passes (a mixture's router and
    its top-k experts only), attention over its ``context`` keys, or a
    window's, (QK and PV), and the unembedding when it yields
    ``logits``."""
    d = model["d_model"]
    moe = model.get("moe")
    if moe:
        ffn = moe["experts_per_token"] * 3 * d * moe["d_ff_expert"] \
            + d * moe["num_experts"]
    else:
        ffn = 3 * d * model["d_ff"]
    body = 0.0
    for count, H, KVH, D, window in layers:
        proj = d * H * D * 2 + d * KVH * D * 2
        seen = context if window is None else min(context, window)
        body += count * (2.0 * (proj + ffn) + 4.0 * H * D * seen)
    head = 2.0 * d * model["vocab_size"] if logits else 0.0
    return body + head


def prompt_flops(model: dict, layers, start: int, end: int, logits: bool
                 ) -> float:
    """Model FLOPs of prompt positions ``start``..``end - 1``, each as
    ``token_flops`` at its own context; with ``logits`` the last one
    yields the first token's logits."""
    if end <= start:
        return 0.0
    n = end - start
    base = token_flops(model, layers, 0, False)
    attn = 0.0
    for count, H, KVH, D, window in layers:
        attn += count * 4.0 * H * D * keys(start, end, window)
    return (n * base + attn
            + (2.0 * model["d_model"] * model["vocab_size"] if logits
               else 0.0))
