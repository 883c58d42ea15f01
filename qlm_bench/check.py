"""How ``correct`` is decided: once the window has closed and the port's
state is freed, a sample drawn from the seed of the requests that finished
inside the window, the longest among them, goes through the float32
reference of the configuration's family (``families/<family>.py``'s
``logits``) over each prompt and its served tokens.  At each served token
it reads the gap by which that token's logit lies below the reference's
best at its position.

The numbers compared, and their limits, are the configuration's
``check.limits``: the widest gap (``max_logit_gap``) and the mean gap over
the served tokens (``mean_logit_gap``).  The control (``control.py``) is
judged by the same comparison, on the token that the reference in float8
puts first at each position.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from qlm_bench import families


def sample(requests, seed: int, n: int, budget: int, window: tuple
           ) -> List:
    """Requests that finished inside ``window`` (start, end) with served
    tokens: the longest first, then others in an order drawn from the
    seed, up to ``n`` requests and ``budget`` tokens through the
    reference."""
    ws, we = window
    done = [r for r in requests
            if r.completion_time is not None
            and ws <= r.completion_time <= we and r.output_tokens
            and not r.dropped()]
    if not done:
        return []
    size = lambda r: r.prompt_len + len(r.output_tokens)  # noqa: E731
    longest = max(done, key=size)
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(seed).permutation(len(rest))
    out, total = [longest], size(longest)
    for i in order:
        if len(out) >= n:
            break
        if total + size(rest[i]) <= budget:
            out.append(rest[i])
            total += size(rest[i])
    return out


def served_gaps(logits, model: dict, weights, prompt, served,
                precision: Optional[str] = None) -> torch.Tensor:
    """For one request: at each served token, how far its float32 logit
    lies below the float32 reference's best (0 where it is the best), by
    a family's ``logits``.  With ``precision`` (the control) the token
    judged at each position is the one that reference in that precision
    puts first, on the same prompt and served tokens, in place of the
    served one."""
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


def gaps(config: dict, params, requests, precision: Optional[str] = None,
         bench: Path = families.BENCH) -> torch.Tensor:
    """Every served token's gap below the reference's best, over
    ``requests`` (``served_gaps`` by the configuration's family), as one
    float32 CPU tensor."""
    logits = families.of(config, bench).logits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = [torch.zeros(0)]
    with torch.inference_mode():
        for r in requests:
            out.append(served_gaps(
                logits, config["model"], params, r.prompt_tokens,
                r.output_tokens, precision).float().cpu())
    return torch.cat(out)


def readings(g: torch.Tensor) -> dict:
    """The numbers a limit may be set on: the widest gap, the mean gap, the
    99th percentile and the share of tokens that are not the reference's
    best."""
    if not g.numel():
        return {}
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "p99_logit_gap": float(torch.quantile(g, 0.99)),
            "mismatch_share": float((g > 0).float().mean())}


def judge(config: dict, params, requests, seed: int, window: tuple,
          precision: Optional[str] = None, bench: Path = families.BENCH
          ) -> dict:
    """``correct``: every number the configuration limits is within its
    limit, over a sample of at least one request finished in the window.
    ``precision`` judges the reference in that precision in the port's
    place (the control) on the same sample."""
    rule = config["check"]
    picked = sample(requests, seed, rule["sample_requests"],
                    rule["sample_tokens"], window)
    g = gaps(config, params, picked, precision, bench)
    read = readings(g)
    checks = {"requests_compared": {"value": len(picked), "limit": 1}}
    correct = bool(picked)
    print(f"tokens_compared {g.numel()} of {len(picked)} requests",
          file=sys.stderr)
    print(f"requests_compared {len(picked)} >= 1", file=sys.stderr)
    for name, limit in rule["limits"].items():
        value = read.get(name)
        checks[name] = {"value": value, "limit": limit}
        correct = correct and value is not None and value <= limit
        print(f"{name} {value!r} <= {limit!r}", file=sys.stderr)
    return {"correct": correct, "picked": picked, "readings": read,
            "checks": checks}
