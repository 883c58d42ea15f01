"""The one traffic generator: turns a mix's parameters (``traffic/<mix>.json``,
with the cell's own values from ``cells/<cell>.json`` laid over them) and
a seed into an arrival schedule.

Arrivals are a Poisson process of ``rate`` requests a second over the
lead-in and the window: exponential gaps drawn until the horizon, in the
order drawn.  Each request then draws its class in the classes' shares,
whether it is a long ("mega") prompt in the mega share, and its prompt and
output lengths.  All of that comes from the mix's fixed ``base_seed``, so
every seed gets the same schedule; ``--seed`` draws the prompts' token ids
(and, in the harness, the weights).

Lengths are lognormal (``mu``, ``sigma`` of the log), rounded down and
clipped to ``[min, max]``.  A mega request takes the paper's W_C mega
prompt lengths instead: input and output lognormal, their total scaled
into ``[total_min, total_max]`` (``data/sharegpt_synth.py``'s
``sample_lengths``, of which this is a copy).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Arrival:
    due: float                 # seconds after the lead-in starts
    prompt: np.ndarray         # int32 token ids
    max_new_tokens: int
    cls: str
    ttft_s: float              # the class's time-to-first-token limit


def _lognormal(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    x = rng.lognormal(spec["mu"], spec["sigma"], n)
    return np.clip(x, spec.get("min", 1), spec.get("max", np.inf)).astype(int)


def poisson_due(rng: np.random.Generator, rate: float, horizon: float
                ) -> np.ndarray:
    """Arrival times of a Poisson process of ``rate`` in ``[0, horizon)``."""
    due, t = [], rng.exponential(1.0 / rate)
    while t < horizon:
        due.append(t)
        t += rng.exponential(1.0 / rate)
    return np.asarray(due, float)


def schedule(traffic: dict, seed: int, seconds: float, vocab: int
             ) -> List[Arrival]:
    """The arrivals of one run, sorted by due time."""
    if traffic["arrivals"]["process"] != "poisson":
        raise ValueError(f"unknown arrival process "
                         f"{traffic['arrivals']['process']!r}")
    base = np.random.default_rng(traffic["base_seed"])
    due = poisson_due(base, traffic["rate"],
                      traffic.get("lead_in_s", 0.0) + seconds)
    n = len(due)
    classes = traffic["classes"]
    shares = np.asarray([c["share"] for c in classes], float)
    labels = base.choice(len(classes), size=n, p=shares / shares.sum())
    ins = _lognormal(base, n, traffic["lengths"]["input"])
    outs = _lognormal(base, n, traffic["lengths"]["output"])
    mega = traffic.get("mega")
    if mega:
        is_mega = base.random(n) < mega["share"]
        mi = _lognormal(base, n, mega["input"])
        mo = _lognormal(base, n, mega["output"])
        total = mi + mo
        scale = np.clip(total, mega["total_min"], mega["total_max"]) \
            / np.maximum(total, 1)
        ins = np.where(is_mega, np.maximum((mi * scale).astype(int), 1), ins)
        outs = np.where(is_mega, np.maximum((mo * scale).astype(int), 1),
                        outs)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = classes[labels[i]]
        prompt = rng.integers(0, vocab, size=int(ins[i]), dtype=np.int64)
        out.append(Arrival(float(due[i]), prompt.astype(np.int32),
                           int(outs[i]), c["name"], float(c["ttft_s"])))
    return out
