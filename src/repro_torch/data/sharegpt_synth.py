"""Synthetic ShareGPT-like token-length distributions (paper Fig. 8).

No network access in this container, so we fit the published shape: both
input and output token counts in ShareGPT are heavy-tailed with medians
around 30–60 (input) and 150–250 (output), truncated at the 2k context.
Lognormal fits reproduce the Fig. 8 histograms closely enough for the
scheduling experiments (the paper's results depend on the mean/variance
through the RWT estimator, Eq. 3).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDistribution:
    mu_log_input: float = 3.8      # median ≈ 45 input tokens
    sigma_log_input: float = 1.1
    mu_log_output: float = 5.1     # median ≈ 164 output tokens
    sigma_log_output: float = 0.9
    max_tokens: int = 2048

    def sample(self, rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
        ins = np.clip(rng.lognormal(self.mu_log_input, self.sigma_log_input, n),
                      1, self.max_tokens).astype(int)
        outs = np.clip(rng.lognormal(self.mu_log_output, self.sigma_log_output, n),
                       1, self.max_tokens).astype(int)
        return ins, outs


SHAREGPT = TokenDistribution()

# W_C "mega prompts": total input+output in the 3k–4k range (§8 Workloads)
MEGA_PROMPT = TokenDistribution(mu_log_input=7.6, sigma_log_input=0.12,
                                mu_log_output=7.0, sigma_log_output=0.15,
                                max_tokens=4096)


def sample_lengths(rng: np.random.Generator, n: int,
                   mega_fraction: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    ins, outs = SHAREGPT.sample(rng, n)
    if mega_fraction > 0:
        m = rng.random(n) < mega_fraction
        mi, mo = MEGA_PROMPT.sample(rng, int(m.sum()))
        # clip total to the 3k-4k band
        total = mi + mo
        # a zero-length sample would make scale inf/NaN and astype(int)
        # then emits garbage lengths downstream
        scale = np.clip(total, 3000, 4000) / np.maximum(total, 1)
        ins[m] = (mi * scale).astype(int)
        outs[m] = (mo * scale).astype(int)
    return ins, outs
