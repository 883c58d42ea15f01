"""Workload generators (paper §8): Poisson arrivals over ShareGPT-like
token distributions, W_A / W_B / W_C scenario builders, and multi-turn
**sessions** (FAIRSERVE's ``Interaction``/``next_request`` shape) whose
follow-up requests carry the previous turns' tokens as a prompt prefix —
the traffic the prefix index and ``fork_slot`` actually serve.

SLO classes (p99 TTFT): Interactive 20 s, Batch-1 60 s, Batch-2 3600 s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Request, make_request
from repro_torch.data.sharegpt_synth import sample_lengths


@dataclasses.dataclass
class WorkloadSpec:
    name: str
    n_requests: int = 3500
    seed: int = 0
    # class mix: (slo_class, model, fraction)
    mix: Sequence = ()
    arrival_rate: float = 50.0        # requests / second (Poisson)
    burstiness_cv: float = 1.0        # 1.0 = Poisson; >1 via gamma interarrivals
    mega_fraction: float = 0.0


def _arrivals(rng: np.random.Generator, n: int, rate: float, cv: float) -> np.ndarray:
    if cv <= 1.0:
        gaps = rng.exponential(1.0 / rate, n)
    else:  # gamma-distributed interarrivals with CV>1 => bursty
        shape = 1.0 / (cv * cv)
        gaps = rng.gamma(shape, 1.0 / (rate * shape), n)
    return np.cumsum(gaps)


def generate(spec: WorkloadSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    n = spec.n_requests
    ins, outs = sample_lengths(rng, n, spec.mega_fraction)
    arrivals = _arrivals(rng, n, spec.arrival_rate, spec.burstiness_cv)
    fractions = np.array([f for (_, _, f) in spec.mix], float)
    fractions = fractions / fractions.sum()
    classes = rng.choice(len(spec.mix), size=n, p=fractions)
    out: List[Request] = []
    for i in range(n):
        slo_class, model, _ = spec.mix[classes[i]]
        prompt = rng.integers(0, 32000, size=int(ins[i])).tolist()
        r = make_request(prompt, model, slo_class,
                         arrival_time=float(arrivals[i]),
                         max_new_tokens=int(outs[i]))
        r.true_output_tokens = int(outs[i])  # ground truth for the simulator
        out.append(r)
    out.sort(key=lambda r: r.arrival_time)
    return out


# ---------------------------------------------------------------------------
# multi-turn sessions (FAIRSERVE Interaction shape)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Session:
    """A multi-turn interaction: each turn's request prompt is the FULL
    conversation so far (previous prompts + generated outputs) plus that
    turn's fresh tokens, so a follow-up re-entering the queue is a
    shared-prefix hit against the previous turn's published prompt blocks.

    Lifecycle mirrors FAIRSERVE's ``Interaction``: ``next_request(now)``
    materializes the next turn (None when the session is done), the caller
    serves it, then ``complete_turn(req)`` folds prompt+output into the
    history before the next call.
    """
    session_id: int
    model: str
    slo_class: str
    turn_prompts: List[List[int]]          # fresh tokens per turn
    max_new_tokens: int = 16
    think_time_s: float = 0.0              # client-side gap between turns
    arrival_time: float = 0.0              # first turn's arrival
    slo_s: Optional[float] = None          # per-turn TTFT SLO override
    history: List[int] = dataclasses.field(default_factory=list)
    turn: int = 0
    requests: List[Request] = dataclasses.field(default_factory=list)

    def done(self) -> bool:
        return self.turn >= len(self.turn_prompts)

    def next_request(self, now: float) -> Optional[Request]:
        if self.done():
            return None
        prompt = list(self.history) + list(self.turn_prompts[self.turn])
        r = make_request(prompt, self.model, self.slo_class,
                         arrival_time=max(now, self.arrival_time),
                         max_new_tokens=self.max_new_tokens)
        if self.slo_s is not None:
            r.slo = self.slo_s
        r.session_id = self.session_id
        r.turn = self.turn
        self.turn += 1
        self.requests.append(r)
        return r

    def complete_turn(self, req: Request) -> None:
        """Fold a served turn into the conversation history (the next
        turn's prompt prefix)."""
        self.history = list(req.prompt_tokens) + list(req.output_tokens)


@dataclasses.dataclass
class SessionSpec:
    n_sessions: int = 8
    turns: int = 3
    seed: int = 0
    model: str = "vicuna-13b"
    slo_class: str = "interactive"
    arrival_rate: float = 2.0              # sessions / second (Poisson)
    think_time_s: float = 0.0
    prompt_tokens: Tuple[int, int] = (8, 24)   # fresh tokens per turn (lo, hi)
    max_new_tokens: int = 16
    vocab: int = 32000


def generate_sessions(spec: SessionSpec) -> List[Session]:
    """Poisson session arrivals; each session's per-turn fresh token runs
    are pre-sampled so the workload is reproducible under any serving
    order (only the generated outputs — deterministic under greedy
    decoding — vary the history)."""
    rng = np.random.default_rng(spec.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / spec.arrival_rate,
                                         spec.n_sessions))
    lo, hi = spec.prompt_tokens
    out: List[Session] = []
    for s in range(spec.n_sessions):
        prompts = [rng.integers(0, spec.vocab,
                                size=int(rng.integers(lo, hi + 1))).tolist()
                   for _ in range(spec.turns)]
        out.append(Session(session_id=s, model=spec.model,
                           slo_class=spec.slo_class, turn_prompts=prompts,
                           max_new_tokens=spec.max_new_tokens,
                           think_time_s=spec.think_time_s,
                           arrival_time=float(arrivals[s])))
    return out


# ---------------------------------------------------------------------------
# paper scenarios (§8 Workloads)
# ---------------------------------------------------------------------------

def workload_a(arrival_rate: float, n_requests: int = 3500, seed: int = 0,
               model: str = "vicuna-13b") -> List[Request]:
    """W_A: single-model interactive + batch."""
    return generate(WorkloadSpec(
        name="W_A", n_requests=n_requests, seed=seed, arrival_rate=arrival_rate,
        mix=[("interactive", model, 0.4),
             ("batch1", model, 0.3),
             ("batch2", model, 0.3)]))


def workload_b(arrival_rate: float, n_requests: int = 3500, seed: int = 0) -> List[Request]:
    """W_B: multi-model batch.  Batch-1 on two models (mistral-7b-ft,
    llama-70b-ft1); Batch-2 on three (vicuna-13b-ft, llama-70b-ft2, ...)."""
    return generate(WorkloadSpec(
        name="W_B", n_requests=n_requests, seed=seed, arrival_rate=arrival_rate,
        mix=[("batch1", "mistral-7b-ft", 0.25),
             ("batch1", "llama-70b-ft1", 0.25),
             ("batch2", "vicuna-13b-ft", 0.20),
             ("batch2", "llama-70b-ft2", 0.15),
             ("batch2", "vicuna-13b-ft2", 0.15)]))


def workload_c(arrival_rate: float, n_requests: int = 3500, seed: int = 0,
               mega_fraction: float = 0.1, model: str = "vicuna-13b") -> List[Request]:
    """W_C: W_A plus mega prompts (3k–4k total tokens)."""
    return generate(WorkloadSpec(
        name="W_C", n_requests=n_requests, seed=seed, arrival_rate=arrival_rate,
        mega_fraction=mega_fraction,
        mix=[("interactive", model, 0.4),
             ("batch1", model, 0.3),
             ("batch2", model, 0.3)]))
