"""Request / SLO model (paper §2.3 Definitions 2.1–2.3).

A request = prompt tokens + metadata (model type, SLO).  The SLO is on
p99 time-to-first-token (TTFT).  Paper workload classes (§8):
Interactive 20 s, Batch-1 60 s, Batch-2 3600 s.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional

_req_counter = itertools.count()

# paper §8 SLO classes (seconds, p99 TTFT)
SLO_INTERACTIVE = 20.0
SLO_BATCH1 = 60.0
SLO_BATCH2 = 3600.0

SLO_CLASSES = {
    "interactive": SLO_INTERACTIVE,
    "batch1": SLO_BATCH1,
    "batch2": SLO_BATCH2,
}


@dataclasses.dataclass
class Request:
    prompt_tokens: Any                 # list[int] / np.ndarray
    model: str                         # model type the request targets
    slo: float                         # TTFT SLO in seconds
    arrival_time: float = 0.0
    max_new_tokens: int = 128
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    slo_class: str = ""
    # strict priority (§9): lower = more urgent; 0 = default
    priority: int = 0

    # lifecycle (filled by the runtime / simulator)
    group_id: Optional[int] = None
    first_token_time: Optional[float] = None
    # when a slot first took the request, on the engine's clock: the end
    # of its wait in the queue.  Kept across eviction, resume and
    # restart(), as first_token_time is
    admit_time: Optional[float] = None
    completion_time: Optional[float] = None
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    n_evictions: int = 0
    # eviction snapshot handle (host-side KV/state copy), engine-internal
    snapshot: Any = None
    generated: int = 0
    # modality extras (VLM patch embeds / audio frame embeds), passed to prefill
    extras: Any = None
    # ground-truth output length (simulator only; unknown to the scheduler)
    true_output_tokens: Optional[int] = None
    # prompt tokens served from the shared-prefix KV cache instead of
    # prefill.  The real engine fills it at admission (observability); the
    # simulator consumes it as ground truth — like true_output_tokens —
    # to skip prefill work / KV for the shared leading run.
    prefix_shared_tokens: int = 0
    # multi-turn session bookkeeping (data.workload.Session): follow-up
    # requests re-enter the queue carrying the previous turns' tokens as a
    # prompt prefix, so the prefix index serves real session traffic
    session_id: Optional[int] = None
    turn: int = 0
    # async front-end lifecycle (serving.frontend): set by the client /
    # server, observed by the queue layer's accounting
    cancel_requested: bool = False   # client asked; server acts on next sweep
    cancelled: bool = False          # cancellation executed (KV freed)
    rejected: bool = False           # 429'd by admission control / backpressure
    expired: bool = False            # deadline passed before any dispatch
    shed: bool = False               # dropped by the SLO-pressure shedder
    # fault tolerance (§4: the global queue survives engine death):
    # redelivery count, earliest re-dispatch time (exponential backoff),
    # and the poison-quarantine terminal flag — a request whose retry
    # budget is exhausted is FAILED, a recorded SLO miss, never retried
    redeliveries: int = 0
    not_before: float = 0.0
    failed: bool = False
    fail_cause: Optional[str] = None
    # scheduling flag: currently in a running batch
    _in_flight: bool = False
    # instance id currently serving this request (set by the pulling
    # agent, cleared on every path that returns it to the queue) — the
    # supervisor uses it to find a dead engine's in-flight requests
    _served_by: Optional[int] = None
    # chunked-prefill progress kept across evictions (simulator mirror of
    # the engine's snapshot["prefill_pos"])
    _prefill_done: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def deadline(self) -> float:
        return self.arrival_time + self.slo

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def slo_met(self) -> Optional[bool]:
        t = self.ttft()
        return None if t is None else (t <= self.slo)

    def itl(self) -> Optional[float]:
        """Mean inter-token latency (§9 'Can SLOs be defined on ITL?' —
        QLM tracks it so an Andes-style ITL guard can consume it)."""
        if self.completion_time is None or self.first_token_time is None:
            return None
        if self.generated <= 1:
            return 0.0
        return (self.completion_time - self.first_token_time) / (self.generated - 1)

    def finished(self) -> bool:
        return self.completion_time is not None

    def dropped(self) -> bool:
        """Terminated without service: rejected at the door, expired past
        its deadline unstarted, shed by the overload policy, quarantined
        after exhausting its redelivery budget, or cancelled before the
        first token.  A definite SLO miss (except client cancellation,
        which is excluded from attainment accounting)."""
        return (self.rejected or self.expired or self.shed or self.failed
                or (self.cancelled and self.first_token_time is None))

    def restart(self) -> None:
        """Clean-restart for redelivery after its serving engine died with
        the generation state (no snapshot survived): generation progress
        resets so the next engine replays from the prompt.  Greedy decode
        is deterministic, so the regenerated tokens match what any client
        already streamed.  ``first_token_time`` is KEPT when already
        recorded — the first token genuinely reached the client, and
        resetting it would let a crash-and-retry double-count as a fresh
        (later, possibly SLO-missing) first token in attainment.
        ``admit_time`` is kept likewise: the request left the queue then."""
        self.output_tokens.clear()
        self.generated = 0
        self._prefill_done = 0
        self.snapshot = None


def make_request(prompt_tokens, model: str, slo_class: str,
                 arrival_time: float = 0.0, max_new_tokens: int = 128) -> Request:
    return Request(prompt_tokens=prompt_tokens, model=model,
                   slo=SLO_CLASSES[slo_class], arrival_time=arrival_time,
                   max_new_tokens=max_new_tokens, slo_class=slo_class)
