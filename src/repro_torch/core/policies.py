"""Queue-ordering policies: QLM plus the paper's §8 baselines.

  * ``fcfs``      — vanilla vLLM scheduler (arrival order, no reordering);
  * ``edf``       — Earliest Deadline First over request groups;
  * ``shepherd``  — SHEPHERD-style: deadline-ordered ILP placement with
                    FIXED batches and deterministic worst-case execution
                    estimates (the over-estimation of Fig. 1); realized in
                    the simulator via ``fixed_batch`` execution semantics;
  * ``qlm``       — the full global scheduler (RWT + MILP + LSOs).

Each policy is an ``order(groups, instances, now) -> None`` that rewrites
the virtual queues in place; execution-semantics flags live in
``PolicyTraits``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.global_scheduler import GlobalScheduler, InstanceInfo
from repro_torch.core.request_group import RequestGroup


@dataclasses.dataclass(frozen=True)
class PolicyTraits:
    name: str
    reorders: bool            # may reorder the queue
    uses_eviction: bool       # eviction LSO enabled
    plans_swaps: bool         # model-swap-aware placement
    continuous_batching: bool  # False => SHEPHERD-style fixed batches
    waiting_overestimate: float = 1.0  # multiplicative waiting-time bias
    # (SHEPHERD/Clockwork assume deterministic worst-case exec times: the
    #  paper's Fig. 1 shows they OVER-estimate LLM queue waiting time.)
    # Chunked-prefill quantum (tokens per sequence per iteration), matching
    # the real engine's EngineConfig.prefill_chunk_tokens: prefill cost is
    # spread over iterations that keep decoding, instead of one lump
    # iteration per admission round.  None => legacy lump accounting.
    # The engine additionally clamps its quantum to a model's sliding
    # window (engine._chunk_quantum); HardwareProfile.sliding_window
    # carries the window per (model, device) so the simulator and RWT
    # charge the SAME per-model chunk counts (hw.chunk_quantum()).
    prefill_chunk_tokens: Optional[int] = None


def _least_loaded(instances: Sequence[InstanceInfo]) -> InstanceInfo:
    return min(instances, key=lambda i: i.virtual_queue.pending_requests())


def _spread(groups: List[RequestGroup], instances: Sequence[InstanceInfo],
            keyfn: Callable[[RequestGroup], float]) -> None:
    """Distribute groups over instances; each queue ordered by keyfn."""
    for inst in instances:
        inst.virtual_queue.set_order([])
    for g in sorted(groups, key=keyfn):
        inst = _least_loaded(instances)
        inst.virtual_queue.groups.append(g)


class FCFSPolicy:
    traits = PolicyTraits("vllm", reorders=False, uses_eviction=False,
                          plans_swaps=False, continuous_batching=True)

    def order(self, groups, instances, now):
        live = [g for g in groups if not g.done()]
        _spread(live, instances,
                lambda g: min((r.arrival_time for r in g.pending()), default=math.inf))


class EDFPolicy:
    traits = PolicyTraits("edf", reorders=True, uses_eviction=False,
                          plans_swaps=False, continuous_batching=True)

    def order(self, groups, instances, now):
        live = [g for g in groups if not g.done()]
        _spread(live, instances, lambda g: g.earliest_deadline())


class ShepherdPolicy:
    """Deadline-ordered placement with fixed batching + the conservative
    deterministic waiting estimate (no RWT): over-provisions per Fig. 1."""
    traits = PolicyTraits("shepherd", reorders=True, uses_eviction=False,
                          plans_swaps=False, continuous_batching=False,
                          waiting_overestimate=1.6)

    def order(self, groups, instances, now):
        live = [g for g in groups if not g.done()]
        # SHEPHERD avoids multiplexing models on an instance (§1): bucket
        # groups by model and pin each model to a disjoint instance subset.
        models = sorted({g.model for g in live})
        for inst in instances:
            inst.virtual_queue.set_order([])
        if not live:
            return
        n_inst = len(instances)
        per_model: Dict[str, List[InstanceInfo]] = {}
        for i, m in enumerate(models):
            lo = (i * n_inst) // len(models)  # qlint: disable=unguarded-div -- live is non-empty here (guarded above), so models has >= 1 entry
            hi = max(lo + 1, ((i + 1) * n_inst) // len(models))  # qlint: disable=unguarded-div -- same: models derived from non-empty live
            per_model[m] = list(instances)[lo:hi]
        for g in sorted(live, key=lambda g: g.earliest_deadline()):
            subset = per_model[g.model]
            inst = min(subset, key=lambda i: i.virtual_queue.pending_requests())
            inst.virtual_queue.groups.append(g)


class QLMPolicy:
    traits = PolicyTraits("qlm", reorders=True, uses_eviction=True,
                          plans_swaps=True, continuous_batching=True)

    def __init__(self, scheduler: Optional[GlobalScheduler] = None):
        self.scheduler = scheduler or GlobalScheduler()

    def order(self, groups, instances, now):
        self.scheduler.schedule(groups, instances, now)


POLICIES = {
    "vllm": FCFSPolicy,
    "edf": EDFPolicy,
    "shepherd": ShepherdPolicy,
    "qlm": QLMPolicy,
}


def make_policy(name: str):
    return POLICIES[name]()
