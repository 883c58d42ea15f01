"""Global scheduler (paper §7): RWT-triggered virtual-queue reordering.

Invoked when the RWT estimator predicts an SLO violation; builds the MILP
(``core.solver``) from current request groups + per-instance hardware
profiles (heterogeneity enters via each instance's HardwareProfile — §3.2
Design Principle #3) and rewrites every virtual queue's group order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch import tracing
from repro_torch.core.request_group import RequestGroup
from repro_torch.core.rwt_estimator import HardwareProfile, RWTEstimator
from repro_torch.core.solver import GroupSpec, InstanceSpec, Solution, solve
from repro_torch.core.virtual_queue import VirtualQueue


@dataclasses.dataclass
class InstanceInfo:
    """Scheduler view of one LLM serving instance."""
    instance_id: int
    hw_by_model: Dict[str, HardwareProfile]  # per-model profile on THIS device
    current_model: Optional[str]
    virtual_queue: VirtualQueue

    def hw(self, model: str) -> HardwareProfile:
        return self.hw_by_model[model]

    def swap_times(self) -> Dict[str, float]:
        return {m: hw.swap_time for m, hw in self.hw_by_model.items()}


class GlobalScheduler:
    def __init__(self, estimator: Optional[RWTEstimator] = None, seed: int = 0,
                 exact_threshold: int = 0, objective: str = "penalty"):
        self.estimator = estimator or RWTEstimator()
        self.seed = seed
        self.exact_threshold = exact_threshold
        self.objective = objective
        self.invocations = 0

    # ------------------------------------------------------------------
    def build_specs(self, groups: Sequence[RequestGroup],
                    instances: Sequence[InstanceInfo], now: float):
        gspecs: List[GroupSpec] = []
        for g in groups:
            wl = g.workload_profile()
            drain = {}
            for inst in instances:
                if g.model not in inst.hw_by_model:
                    drain[inst.instance_id] = math.inf  # can't serve here
                    continue
                est = self.estimator.group_drain_time(
                    len(g.pending()), wl, inst.hw(g.model),
                    prompt_tokens=wl.mu_input)
                drain[inst.instance_id] = est.conservative(self.estimator.z)
            gspecs.append(GroupSpec(
                group_id=g.group_id, model=g.model,
                slo=max(g.earliest_deadline() - now, 0.0), drain_time=drain,
                size=float(len(g.pending()))))
        ispecs = [InstanceSpec(inst.instance_id, inst.current_model,
                               inst.swap_times()) for inst in instances]
        return gspecs, ispecs

    def schedule(self, groups: Sequence[RequestGroup],
                 instances: Sequence[InstanceInfo], now: float) -> Solution:
        """Solve and APPLY the new virtual-queue orders.

        If Eq. 12 is infeasible (demand > capacity) the paper §9(b) falls
        back to EDF and keeps serving (option (a), scale-up, needs new
        hardware; option (c), admission control, drops requests).  The
        solver's min-total-penalty order can sacrifice many small deadlines
        for one large group, so EDF is the better attainment heuristic in
        that regime — we compare both and keep the EDF fallback's behavior
        whenever the solve is infeasible.
        """
        self.invocations += 1
        live = [g for g in groups if not g.done()]
        gspecs, ispecs = self.build_specs(live, instances, now)
        sol = solve(gspecs, ispecs, exact_threshold=self.exact_threshold,
                    seed=self.seed + self.invocations,
                    objective=self.objective)
        if not sol.feasible:
            self._edf_fallback(live, instances)
            return sol
        by_idx = {i: g for i, g in enumerate(live)}
        for qi, inst in enumerate(instances):
            inst.virtual_queue.set_order([by_idx[gi] for gi in sol.assignment[qi]])
        return sol

    @staticmethod
    def _edf_fallback(groups: Sequence[RequestGroup],
                      instances: Sequence[InstanceInfo]) -> None:
        """§9(b): EDF over groups with model-affinity tiebreak (deadline
        first; groups of the instance's resident model keep their place)."""
        for inst in instances:
            inst.virtual_queue.set_order([])
        for g in sorted(groups, key=lambda g: g.earliest_deadline()):
            candidates = [i for i in instances if g.model in i.hw_by_model]
            if not candidates:
                # no surviving instance serves this model (capacity loss):
                # leave the group unplaced — the controller quarantines
                # unservable requests before re-solving, so reaching here
                # means the stranded-group invariant will name it
                continue
            inst = min(candidates,
                       key=lambda i: (0 if (i.virtual_queue.models_in_order() or
                                            [i.current_model])[-1] == g.model else 1,
                                      i.virtual_queue.pending_requests()))
            inst.virtual_queue.groups.append(g)

    # ------------------------------------------------------------------
    @tracing.spanned("qlm.predict_violation")
    def predict_violation(self, instances: Sequence[InstanceInfo],
                          now: float) -> bool:
        """Walk each VQ accumulating RWT drain estimates; violation iff some
        group's predicted completion exceeds its deadline slack (§4
        "Handling New Incoming Requests")."""
        return bool(self.violations(instances, now))

    def violations(self, instances: Sequence[InstanceInfo], now: float,
                   slo_ceiling: Optional[float] = None,
                   inflight: Optional[Sequence[float]] = None
                   ) -> List[InstanceInfo]:
        """The instances whose VQ walk predicts a deadline violation.

        A queued group whose model is missing from this instance's
        ``hw_by_model`` is SKIPPED from the estimate rather than reported
        as a violation: re-solving cannot improve a persistent
        model/instance mismatch, so flagging it forever would make the
        controller re-solve every cooldown tick with no possible
        improvement (``QLMController.submit`` raises once, at submit time,
        when no instance at all can serve the model).

        ``slo_ceiling`` restricts which groups' deadlines COUNT as
        violations (e.g. ``SLO_INTERACTIVE`` → only interactive-class
        groups trigger) — every servable group still contributes its drain
        time to the walk, since batch work ahead of an interactive group
        is exactly what delays it.  The overload shedder uses this to act
        only when *interactive* traffic is at risk.

        ``inflight`` (seconds per instance, aligned with ``instances``)
        seeds each walk with the drain time of work already RESIDENT in
        that instance's engine slots.  The VQ alone under-predicts: a
        queued interactive group behind an empty VQ still waits for a
        running batch decode to free a slot.
        """
        out: List[InstanceInfo] = []
        for idx, inst in enumerate(instances):
            t = float(inflight[idx]) if inflight is not None else 0.0
            cur = inst.current_model
            for g in inst.virtual_queue.groups:
                if g.done():
                    continue
                if g.model not in inst.hw_by_model:
                    continue  # unservable here: no estimate possible
                hw = inst.hw(g.model)
                if g.model != cur:
                    t += hw.swap_time
                    cur = g.model
                wl = g.workload_profile()
                est = self.estimator.group_drain_time(
                    len(g.pending()), wl, hw, prompt_tokens=wl.mu_input)
                t += est.conservative(self.estimator.z)
                if now + t > g.earliest_deadline() \
                        and (slo_ceiling is None or g.slo <= slo_ceiling):
                    out.append(inst)
                    break
        return out
