"""Strict request priorities (paper §9 "How can QLM handle request
priorities?").

In the strict-priority model, every request of priority p executes before
any request of priority p+1; WITHIN a priority level the virtual-queue /
request-group / RWT machinery still optimizes SLO attainment.  Implemented
as a level-by-level solve: each priority level is scheduled onto queue
TAILS left by the levels above it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

from repro_torch.core.global_scheduler import GlobalScheduler, InstanceInfo
from repro_torch.core.request_group import RequestGroup
from repro_torch.core.solver import GroupSpec, InstanceSpec, solve


class PriorityScheduler(GlobalScheduler):
    """Groups carry the MIN priority of their members (requests are grouped
    within a priority level by the controller)."""

    @staticmethod
    def group_priority(g: RequestGroup) -> int:
        return min((getattr(r, "priority", 0) for r in g.requests), default=0)

    def schedule(self, groups: Sequence[RequestGroup],
                 instances: Sequence[InstanceInfo], now: float):
        self.invocations += 1
        live = [g for g in groups if not g.done()]
        by_level: Dict[int, List[RequestGroup]] = defaultdict(list)
        for g in live:
            by_level[self.group_priority(g)].append(g)

        # accumulate orders level by level (higher priority = lower number)
        orders: List[List[RequestGroup]] = [[] for _ in instances]
        tail_model = [inst.current_model for inst in instances]
        last_sol = None
        for level in sorted(by_level):
            lg = by_level[level]
            gspecs, _ = self.build_specs(lg, instances, now)
            ispecs = [InstanceSpec(inst.instance_id, tail_model[qi],
                                   inst.swap_times())
                      for qi, inst in enumerate(instances)]
            sol = solve(gspecs, ispecs, exact_threshold=self.exact_threshold,
                        seed=self.seed + self.invocations,
                        objective=self.objective)
            last_sol = sol
            for qi in range(len(instances)):
                for gi in sol.assignment[qi]:
                    orders[qi].append(lg[gi])
                if sol.assignment[qi]:
                    tail_model[qi] = lg[sol.assignment[qi][-1]].model
        for qi, inst in enumerate(instances):
            inst.virtual_queue.set_order(orders[qi])
        return last_sol
