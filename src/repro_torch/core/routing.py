"""Slice-level load-balancing routing (PAPERS.md: "Slice-Level
Scheduling for High-Throughput and Load-Balanced LLM Serving").

The MILP solver places whole REQUEST GROUPS — its placement granularity
is the group, so one oversized group (up to ``avg_batch_size * delta``
requests) lands on one instance no matter how idle its siblings are, and
on a heterogeneous cluster the slow engine can inherit a monolith the
fast engines can't help with.  Slice-level routing re-partitions the
queue into SLICES of at most ``slice_size`` requests (one engine batch
quantum by default) and places each slice independently by estimated
earliest finish, so a hot group spreads across instances proportionally
to their calibrated speed.

The policy plugs in below the controller: ``QLMConfig.routing =
"slice"`` makes ``QLMController.reschedule`` call ``slice_schedule``
instead of ``GlobalScheduler.schedule``.  Everything downstream (VQ
pulls, LSO sync, invariants) is unchanged — slices ARE request groups,
so the single-placement / single-ownership invariants hold by
construction.

Head-to-head comparison against the solver placement:
``launch/serve.py --routing slice|solver`` (and ``--compare-routing``)
reports attainment and the per-instance estimated makespans
(``estimated_makespans`` here, ``per_instance_makespan`` in
``core/solver.py`` for a solver ``Solution``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

from repro_torch.core.request_group import RequestGroup

ROUTING_POLICIES = ("solver", "slice")


def slice_groups(groups: Sequence[RequestGroup],
                 slice_size: int) -> List[RequestGroup]:
    """Re-partition oversized groups into FCFS-contiguous slices of at
    most ``slice_size`` members.  Groups already within the quantum are
    kept BY IDENTITY (no group-id churn: the agents' head-change
    eviction LSO fires on id change, so stable groups must keep stable
    ids).  Members move wholesale — in-flight and finished members ride
    along with their slice (pull paths skip both; cursors are
    per-group and fresh slices start at zero)."""
    out: List[RequestGroup] = []
    for g in groups:
        if g.done():
            continue
        if g.size() <= slice_size:
            out.append(g)
            continue
        members = list(g.requests)
        for lo in range(0, len(members), slice_size):
            chunk = members[lo:lo + slice_size]
            s = RequestGroup(model=g.model,
                             slo=min(r.slo for r in chunk))
            for r in chunk:
                s.add(r)
            out.append(s)
    return out


def estimated_makespans(instances: Sequence, estimator, *,
                        now: float = 0.0,
                        z: Optional[float] = None) -> List[float]:
    """Per-instance RWT-estimated drain of the CURRENT virtual-queue
    orders (swap-aware walk, conservative bound) — the load-balance
    metric the routing comparison reports: a flat vector means the
    placement matched work to capacity."""
    z = estimator.z if z is None else z
    out: List[float] = []
    for inst in instances:
        t = 0.0
        cur = inst.current_model
        for g in inst.virtual_queue.groups:
            if g.done() or g.model not in inst.hw_by_model:
                continue
            hw = inst.hw(g.model)
            if g.model != cur:
                t += hw.swap_time
                cur = g.model
            wl = g.workload_profile()
            est = estimator.group_drain_time(len(g.pending()), wl, hw,
                                             prompt_tokens=wl.mu_input)
            t += est.conservative(z)
        out.append(t)
    return out


def slice_schedule(controller, now: float) -> List[RequestGroup]:
    """Slice the live groups and place every slice by estimated earliest
    finish (EDF consideration order, swap-aware, heterogeneity-aware via
    each instance's calibrated per-model profile).  Applies the new VQ
    orders on the SCHEDULABLE instances and replaces
    ``controller.groups`` with the slice partition.  Returns the placed
    slices.  Must run under the controller lock (``reschedule`` holds
    it)."""
    cfg = controller.cfg
    slice_size = cfg.slice_size or max(1, int(cfg.avg_batch_size))
    slices = slice_groups(controller.groups, slice_size)
    controller.groups = slices
    instances = controller.schedulable_instances()
    if not instances:
        return slices
    estimator = controller.estimator

    orders: List[List[RequestGroup]] = [[] for _ in instances]
    tails = [(0.0, inst.current_model) for inst in instances]
    # EDF consideration order: urgent slices grab the fast tails first
    for s in sorted(slices, key=lambda g: g.earliest_deadline()):
        best_qi, best_finish = None, math.inf
        wl = s.workload_profile()
        for qi, inst in enumerate(instances):
            if s.model not in inst.hw_by_model:
                continue
            t, cur = tails[qi]
            hw = inst.hw(s.model)
            dt = hw.swap_time if s.model != cur else 0.0
            est = estimator.group_drain_time(len(s.pending()), wl, hw,
                                             prompt_tokens=wl.mu_input)
            finish = t + dt + est.conservative(estimator.z)
            if finish < best_finish:
                best_qi, best_finish = qi, finish
        if best_qi is None:
            # no schedulable instance serves this model: leave the slice
            # unplaced — the controller quarantines unservable work
            # before re-placing, so reaching here is transient
            continue
        orders[best_qi].append(s)
        tails[best_qi] = (best_finish, s.model)
    for qi, inst in enumerate(instances):
        inst.virtual_queue.set_order(orders[qi])
    return slices
