"""Scale-up & admission control (paper §9 / §8.2 / Fig. 1-right).

When the global scheduler cannot find a feasible ordering the paper's
options are (a) scale up serving instances, (b) EDF fallback (implemented
in the scheduler), (c) admission control.  This module implements (a) and
(c):

* ``find_min_instances`` — the Fig. 1 (right) experiment: the smallest
  cluster that keeps SLO attainment above a target, per policy.  QLM's
  better multiplexing needs fewer devices than systems that split
  batch/interactive or per-model (the paper's 2-vs-4-GPU example).
* ``AdmissionController`` — drop/reject requests once the estimated queue
  drain exceeds a bound (§9 option (c)).
* ``ReplacementPolicy`` — the self-healing half of (a): replace departed
  (dead/drained) instances and scale out, driven by REAL cluster signals
  (lost-capacity fraction, RWT-estimated queue drain) instead of
  synthetic ones.  The actuator is
  ``QLMController.replace_instance``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.request import Request
from repro_torch.core.rwt_estimator import HardwareProfile, RWTEstimator, WorkloadProfile


def find_min_instances(run_with_n: Callable[[int], Dict[str, float]],
                       *, slo_target: float = 0.99,
                       lo: int = 1, hi: int = 16) -> Dict[str, object]:
    """Binary search the smallest instance count meeting ``slo_target``.

    ``run_with_n(n)`` runs the workload on an n-instance cluster and
    returns the metrics dict (ClusterSimulator.run).
    """
    results: Dict[int, float] = {}

    def ok(n: int) -> bool:
        if n not in results:
            results[n] = run_with_n(n)["slo_attainment"]
        return results[n] >= slo_target

    if not ok(hi):
        return {"min_instances": None, "attainment_by_n": results}
    while lo < hi:
        mid = (lo + hi) // 2
        if ok(mid):
            hi = mid
        else:
            lo = mid + 1
    return {"min_instances": hi, "attainment_by_n": results}


@dataclasses.dataclass
class AdmissionController:
    """§9(c): reject incoming requests when the RWT-estimated queue drain
    already exceeds ``max_drain_s`` (rate limiting keeps the queue bounded
    so admitted requests can still meet SLOs).

    ``hw`` must be the CALIBRATED profile of the instances that can serve
    the request's model, and ``n_instances`` the number of schedulable
    such instances: the gate sees the cluster-wide queue depth, so
    dividing it by a single instance's throughput over-rejects by a
    factor of the cluster size (the ``--admit-drain slo``
    over-rejection on small-model CPU setups)."""
    estimator: RWTEstimator
    hw: HardwareProfile
    max_drain_s: float
    n_instances: int = 1
    rejected: List[Request] = dataclasses.field(default_factory=list)

    def admit(self, req: Request, queue_pending_requests: int,
              wl: Optional[WorkloadProfile] = None) -> bool:
        wl = wl or WorkloadProfile(req.prompt_len, 1.0,
                                   float(req.max_new_tokens), 1.0)
        # load-balanced split: each serving instance drains its share of
        # the queue, so the per-instance depth is ceil(depth / n)
        n = max(1, self.n_instances)
        depth = -(-max(queue_pending_requests, 0) // n)
        est = self.estimator.waiting_time(depth, wl, self.hw)
        if est.conservative(self.estimator.z) > self.max_drain_s:
            self.rejected.append(req)
            return False
        return True


@dataclasses.dataclass
class ReplacementPolicy:
    """Replacement / scale-out trigger for the self-healing cluster
    (paper §9 option (a), recovery-driven).

    Reads two REAL signals off a ``QLMController``:

      * **dead capacity** — the fraction of attached instances that
        departed (DEAD or DRAINED).  Above ``max_departed_fraction`` the
        departed slots are due for replacement.
      * **queue drain** — a coarse RWT-style estimate of how long the
        surviving schedulable capacity needs to drain the queued
        backlog.  Above ``max_drain_s`` the cluster is due for
        replacement even if the departed fraction alone is tolerable
        (``scale_out_due`` exposes the same signal for net-new growth).

    The policy only *decides*; the caller builds the fresh engine and
    calls ``QLMController.replace_instance`` (engines are processes /
    devices — standing one up is the launcher's job, not the
    controller's).  ``cooldown_s`` rate-limits decisions so a slow
    engine bring-up is not re-triggered every tick."""
    max_departed_fraction: float = 0.0   # any departure is due by default
    max_drain_s: float = math.inf
    cooldown_s: float = 0.0
    _last_decision: float = dataclasses.field(default=-math.inf, repr=False)

    def departed(self, controller) -> List[int]:
        return [i for i in range(len(controller.instances))
                if not controller.is_alive(i)]

    def queue_drain_s(self, controller) -> float:
        """Estimated seconds the SCHEDULABLE survivors need to drain the
        queued (non-in-flight, non-terminal) backlog — infinite with no
        survivors and a non-empty backlog."""
        backlog = [r for r in controller.global_queue
                   if not r.finished() and not getattr(r, "_in_flight",
                                                       False)]
        if not backlog:
            return 0.0
        rate = 0.0
        for i, inst in enumerate(controller.instances):
            if not controller.is_schedulable(i):
                continue
            for hw in inst.hw_by_model.values():
                # requests/second this instance retires, crudely: one
                # prefill + the mean remaining decode work per request
                per_req = hw.prefill_time + hw.decode_per_token * max(
                    1.0, sum(r.max_new_tokens - r.generated
                             for r in backlog) / len(backlog))
                rate += 1.0 / max(per_req, 1e-9)
                break   # one profile per instance is enough for a bound
        if rate <= 0.0:
            return math.inf
        return len(backlog) / rate

    def replacements_due(self, controller, now: float) -> List[int]:
        """Instance indices whose departed capacity should be replaced
        now ([] inside the cooldown or while the signals are green)."""
        if now - self._last_decision < self.cooldown_s:
            return []
        n = len(controller.instances)
        gone = self.departed(controller)
        if not n or not gone:
            return []
        if (len(gone) / n) > self.max_departed_fraction \
                or self.queue_drain_s(controller) > self.max_drain_s:
            self._last_decision = now
            return gone
        return []

    def scale_out_due(self, controller, now: float) -> bool:
        """True when the backlog alone (all instances healthy) warrants
        net-new capacity — the §9(a) scale-UP signal."""
        if now - self._last_decision < self.cooldown_s:
            return False
        if self.queue_drain_s(controller) > self.max_drain_s:
            self._last_decision = now
            return True
        return False
