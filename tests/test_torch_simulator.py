"""The port's cluster simulator and the paper's baselines against the
reference's: the same workload (same generator, same seed) through
``repro_torch.sim.ClusterSimulator`` and ``repro.sim.ClusterSimulator``
under each policy (``vllm`` FCFS, ``edf``, ``shepherd``, ``qlm``) over the
paper's A100 profiles gives the same metrics dict; the strict
priority scheduler gives the same virtual-queue orders; the ITL report
holds.  These are cross-package parity checks: both packages must compute
the same numbers, not merely plausible ones.

Tolerance: exact (every metric, NaN equal to NaN).
"""
import math

import pytest

from repro.core.global_scheduler import InstanceInfo as RefInstanceInfo
from repro.core.priority import PriorityScheduler as RefPriorityScheduler
from repro.core.request import make_request as ref_make_request
from repro.core.request_group import RequestGroup as RefRequestGroup
from repro.core.rwt_estimator import HardwareProfile as RefHardwareProfile
from repro.core.virtual_queue import VirtualQueue as RefVirtualQueue
from repro.data import workload as ref_workload
from repro.sim import ClusterSimulator as RefSimulator
from repro.sim import profiles_for as ref_profiles_for
from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.priority import PriorityScheduler
from repro_torch.core.request import make_request
from repro_torch.core.request_group import RequestGroup
from repro_torch.core.rwt_estimator import HardwareProfile
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.data import workload
from repro_torch.launch import slo_benchmark
from repro_torch.sim import ClusterSimulator, profiles_for

POLICIES = ("vllm", "edf", "shepherd", "qlm")
# (workload, device, models, instances, rate, requests)
WORKLOADS = {
    "workload_b": ("workload_b", "a100", slo_benchmark.MODELS, 4, 25.0, 200),
    "workload_a": ("workload_a", "a100", ["vicuna-13b"], 2, 5.0, 120),
}


def _same(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def _run(pkg_workload, sim_cls, prof_fn, name, policy):
    fn, device, models, n_inst, rate, n = WORKLOADS[name]
    kw = {} if fn == "workload_b" else {"model": models[0]}
    reqs = getattr(pkg_workload, fn)(arrival_rate=rate, n_requests=n,
                                     seed=42, **kw)
    sim = sim_cls([prof_fn(device, models) for _ in range(n_inst)], policy)
    return sim.run(reqs)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("policy", POLICIES)
def test_simulator_metrics_equal_the_references(policy, name):
    want = _run(ref_workload, RefSimulator, ref_profiles_for, name, policy)
    got = _run(workload, ClusterSimulator, profiles_for, name, policy)
    assert sorted(got) == sorted(want)
    diff = {k: (got[k], want[k]) for k in want if not _same(got[k], want[k])}
    assert not diff, diff
    assert got["completed"] > 0


def _priority_orders(pkg):
    """The orders of tests/test_extensions.py:28-52 under one package's
    scheduler, each as the indices of the input groups."""
    (Group, make, HW, VQ, Info, Sched) = pkg
    hw = HW(prefill_time=0.1, decode_per_token=0.04, inefficiency=1.2,
            token_capacity=60_000, swap_time=2.0)

    def group(model, slo, priority=0, n=4):
        g = Group(model=model, slo=slo)
        for _ in range(n):
            r = make(list(range(20)), model, "batch1", arrival_time=0.0)
            r.slo = slo
            r.priority = priority
            g.add(r)
        return g

    out = []
    vq = VQ(0)
    levels = [group("m", slo=5.0, priority=1),
              group("m", slo=500.0, priority=0)]
    Sched().schedule(levels, [Info(0, {"m": hw}, "m", vq)], now=0.0)
    out.append([levels.index(g) for g in vq.groups])

    vq = VQ(0)
    mixed = [group("a", 100.0), group("b", 102.0), group("a", 104.0),
             group("b", 106.0)]
    Sched(exact_threshold=7).schedule(
        mixed, [Info(0, {"a": hw, "b": hw}, "a", vq)], now=0.0)
    out.append([mixed.index(g) for g in vq.groups])
    out.append(vq.models_in_order())
    return out


def test_priority_scheduler_orders_equal_the_references():
    want = _priority_orders((RefRequestGroup, ref_make_request,
                             RefHardwareProfile, RefVirtualQueue,
                             RefInstanceInfo, RefPriorityScheduler))
    got = _priority_orders((RequestGroup, make_request, HardwareProfile,
                            VirtualQueue, InstanceInfo, PriorityScheduler))
    assert got == want
    strict, _, models = got
    assert strict.index(1) < strict.index(0)   # priority 0 first
    switches = sum(1 for a, b in zip(models, models[1:]) if a != b)
    assert switches <= 2                        # EDF interleave would be 3


def test_sim_reports_itl():
    reqs = workload.workload_a(arrival_rate=5, n_requests=60, seed=0)
    m = ClusterSimulator([profiles_for("a100", ["vicuna-13b"])], "qlm").run(
        reqs)
    # ITL ~ decode_per_token (0.04) + admission-interleave overhead
    assert 0.03 <= m["mean_itl"] <= 0.12, m["mean_itl"]
    ref = RefSimulator([ref_profiles_for("a100", ["vicuna-13b"])], "qlm").run(
        ref_workload.workload_a(arrival_rate=5, n_requests=60, seed=0))
    assert m["mean_itl"] == ref["mean_itl"]


def test_slo_benchmark_equals_the_reference_example(capsys):
    """``launch.slo_benchmark`` (the twin of examples/slo_benchmark.py) runs
    the four policies on W_B and labels its output a simulation."""
    results = slo_benchmark.main(["--requests", "60", "--instances", "2"])
    assert sorted(results) == sorted(POLICIES)
    out = capsys.readouterr().out
    assert "simulation" in out and "A100" in out
    for policy, got in results.items():
        want = RefSimulator(
            [ref_profiles_for("a100", slo_benchmark.MODELS)
             for _ in range(2)], policy).run(
            ref_workload.workload_b(arrival_rate=25.0, n_requests=60,
                                    seed=42))
        assert all(_same(got[k], want[k]) for k in want), policy
