"""The port's fault-tolerance drivers (``repro_torch.launch.chaos``,
``serving/faults.py``, ``serving/cluster.py``) on the CPU against the JAX
package's.

The port's virtual-clock soak runs on the weights the JAX soak draws
(``jax.random.key(seed)``, carried across by ``models/convert.py``) and
must give the JAX soak's stats exactly, for the ``kill``, ``migrate`` and
``combined`` scenarios: fault timeline, every request's tokens, and every
counter (served, rejected, quarantined, redeliveries, stranded, leaked
blocks, hangs, drains, replacements, migrations).  ``combined`` must also
hold ``check_soak``'s contract: the no-fault baseline's tokens and an
identical replay.  Then the twins of the JAX package's engine-backed
fault tests (``tests/test_fault_tolerance.py``,
``tests/test_cluster_threads.py``) on the port's engines.

Tolerance: exact (tokens, timelines and counters).
"""
import argparse
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.launch import chaos as jax_chaos
from repro.models import build_model as jax_build_model
from repro_torch.analysis.invariants import (check_block_manager,
                                             check_migration,
                                             check_queue_layer,
                                             check_terminal_states)
from repro_torch.configs import get_arch
from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.qlm import QLMConfig, QLMController
from repro_torch.core.request import Request, make_request
from repro_torch.core.rwt_estimator import HardwareProfile
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.launch import chaos
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 FaultPlan, ThreadedCluster)

torch.set_num_threads(2)
ARCH = "granite-3-2b"


def _args(**over):
    kw = dict(arch=ARCH, instances=2, requests=10, rate=8.0,
              max_new_tokens=8, slots=4, seed=0, device="cpu",
              site="decode", kill_engine=1, kill_at=2, error_prob=0.0,
              retry_budget=2, round_dt=0.05, max_rounds=600,
              attainment_floor=0.5, no_supervision=False,
              replay_check=False, json=None, timeline=None, scenario="kill",
              plan_file=None, hang_engine=0, hang_at=6, hang_grace=None,
              drain_engine=None, drain_at_round=None, drain_evict=False,
              replace_cooldown=0.5, shared_prefix=None)
    kw.update(over)
    return argparse.Namespace(**kw)


@pytest.fixture(scope="module")
def registry():
    """The JAX soak's weights (``chaos.build_cluster``: the arch reduced
    to 1 layer of width 64, ``jax.random.key(seed)``) as the port's."""
    cfg = ARCHITECTURES[ARCH].reduced(num_layers=1, d_model=64)
    jparams = jax_build_model(cfg).init(jax.random.key(0))
    tcfg = get_arch(ARCH).reduced(num_layers=1, d_model=64)
    return {ARCH: (build_model(tcfg),
                   from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu"))}


@pytest.mark.parametrize("over", [
    dict(scenario="kill"),
    dict(scenario="migrate", requests=12),
    dict(scenario="combined", instances=3, requests=24, rate=8.0,
         max_new_tokens=12)], ids=lambda o: o["scenario"])
def test_soak_equals_the_jax_soak(registry, over):
    args = _args(**over)
    want = jax_chaos.run_soak(args)
    got = chaos.run_soak(args, registry=registry)
    assert got == want
    assert got["stranded"] == 0 and got["leaked_blocks"] == []
    assert got["served"] + got["failed_quarantined"] + got["rejected"] \
        == got["requests"]
    if args.scenario == "kill":
        assert got["dead_instances"] == [1] and got["redeliveries"] >= 1
    else:
        assert got["migrations"] >= 1
    if args.scenario == "combined":
        assert got["hangs"] >= 1 and got["replacements"] >= 1
        args.replay_check = True
        assert chaos.check_soak(args, got, registry) == {}
        assert got["replay_identical"] is True
        assert got["outputs_match_baseline"] == len(got["outputs"])


def test_soak_without_supervision_strands_requests(registry):
    """Twin of ``test_chaos_without_supervision_strands_requests``: the
    same fault plan with the recovery machinery off strands requests, and
    ``check_soak`` holds that as the contract of the mode."""
    args = _args(no_supervision=True, max_rounds=250)
    stats = chaos.run_soak(args, registry=registry)
    assert stats["stranded"] > 0
    assert stats["dead_instances"] == []         # controller never learned
    assert chaos.check_soak(args, stats, registry) == {}


def test_soak_builds_its_own_weights_and_refuses_hetero():
    """Without a registry the soak draws the reduced arch's weights from a
    generator seeded with ``--seed`` on ``--device``; ``--hetero`` (once
    refused, hence the name) gives instance i the static profile of tier
    ``i % 3``, equal field for field to the reference's ``_hw``."""
    reg = chaos.build_registry(_args())
    model, params = reg[ARCH]
    assert model.cfg.num_layers == 1 and model.cfg.d_model == 64
    assert params["embed"].dtype == torch.float32
    again = chaos.build_registry(_args())[ARCH][1]
    assert torch.equal(params["embed"], again["embed"])
    args = _args(hetero=True, instances=3)
    _, _, _, controller, _, _ = chaos.build_cluster(
        args, FaultPlan([], seed=0), reg)
    profiles = [vars(inst.hw_by_model[ARCH])
                for inst in controller.instances]
    assert profiles == [vars(jax_chaos._hw(args.max_new_tokens, tier=i))
                        for i in range(3)]
    assert len({p["prefill_time"] for p in profiles}) == 3
    assert vars(chaos._hw(8)) == vars(jax_chaos._hw(8))


# ---------------------------------------------------------------------------
# cross-engine snapshot migration on the port's engines
# ---------------------------------------------------------------------------

def _engine(registry):
    model, params = registry[ARCH]
    return ContinuousBatchingEngine(model, params, EngineConfig(
        max_slots=4, max_seq_len=64, block_size=8, prefill_chunk_tokens=16,
        attention_backend="paged-cuda", prefix_sharing=True, device="cpu"),
        model_name="m1")


def _hw():
    return HardwareProfile(prefill_time=0.05, decode_per_token=0.02,
                           inefficiency=1.2, token_capacity=512,
                           swap_time=0.2, model_max_tokens=32)


def _step_until(engines, reqs):
    for _ in range(80):
        for e in engines:
            e.step()
        if all(r.finished() for r in reqs):
            break
    assert all(r.finished() for r in reqs)


def test_migrated_snapshot_resumes_token_identical(registry):
    """Twin of the JAX test of that name: a live-pinned mid-decode
    snapshot is materialized on its source engine, resumed on another,
    and finishes with the tokens of an uninterrupted run; both pools end
    empty."""
    shared = list(range(1, 13))
    prompts = [shared + [50, 51], shared + [60, 61, 62]]

    def req(p):
        return Request(prompt_tokens=list(p), model="m1", slo=1e9,
                       max_new_tokens=6)

    base = _engine(registry)
    base_reqs = [req(p) for p in prompts]
    assert base.admit(base_reqs[0])
    while base.prefilling_slots():
        base.step()
    assert base.admit(base_reqs[1])
    _step_until([base], base_reqs)
    want = [r.output_tokens for r in base_reqs]
    assert all(len(t) == 6 for t in want)

    eng_a, eng_b = _engine(registry), _engine(registry)
    ra, rb = [req(p) for p in prompts]
    assert eng_a.admit(ra)
    while eng_a.prefilling_slots():
        eng_a.step()
    assert eng_a.admit(rb)
    eng_a.step()
    eng_a.step()
    assert rb.generated > 0
    eng_a.evict_request(rb.req_id)
    assert rb.snapshot["pinned"], "no pins: the scenario is vacuous"
    assert not eng_b.can_admit(rb)
    assert eng_a.materialize_snapshot(rb)
    assert rb.snapshot is not None and not rb.snapshot["pinned"]
    assert eng_a.stats.migrations_out == 1
    assert eng_b.admit(rb)
    assert eng_b.stats.migrations_in == 1 and eng_b.stats.resumes == 1
    _step_until([eng_a, eng_b], [ra, rb])
    assert [ra.output_tokens, rb.output_tokens] == want
    assert eng_a.block_mgr.used_blocks == 0 and not eng_a.block_mgr._pins
    assert eng_b.block_mgr.used_blocks == 0


def test_migration_sweep_moves_orphaned_pinned_snapshot(registry):
    """Twin of the JAX test of that name: a queued request whose snapshot
    pins pages on instance A while its group sits on instance B is
    materialized by the controller's sweep."""
    eng_a, eng_b = _engine(registry), _engine(registry)
    a = InstanceInfo(0, {"m1": _hw()}, None, VirtualQueue(0))
    b = InstanceInfo(1, {"m1": _hw()}, None, VirtualQueue(1))
    c = QLMController([a, b], QLMConfig(avg_batch_size=4,
                                        reschedule_on_arrival=False))
    c.attach_engines([eng_a, eng_b])
    shared = list(range(1, 13))
    ra = Request(prompt_tokens=shared + [50], model="m1", slo=1e9,
                 max_new_tokens=6, arrival_time=0.0)
    rb = Request(prompt_tokens=shared + [60, 61], model="m1", slo=1e9,
                 max_new_tokens=6, arrival_time=0.0)
    assert c.submit(ra, 0.0) and c.submit(rb, 0.0)
    assert eng_a.admit(ra)
    ra._in_flight, ra._served_by = True, 0
    while eng_a.prefilling_slots():
        eng_a.step()
    assert eng_a.admit(rb)
    eng_a.step()
    eng_a.step()
    eng_a.evict_request(rb.req_id)
    assert rb.snapshot["pinned"]
    rb._in_flight, rb._served_by = False, None
    for g in list(a.virtual_queue.groups):
        if rb in g.requests:
            a.virtual_queue.groups.remove(g)
            b.virtual_queue.groups.append(g)
    migrated_before = c.migrations
    c.migration_sweep(1.0)
    assert c.migrations == migrated_before + 1
    assert rb.snapshot is not None and not rb.snapshot["pinned"]
    assert eng_b.admit(rb)
    _step_until([eng_a, eng_b], [ra, rb])
    assert eng_a.block_mgr.used_blocks == 0 and not eng_a.block_mgr._pins


# ---------------------------------------------------------------------------
# threaded stress on the port's engines
# ---------------------------------------------------------------------------

def test_threaded_churn_soak_zero_violations_zero_leaks(registry,
                                                        monkeypatch):
    """Twin of the JAX test of that name, with its arguments (``--hetero``
    tiers included): three engines on
    their own threads under submit/cancel/kill/migrate churn, the qlint
    invariants checked on sampled rounds and ticks; every request ends
    terminal and no pool, the dead and drained ones included, leaks."""
    monkeypatch.setenv("QLINT_INVARIANTS", "1")
    monkeypatch.setenv("QLINT_INVARIANTS_SAMPLE", "3")
    args = argparse.Namespace(
        arch=ARCH, instances=3, slots=4, seed=0, max_new_tokens=8,
        scenario="none", hang_grace=None, retry_budget=2, threaded=True,
        hetero=True, routing="slice")
    clock, engines, agents, controller, make_engine, _ = \
        chaos.build_cluster(args, FaultPlan([], seed=0), registry)

    t0 = clock()
    prefix = [1, 2, 3, 4]
    reqs = [make_request(prefix + list(range(10 + i, 22 + i)), ARCH,
                         ("interactive", "batch1")[i % 2],
                         arrival_time=t0 + 0.05 * i, max_new_tokens=8)
            for i in range(12)]
    cluster = ThreadedCluster(controller, agents, engines)
    cluster.start()
    killed = drained = False
    try:
        pending = list(reqs)
        deadline = t0 + 120.0
        while clock() < deadline:
            now = clock()
            while pending and pending[0].arrival_time <= now:
                controller.submit(pending.pop(0), now)
            submitted = len(reqs) - len(pending)
            if submitted >= 4:
                reqs[2].cancel_requested = True
                reqs[3].cancel_requested = True
            if not killed and submitted >= 6:
                controller.mark_dead(1, now, cause="churn kill")
                killed = True
            if not drained and not pending \
                    and controller.is_schedulable(0):
                controller.drain_instance(0, now, evict=True,
                                          cause="churn migrate")
                drained = True
            if not pending and all(chaos._terminal(r) for r in reqs) \
                    and not any(h.state == "draining"
                                for h in controller.health):
                break
            time.sleep(0.01)
    finally:
        cluster.stop()                       # re-raises agent errors

    assert killed and drained
    assert all(chaos._terminal(r) for r in reqs), \
        [r for r in reqs if not chaos._terminal(r)]
    controller.gc_groups()
    check_queue_layer(controller, where="churn/end")
    check_terminal_states(controller, engines=engines, where="churn/end")
    check_migration(controller, engines=engines, where="churn/end")
    for idx, eng in enumerate(engines):
        bm = eng.block_mgr
        check_block_manager(bm, where=f"churn/engine{idx}")
        assert not bm._seqs, f"engine{idx} leaked sequences"
        assert not [b for b, p in bm._pins.items() if p > 0], \
            f"engine{idx} leaked pins"
    served = sum(1 for r in reqs
                 if r.finished() and not r.failed and not r.rejected)
    assert served >= len(reqs) - 2 - controller.cfg.retry_budget
