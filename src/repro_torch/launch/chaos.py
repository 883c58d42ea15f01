"""Chaos soak driver: seeded engine-failure injection against the live
QLM stack (the acceptance harness for §4 fault tolerance; PyTorch twin of
``src/repro/launch/chaos.py``).

Runs N of the port's engines (``"paged-cuda"``, on the card by default,
``--device cpu`` for the kernels' plain versions) wrapped in
``serving.faults.FaultyEngine`` under a seeded ``FaultPlan`` (default:
kill one engine mid-decode), drives a deterministic round loop on a
VIRTUAL clock, and asserts the recovery contract:

  * every submitted request reaches a terminal state (served, rejected,
    or failed-quarantined) — nothing strands;
  * BlockManager accounting is conserved on every engine INCLUDING the
    dead one (abandoned slots freed, snapshot pins released — zero
    leaked or pinned-forever blocks);
  * interactive SLO attainment stays above a floor despite the death;
  * the same seed replays the identical fault timeline
    (``--replay-check`` runs the soak twice and compares).

``--scenario`` selects the lifecycle under test:

  * ``kill`` (default) — hard mid-decode crash, the contract above;
  * ``hang`` — the engine stalls silently (rounds "succeed" with zero
    progress, heartbeats keep flowing): the controller's round watchdog
    must detect it, with NO exception ever surfacing;
  * ``drain`` — graceful decommission: residents finish, the instance
    reaches DRAINED, zero evictions needed;
  * ``kill-replace`` — crash + ``ReplacementPolicy`` autoscaling: a
    fresh engine takes the dead slot and serves redelivered work;
  * ``migrate`` — forced drain-with-evict creates live-pinned KV
    snapshots that must resume token-identical on ANOTHER engine
    (cross-engine snapshot migration);
  * ``combined`` — hang one engine + crash another + replacement +
    ≥1 migration, outputs byte-identical to a no-fault baseline
    (defaults to 3 instances);
  * ``none`` — fault-free baseline (used for output-identity checks).

``--plan-file`` overrides the scenario's fault schedule with a JSON
``FaultPlan`` (``FaultPlan.from_json``) for replaying captured
timelines.

``--no-supervision`` runs the same fault schedule with the recovery
machinery disabled (failures swallowed, no redelivery): requests strand,
proving the harness detects exactly what the supervision layer fixes.

Run it under ``QLINT_INVARIANTS=1`` so every engine round and controller
tick double-checks the block/queue/terminal-state invariants:

  PYTHONPATH=src QLINT_INVARIANTS=1 python -m repro_torch.launch.chaos \
      --device cpu --replay-check --json CHAOS_stats.json \
      --timeline CHAOS_timeline.json

The soak serves ``--arch`` reduced to 1 layer of width 64 (weights from a
``torch.Generator`` seeded with ``--seed``), or the weights a caller
passes to ``run_soak`` / ``check_soak``; the page pool takes the
transformers only (the engine refuses mamba2, zamba2 and whisper, as the
reference's does).  ``--hetero`` gives instance i
the fast / mid / slow static profile of tier ``i % 3`` (``_hw``).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.invariants import (check_block_manager,
                                             check_migration,
                                             check_queue_layer,
                                             check_terminal_states)
from repro_torch.configs import get_arch
from repro_torch.core.autoscale import ReplacementPolicy
from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.lso import QLMAgent
from repro_torch.core.qlm import QLMConfig, QLMController
from repro_torch.core.request import make_request
from repro_torch.core.rwt_estimator import HardwareProfile
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 EngineFailure, FaultPlan, FaultSpec,
                                 FaultyEngine)


# the CUDA libraries of the "paged-cuda" backend (float and int8 kernels)
PAGED_LIBRARIES = ("paged_decode_attention", "paged_prefill_attention")


class VirtualClock:
    """Deterministic time source: the round loop advances it explicitly,
    so timelines, backoff windows, and TTFTs are replayable bit-for-bit
    (wall time would smear the fault schedule across runs)."""

    def __init__(self, t0: float = 0.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _hw(max_new: int, tier: Optional[int] = None) -> HardwareProfile:
    # static profile (no calibration pass): the soak measures recovery
    # behavior, not scheduling quality, and static costs keep it seeded.
    # --hetero assigns instance i the fast/mid/slow tier (i % 3) so the
    # scheduler's drain/swap estimates differ per instance.  The spread
    # is deliberately mild (2x end to end): every staged fault needs its
    # target engine to carry real work (a starved engine neither stalls
    # visibly, nor decodes enough to reach its crash occurrence, nor
    # holds sharers to migrate on drain), and a steeper spread lets the
    # solver serve the whole soak workload from the fastest tier alone.
    scale = 1.0 if tier is None else (0.75, 1.0, 1.5)[tier % 3]
    return HardwareProfile(prefill_time=0.05 * scale,
                           decode_per_token=0.02 * scale,
                           inefficiency=1.2,
                           token_capacity=int(512 / scale),
                           swap_time=0.2, model_max_tokens=max(64, max_new))


def default_plan(args) -> FaultPlan:
    scenario = getattr(args, "scenario", "kill")
    plan_file = getattr(args, "plan_file", None)
    if plan_file:
        with open(plan_file) as f:
            return FaultPlan.from_json(f.read())
    specs = []
    if scenario in ("kill", "kill-replace", "combined"):
        specs.append(FaultSpec(site=args.site, kind="crash",
                               engine=args.kill_engine, at_count=args.kill_at))
    if scenario in ("hang", "combined"):
        # hang fires on the round site so it stalls the engine even while
        # it is only pulling work (no decode occurrences needed)
        specs.append(FaultSpec(site="round", kind="hang",
                               engine=getattr(args, "hang_engine", 0),
                               at_count=getattr(args, "hang_at", 6)))
    if args.error_prob > 0:
        # probabilistic transient errors on the surviving engine exercise
        # the strike/heartbeat-recovery path alongside the hard kill
        specs.append(FaultSpec(site="round", kind="error", engine=None,
                               prob=args.error_prob, max_fires=2))
    return FaultPlan(specs, seed=args.seed)


def build_registry(args) -> dict:
    """``{arch: (Model, params)}``: the arch reduced to 1 layer of width 64,
    weights from a generator of the device seeded with ``--seed``
    (bfloat16 on the card, float32 on the CPU)."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    model = build_model(get_arch(args.arch).reduced(num_layers=1,
                                                    d_model=64))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    return {args.arch: (model, model.init(gen, dtype, dev))}


def build_cluster(args, plan: FaultPlan, registry: Optional[dict] = None):
    """Engines, agents and controller of one soak, serving ``registry``'s
    ``--arch`` (``build_registry(args)`` if None) on the device its
    weights lie on.  On the card the page pool's kernel libraries are
    built and loaded here: a build inside a wall-clock round would read
    as a hang."""
    import time as _time
    hetero = bool(getattr(args, "hetero", False))
    registry = build_registry(args) if registry is None else registry
    model, params = registry[args.arch]
    dtype = params["embed"].dtype
    device = params["embed"].device
    if device.type == "cuda":
        for name in build.build(PAGED_LIBRARIES):
            build.load(name)
    threaded = bool(getattr(args, "threaded", False))
    # threaded mode runs on real wall time (concurrent rounds cannot share
    # a manually-advanced clock); the seeded round-robin loop keeps the
    # virtual clock so timelines replay bit-for-bit
    clock = _time.monotonic if threaded else VirtualClock()
    ecfg = EngineConfig(max_slots=args.slots, max_seq_len=128, block_size=8,
                        attention_backend="paged-cuda", prefix_sharing=True,
                        device=str(device), dtype=dtype)

    def make_engine(engine_id: int) -> FaultyEngine:
        # replacement engines get FRESH unique ids so the plan's
        # occurrence counters never re-fire on the new hardware
        inner = ContinuousBatchingEngine(model, params, ecfg,
                                         model_name=args.arch, clock=clock)
        return FaultyEngine(inner, plan, engine_id=engine_id)

    engines, agents, infos = [], [], []
    for i in range(args.instances):
        eng = make_engine(i)
        vq = VirtualQueue(i)
        agents.append(QLMAgent(eng, vq, registry))
        engines.append(eng)
        hw = _hw(args.max_new_tokens, tier=i if hetero else None)
        infos.append(InstanceInfo(i, {args.arch: hw}, args.arch, vq))
    scenario = getattr(args, "scenario", "kill")
    grace = getattr(args, "hang_grace", None)
    if grace is None and scenario in ("hang", "combined"):
        # threaded rounds run on wall time, where a stall of a HEALTHY
        # busy engine (the reference's first-shape XLA compile; here a
        # neighbour's work on the one card) is a pause the virtual clock
        # never sees.  The wider grace keeps the watchdog from
        # false-killing it while still catching the injected hang well
        # inside the soak wall budget.
        grace = 10.0 if threaded else 3.0
    controller = QLMController(infos, QLMConfig(
        avg_batch_size=args.slots, reschedule_cooldown=0.5,
        retry_budget=args.retry_budget, backoff_base_s=0.05,
        backoff_cap_s=1.0, hang_grace_rounds=grace,
        routing=getattr(args, "routing", "solver")))
    controller.attach_engines(engines)
    return clock, engines, agents, controller, make_engine, registry


def build_requests(args) -> List:
    rng = np.random.default_rng(args.seed)
    classes = ["interactive", "interactive", "batch1"]
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    # migration scenarios prepend a shared system-prompt-style prefix:
    # prefix sharing turns it into pinned pages, and pinned pages are what
    # eviction leaves behind / migration must materialize away
    shared = getattr(args, "shared_prefix", None)
    if shared is None:
        shared = 8 if getattr(args, "scenario", "kill") in ("migrate",
                                                            "combined") else 0
    prefix = list(range(1, int(shared) + 1))
    reqs = []
    for i in range(args.requests):
        tail = rng.integers(0, 100, size=int(rng.integers(6, 20))).tolist()
        reqs.append(make_request(prefix + tail, args.arch,
                                 classes[i % len(classes)],
                                 arrival_time=float(arrivals[i]),
                                 max_new_tokens=args.max_new_tokens))
    return reqs


def _terminal(r) -> bool:
    return r.finished() or r.dropped()


def run_soak(args, plan: Optional[FaultPlan] = None,
             registry: Optional[dict] = None) -> dict:
    """One soak run.  Returns the stats dict (pure data — the CLI's
    assertions live in check_soak() so tests can call this directly).
    Dispatches to the threaded wall-clock loop under --threaded.
    ``registry`` is ``build_cluster``'s."""
    if getattr(args, "threaded", False):
        return run_soak_threaded(args, plan, registry)
    return _run_soak_round_robin(args, plan, registry)


def _run_soak_round_robin(args, plan: Optional[FaultPlan] = None,
                          registry: Optional[dict] = None) -> dict:
    """The seeded virtual-clock round-robin loop (replayable timelines)."""
    plan = default_plan(args) if plan is None else plan
    scenario = getattr(args, "scenario", "kill")
    clock, engines, agents, controller, make_engine, registry = \
        build_cluster(args, plan, registry)
    reqs = build_requests(args)
    pending = list(reqs)

    policy = None
    if scenario in ("kill-replace", "combined"):
        policy = ReplacementPolicy(
            cooldown_s=getattr(args, "replace_cooldown", 0.5))
    drain_engine = getattr(args, "drain_engine", None)
    if drain_engine is None:
        # combined drains the engine that neither hangs nor crashes
        drain_engine = args.instances - 1 if scenario == "combined" else 0
    drain_round = getattr(args, "drain_at_round", None)
    if drain_round is None:
        # migration scenarios drain while sharers are still co-resident
        # (pins only exist while ≥2 sequences reference the prefix pages)
        drain_round = {"migrate": 16, "combined": 8}.get(scenario, 40)
    # migration scenarios evict on drain so live-pinned snapshots exist
    # and MUST move; plain drain is graceful (zero evictions)
    drain_evict = bool(getattr(args, "drain_evict", False)) \
        or scenario in ("migrate", "combined")
    drains_scenario = scenario in ("drain", "migrate", "combined")
    drained_fired = False
    retired: List[tuple] = []
    next_engine_id = args.instances

    supervision = not args.no_supervision
    rounds = failures = 0
    while rounds < args.max_rounds:
        rounds += 1
        now = clock.advance(args.round_dt)
        while pending and pending[0].arrival_time <= now:
            controller.submit(pending.pop(0), now)
        if (drains_scenario and not drained_fired and rounds >= drain_round
                and controller.is_schedulable(drain_engine)):
            # an evicting drain only migrates anything if the instance is
            # busy when it lands, so wait for ≥2 co-resident sharers
            # (bounded: past 4x the trigger round, drain regardless)
            busy = getattr(engines[drain_engine], "num_active", lambda: 0)()
            if not drain_evict or busy >= 2 or rounds >= 4 * drain_round:
                controller.drain_instance(drain_engine, now,
                                          evict=drain_evict,
                                          cause=f"chaos scenario={scenario}")
                drained_fired = True
        controller.tick(now)
        if policy is not None and supervision:
            for idx in policy.replacements_due(controller, now):
                eng = make_engine(next_engine_id)
                next_engine_id += 1
                retired.append((idx, engines[idx]))
                controller.replace_instance(idx, eng, now)
                engines[idx] = eng
                agents[idx] = QLMAgent(
                    eng, controller.instances[idx].virtual_queue, registry)
        for idx, agent in enumerate(agents):
            if not controller.is_alive(idx):
                continue
            if not supervision and agent.engine.dead:
                continue   # unsupervised: the controller never learns
            try:
                agent.run_iteration()
            except EngineFailure as e:
                failures += 1
                if supervision:
                    controller.report_engine_failure(idx, e, now,
                                                     engine=agent.engine)
                    agent.reset()
            else:
                if supervision:
                    controller.heartbeat(idx, now)
        if not pending and all(_terminal(r) for r in reqs) \
                and not any(h.state == "draining" for h in controller.health):
            break

    return _finalize(args, plan, clock(), controller, engines, retired,
                     reqs, rounds, failures, supervision)


def run_soak_threaded(args, plan: Optional[FaultPlan] = None,
                      registry: Optional[dict] = None) -> dict:
    """Thread-per-engine soak: same fault schedule, real wall-clock
    concurrency (``serving.cluster.ThreadedCluster``).

    Occurrence-counted faults still fire deterministically PER ENGINE
    (each engine's round/decode counters are thread-local sequences), but
    cross-engine event ordering and timestamps are wall-clock — so the
    lifecycle triggers are work-based here (drain when the target is
    busy, wall-time fallback) instead of round-indexed, and
    ``--replay-check`` is a round-robin-only contract.
    """
    import time as _time
    from repro_torch.serving import ThreadedCluster

    plan = default_plan(args) if plan is None else plan
    scenario = getattr(args, "scenario", "kill")
    if args.no_supervision:
        raise SystemExit("--no-supervision is a round-robin-only harness "
                         "mode (the threaded loop IS the supervision)")
    clock, engines, agents, controller, make_engine, registry = \
        build_cluster(args, plan, registry)
    reqs = build_requests(args)
    t0 = _time.monotonic()
    for r in reqs:
        r.arrival_time += t0          # virtual offsets -> wall schedule
    pending = list(reqs)

    policy = None
    if scenario in ("kill-replace", "combined"):
        policy = ReplacementPolicy(
            cooldown_s=getattr(args, "replace_cooldown", 0.5))
    # drain target: an explicit --drain-engine pins it; otherwise the
    # threaded loop picks DYNAMICALLY — the first engine observed holding
    # residents when the drain is due.  Wall-clock placement is not
    # replayable, so a fixed index routinely names an engine the solver
    # happens to starve, and an evicting
    # drain on an empty engine migrates nothing.
    drain_engine = getattr(args, "drain_engine", None)
    drain_evict = bool(getattr(args, "drain_evict", False)) \
        or scenario in ("migrate", "combined")
    drains_scenario = scenario in ("drain", "migrate", "combined")
    drained_fired = False
    retired: List[tuple] = []
    next_engine_id = args.instances
    max_wall = getattr(args, "max_wall", 60.0)
    deadline = t0 + max_wall

    # sustain traffic THROUGH the drain: hold the tail of the workload
    # back until the drain is armed so the evicted/pinned state has live
    # siblings to migrate toward (released unconditionally at 0.4·wall so
    # a never-arming drain cannot strand them)
    holdback: List = []
    if drains_scenario:
        k = max(1, len(pending) // 4)
        holdback, pending = pending[-k:], pending[:-k]

    cluster = ThreadedCluster(controller, agents, engines)

    def _drain_armed() -> bool:
        """combined stages its phases: the drain waits until the hang has
        been detected AND the crash has fired, so the drain cannot land
        on (and retire) an engine whose staged fault hasn't hit yet."""
        if scenario != "combined":
            return True
        return controller.hangs >= 1 and sum(cluster.failures) >= 1

    # round-granular drain trigger, run on each agent's OWN thread
    # between rounds: a 10ms polling loop reliably misses the instants
    # when an engine holds residents, but between-rounds observation
    # cannot.  An evicting drain wants >= 2 co-residents (pins — and thus
    # pinned-snapshot migration — only exist while sharers overlap).
    need_busy = 2 if drain_evict else 1

    def _drain_hook(idx: int) -> None:
        nonlocal drained_fired, drain_engine
        if drained_fired or not _drain_armed():
            return
        if drain_engine is not None and idx != drain_engine:
            return
        eng = cluster.engines[idx]
        with eng.lock:   # own agent thread, between rounds: free
            if getattr(eng, "num_active", lambda: 0)() < need_busy:
                return
            if drain_evict:
                # only sequences whose leading blocks are SHARED
                # (refcount > 1) leave pinned snapshots behind on evict;
                # two non-sharing residents (e.g. both resumed from
                # snapshots) would drain without exercising migration
                bm = getattr(eng, "block_mgr", None)
                if bm is None or not any(bm.shared_prefix_len(sid) > 0
                                         for sid in list(bm._seqs)):
                    return
            with controller.lock:
                if drained_fired or not controller.is_schedulable(idx):
                    return
                controller.drain_instance(
                    idx, _time.monotonic(), evict=drain_evict,
                    cause=f"chaos scenario={scenario} (threaded)")
                drained_fired = True
                drain_engine = idx

    if drains_scenario:
        cluster.round_hook = _drain_hook
    cluster.start()
    try:
        while _time.monotonic() < deadline:
            now = _time.monotonic()
            if holdback and (_drain_armed() or drained_fired
                             or now - t0 > 0.4 * max_wall):
                for r in holdback:
                    # re-anchor deadlines: the tranche was gated by the
                    # harness, not queued, so its SLO clock starts now
                    r.arrival_time = max(r.arrival_time, now)
                pending.extend(holdback)
                holdback = []
            while pending and pending[0].arrival_time <= now:
                controller.submit(pending.pop(0), now)
            if (drains_scenario and not drained_fired
                    and now - t0 > 0.5 * max_wall):
                # wall fallback so a starved cluster still drains before
                # the loop gives up (the round hook is the real trigger)
                cands = [drain_engine] if drain_engine is not None \
                    else list(range(len(cluster.engines)))
                for idx in cands:
                    if controller.is_schedulable(idx):
                        controller.drain_instance(
                            idx, now, evict=drain_evict,
                            cause=f"chaos scenario={scenario} "
                                  f"(threaded, fallback)")
                        drained_fired = True
                        drain_engine = idx
                        break
            if policy is not None:
                with controller.lock:
                    due = policy.replacements_due(controller, now)
                for idx in due:
                    eng = make_engine(next_engine_id)
                    next_engine_id += 1
                    retired.append((idx, cluster.engines[idx]))
                    cluster.replace(
                        idx, eng,
                        QLMAgent(eng,
                                 controller.instances[idx].virtual_queue,
                                 registry), now)
            if not pending and not holdback \
                    and all(_terminal(r) for r in reqs) \
                    and not any(h.state == "draining"
                                for h in controller.health):
                break
            _time.sleep(0.01)
    finally:
        cluster.stop()
    return _finalize(args, plan, _time.monotonic(), controller,
                     cluster.engines, retired, reqs, sum(cluster.rounds),
                     sum(cluster.failures), supervision=True)


def _finalize(args, plan, now, controller, engines, retired, reqs,
              rounds, failures, supervision) -> dict:
    """End-state invariants + the stats dict (shared by both loops)."""
    scenario = getattr(args, "scenario", "kill")
    controller.gc_groups()
    # end-state invariants (always on here, env var or not): conservation
    # must hold on EVERY pool — the dead engine's accounting was salvaged
    # host-side, so it conserves too
    leaked = []
    for idx, eng in enumerate(engines):
        bm = eng.block_mgr
        check_block_manager(bm, where=f"chaos/engine{idx}")
        leaked.extend(f"engine{idx}:seq{sid}" for sid in bm._seqs
                      if controller.is_alive(idx) or supervision)
        leaked.extend(f"engine{idx}:pin{b}" for b, p in bm._pins.items()
                      if p > 0)
    for j, (idx, eng) in enumerate(retired):
        # replaced (dead/drained) engines: salvage + migration must have
        # emptied the pool — retired capacity may hold nobody's state
        bm = eng.block_mgr
        check_block_manager(bm, where=f"chaos/retired{j}(was engine{idx})")
        leaked.extend(f"retired{j}:seq{sid}" for sid in bm._seqs)
        leaked.extend(f"retired{j}:pin{b}" for b, p in bm._pins.items()
                      if p > 0)
    if supervision:
        check_queue_layer(controller, where="chaos/end")
        check_terminal_states(controller, engines=engines, where="chaos/end")
        check_migration(controller, engines=engines, where="chaos/end")

    stranded = [r for r in reqs if not _terminal(r)]
    interactive = [r for r in reqs if r.slo_class == "interactive"]
    inter_hits = sum(1 for r in interactive
                     if not r.failed and r.slo_met() is True)
    stats = {
        "seed": args.seed,
        "scenario": scenario,
        "supervision": supervision,
        "threaded": bool(getattr(args, "threaded", False)),
        "hetero": bool(getattr(args, "hetero", False)),
        "routing": controller.cfg.routing,
        "rounds": rounds,
        "requests": len(reqs),
        "served": sum(1 for r in reqs if r.finished() and not r.failed
                      and not r.rejected),
        "failed_quarantined": len(controller.failed),
        "rejected": len(controller.rejected),
        "stranded": len(stranded),
        "redeliveries": controller.redeliveries,
        "engine_failures": failures,
        "hangs": getattr(controller, "hangs", 0),
        "drains": getattr(controller, "drains", 0),
        "replacements": getattr(controller, "replacements", 0),
        "migrations": getattr(controller, "migrations", 0),
        "dead_instances": [i for i in range(len(engines))
                           if not controller.is_alive(i)],
        "health": [h.state for h in controller.health],
        "leaked_blocks": leaked,
        "slo_attainment": controller.slo_attainment(now),
        "interactive_attainment": (inter_hits / len(interactive)
                                   if interactive else 1.0),
        "timeline": plan.timeline(),
        # keyed by build-order index (req_id is a process-global counter,
        # so it differs across runs in one process); used for the
        # token-identity check against the no-fault baseline
        "outputs": {str(i): list(r.output_tokens) for i, r in enumerate(reqs)
                    if r.finished() and not r.failed and not r.rejected},
    }
    return stats


def check_soak(args, stats: dict, registry: Optional[dict] = None
               ) -> Dict[str, str]:
    """main()'s recovery contract on ``stats`` (``run_soak``'s): check
    name -> failure message, empty when every check held.  migrate and
    combined rerun the soak with no faults (its outputs land in
    ``stats["baseline_outputs"]``) and ``--replay-check`` replays it, both
    on ``registry`` (``build_cluster``'s)."""
    scenario = args.scenario
    failures: Dict[str, str] = {}
    if args.no_supervision:
        if stats["stranded"] == 0:
            failures["stranded"] = (
                "no-supervision run stranded nothing: the fault plan "
                "never hit live work (harness bug)")
        return failures
    if stats["stranded"]:
        failures["stranded"] = (f"{stats['stranded']} request(s) stranded "
                                f"non-terminal")
    if stats["leaked_blocks"]:
        failures["leaked"] = f"leaked KV accounting: {stats['leaked_blocks']}"
    if scenario == "kill" and not stats["dead_instances"]:
        failures["killed"] = ("fault plan killed no engine (kill-at never "
                              "reached: raise --requests or lower --kill-at)")
    if scenario in ("kill-replace", "combined"):
        if stats["engine_failures"] < 1:
            failures["crashed"] = "crash never fired (kill-at never reached)"
        if stats["replacements"] < 1:
            failures["replaced"] = ("ReplacementPolicy never replaced the "
                                    "dead capacity")
    if scenario in ("hang", "combined") and stats["hangs"] < 1:
        failures["hang"] = ("round watchdog never detected the hang "
                            "(no-exception stall went unnoticed)")
    if scenario in ("drain", "migrate", "combined") and stats["drains"] < 1:
        failures["drain"] = "drain LSO never fired"
    if scenario in ("drain", "migrate") and "drained" not in stats["health"]:
        failures["drained"] = (f"drain never completed: health "
                               f"{stats['health']}")
    if scenario in ("migrate", "combined") and stats["migrations"] < 1:
        failures["migrated"] = ("no snapshot migrated cross-engine "
                                "(drain-evict produced no live pins?)")
    if stats["interactive_attainment"] < args.attainment_floor:
        failures["attainment"] = (
            f"interactive attainment {stats['interactive_attainment']:.3f}"
            f" below floor {args.attainment_floor}")
    if scenario in ("migrate", "combined"):
        # migrated (and every other served) request must be
        # token-identical to the same-seed run with no faults at all
        base_args = argparse.Namespace(**vars(args))
        if base_args.shared_prefix is None:
            base_args.shared_prefix = 8   # the migrate-scenario default
        base_args.scenario, base_args.plan_file = "none", None
        base = run_soak(base_args, plan=FaultPlan([], seed=args.seed),
                        registry=registry)
        stats["baseline_outputs"] = base["outputs"]
        common = set(stats["outputs"]) & set(base["outputs"])
        diverged = sorted(int(i) for i in common
                          if stats["outputs"][i] != base["outputs"][i])
        if not common:
            failures["baseline"] = ("no served request overlaps the "
                                    "no-fault baseline (nothing to "
                                    "token-compare)")
        elif diverged:
            failures["baseline"] = (f"outputs diverged from the no-fault "
                                    f"baseline for request(s) {diverged}: "
                                    f"migration is not token-preserving")
        else:
            stats["outputs_match_baseline"] = len(common)
    if args.replay_check:
        replay = run_soak(args, registry=registry)
        if replay["timeline"] != stats["timeline"]:
            failures["replay"] = (f"replay diverged: {stats['timeline']} vs "
                                  f"{replay['timeline']}")
        elif replay["outputs"] != stats["outputs"]:
            failures["replay"] = ("replay produced different tokens from "
                                  "the same seed")
        else:
            stats["replay_identical"] = True
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    help="arch served on the page pool: a transformer "
                         "(mamba2-130m, zamba2-1.2b and whisper-medium "
                         "have no pageable KV and are refused)")
    ap.add_argument("--instances", type=int, default=None,
                    help="engine count (default 2; 3 for combined, which "
                         "stages faults on three distinct engines)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--scenario", default="kill",
                    choices=["kill", "hang", "drain", "kill-replace",
                             "migrate", "combined", "none"],
                    help="lifecycle under test (see module docstring)")
    ap.add_argument("--plan-file", dest="plan_file", default=None,
                    help="JSON FaultPlan overriding the scenario's fault "
                         "schedule (FaultPlan.from_json)")
    ap.add_argument("--site", default="decode",
                    choices=["decode", "prefill", "swap", "materialize",
                             "round"])
    ap.add_argument("--kill-engine", type=int, default=1)
    ap.add_argument("--kill-at", type=int, default=4,
                    help="kill at the Nth occurrence of --site on "
                         "--kill-engine (occurrence counts, not wall "
                         "time: that is what makes the timeline seeded)")
    ap.add_argument("--error-prob", type=float, default=0.0,
                    help="per-round transient-error probability (strikes)")
    ap.add_argument("--hang-engine", type=int, default=0,
                    help="engine stalled by the hang/combined scenarios")
    ap.add_argument("--hang-at", type=int, default=6,
                    help="hang at the Nth round occurrence on --hang-engine")
    ap.add_argument("--hang-grace", type=float, default=None,
                    help="watchdog grace in calibrated round deadlines "
                         "(default for hang scenarios: 3.0, or 10.0 "
                         "threaded — wall-clock XLA compiles stall "
                         "healthy engines; else off)")
    ap.add_argument("--drain-engine", type=int, default=None,
                    help="instance drained by drain/migrate/combined "
                         "(round-robin default: 0, or the last instance "
                         "for combined; threaded default: dynamic — the "
                         "first engine observed holding residents)")
    ap.add_argument("--drain-at-round", type=int, default=None,
                    help="round at which the drain LSO fires (default 40, "
                         "or 16 for migrate/combined so sharers are still "
                         "co-resident when the evict lands)")
    ap.add_argument("--drain-evict", action="store_true",
                    help="drain with forced eviction (migrate/combined "
                         "imply this: it is what creates migratable pins)")
    ap.add_argument("--replace-cooldown", type=float, default=0.5,
                    help="ReplacementPolicy decision cooldown, virtual s")
    ap.add_argument("--shared-prefix", type=int, default=None,
                    help="shared leading prompt tokens (default: 8 for "
                         "migrate/combined — sharing is what creates "
                         "migratable pins — else 0)")
    ap.add_argument("--retry-budget", type=int, default=2)
    ap.add_argument("--round-dt", type=float, default=0.05,
                    help="virtual seconds per round")
    ap.add_argument("--max-rounds", type=int, default=3000)
    ap.add_argument("--threaded", action="store_true",
                    help="thread-per-engine wall-clock loop "
                         "(ThreadedCluster) instead of the seeded "
                         "virtual-clock round-robin")
    ap.add_argument("--hetero", action="store_true",
                    help="heterogeneous static profiles: instance i gets "
                         "the fast/mid/slow tier (i %% 3)")
    ap.add_argument("--routing", default="solver",
                    choices=["solver", "slice"],
                    help="group placement policy (core/routing.py)")
    ap.add_argument("--max-wall", type=float, default=60.0,
                    help="wall-clock bound for the threaded loop")
    ap.add_argument("--attainment-floor", type=float, default=0.5,
                    help="minimum interactive attainment despite the kill")
    ap.add_argument("--no-supervision", action="store_true",
                    help="faults on, recovery off: assert requests STRAND "
                         "(the harness detects what the machinery fixes)")
    ap.add_argument("--replay-check", action="store_true",
                    help="run twice from the same seed and require "
                         "identical fault timelines")
    ap.add_argument("--json", default=None, help="write final stats JSON")
    ap.add_argument("--timeline", default=None,
                    help="write the fault timeline JSON")
    args = ap.parse_args(argv)
    if args.instances is None:
        args.instances = 3 if args.scenario == "combined" else 2
    if args.threaded and args.replay_check:
        ap.error("--replay-check needs the seeded round-robin loop "
                 "(threaded wall-clock ordering is not replayable)")

    stats = run_soak(args)
    failures = check_soak(args, stats)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=2)
    if args.timeline:
        with open(args.timeline, "w") as f:
            json.dump({"seed": args.seed, "events": stats["timeline"]}, f,
                      indent=2)
    for k, v in stats.items():
        if k not in ("timeline", "outputs", "baseline_outputs"):
            print(f"{k:24s} {v:.3f}" if isinstance(v, float)
                  else f"{k:24s} {v}")
    for msg in failures.values():
        print(f"CHAOS FAIL: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
