"""Serving driver: a QLM-managed cluster over the port's engines.

Runs the full QLM stack — request groups, virtual queues, RWT estimator,
global scheduler, LSO agents — against a Poisson workload and prints SLO
attainment and throughput, with every engine serving through the CUDA
kernels (or, with ``--device cpu``, their plain versions): ``--backend
paged-cuda`` (the default) over the KV page pool, ``--backend cuda`` over
dense per-slot caches, which also serve sliding-window models, mamba2
and the zamba2 hybrid (their state in place of the KV cache, their prefill
through the SSD scan kernel; zamba2's attention sites through the dense
decode kernel); the page pool refuses mamba2 and zamba2, as the
reference's does.  whisper-medium serves in neither driver: its requests
need frame embeddings (``req.extras``), which this workload, like the
reference's, does not draw, so its calibration's prefill raises.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --requests 40 --rate 2.0
  PYTHONPATH=src python -m repro_torch.launch.serve --backend cuda \
      --arch2 h2o-danube-1.8b          # two models: the swap LSO
  PYTHONPATH=src python -m repro_torch.launch.serve --backend cuda \
      --arch mamba2-130m               # an SSM (--arch2 mamba2-130m: swaps)
  PYTHONPATH=src python -m repro_torch.launch.serve --backend cuda \
      --arch zamba2-1.2b               # the hybrid
  PYTHONPATH=src python -m repro_torch.launch.serve --threaded \
      --instances 2                    # one thread per engine
  PYTHONPATH=src python -m repro_torch.launch.serve --compare-drivers \
      --instances 2                    # threaded AND round-robin, one seed

The registry holds the reduced config of each arch, as the reference CLI
does (``src/repro/launch/serve.py``); ``--threaded``, ``--routing``,
``--compare-drivers`` and ``--compare-routing`` work as there.  Under
``--threaded`` the engines of one card issue their kernels from their own
threads onto the device's one stream, so they run one after another on
the card, and each engine's ``prefill_time`` / ``decode_time`` (which end
in a device-wide synchronise) include the work its neighbours queued
meanwhile.  Both drivers calibrate the profiles before the wall clock
starts, which also builds and loads the kernels the engines run.
``--hetero`` gives instance i the fast / mid / slow tier ``i % 3``
(``HETERO_TIERS``: slots x2 / x1 / x0.5, decode burst 4 / 2 / 1), each
tier calibrated on its own throwaway engine, and places every model's
params through the sharding rules first (``shard_registry``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.lso import QLMAgent
from repro_torch.core.qlm import QLMConfig, QLMController
from repro_torch.core.request import make_request
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (ShardingRules, build_shardings,
                                              distribute, map_leaves)
from repro_torch.launch.mesh import make_local_mesh, release
from repro_torch.models import build_model
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 ThreadedCluster)
from repro_torch.sim.profiles import calibrate_from_engine


def build_registry(arch_names, seed: int = 0, device="cuda"):
    """name -> (Model, params) for each requested arch (reduced configs),
    weights drawn on ``device`` from a generator seeded with ``seed``:
    bfloat16 on the card, float32 on the CPU."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    registry = {}
    for name in arch_names:
        model = build_model(get_arch(name).reduced())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        registry[name] = (model, model.init(gen, dtype, dev))
    return registry


def placed_registry(registry, mesh):
    """name -> (Model, params as DTensors on ``mesh``), each leaf placed by
    the TP sharding rules (``distributed/sharding.py``)."""
    rules = ShardingRules.default()
    return {name: (model, distribute(mesh, params, build_shardings(
                mesh, params, model.param_axes(), rules)))
            for name, (model, params) in registry.items()}


def shard_registry(registry):
    """Place every model's params through the TP sharding rules.

    The mesh is one device, the params' own (on a one-rank process group,
    ``launch/mesh.py::make_local_mesh``), so every leaf lands replicated;
    but the placement goes through the same ``build_shardings`` path a
    multi-device mesh would use, so the DEFAULT_RULES TP split (ff / heads
    over the "model" axis) applies unchanged where more devices are
    present.  The engines take each DTensor's local tensor, and a process
    group set up here ends here.
    """
    first = next(iter(registry.values()))[1]["embed"]
    owned = not dist.is_initialized()
    mesh = make_local_mesh(first.device)
    try:
        return {name: (model, map_leaves(lambda _, t: t.to_local(), params))
                for name, (model, params)
                in placed_registry(registry, mesh).items()}
    finally:
        if owned:
            release()


# fast / mid / slow capacity tiers for --hetero (instance i -> tier i%3):
# more slots = bigger batches = higher throughput; wider decode_burst =
# fewer host round-trips per token.  The tiers are calibrated separately,
# so the RWT estimator sees genuinely different drain/swap costs.
HETERO_TIERS = ({"slots_scale": 2.0, "decode_burst": 4},
                {"slots_scale": 1.0, "decode_burst": 2},
                {"slots_scale": 0.5, "decode_burst": 1})


def hetero_engine_cfg(base: EngineConfig, idx: int) -> EngineConfig:
    tier = HETERO_TIERS[idx % len(HETERO_TIERS)]
    return dataclasses.replace(
        base,
        max_slots=max(2, int(round(base.max_slots * tier["slots_scale"]))),
        decode_burst=tier["decode_burst"])


def calibrate_registry(registry, ecfg: EngineConfig) -> dict:
    """name -> HardwareProfile, each calibrated on ITS OWN model with one
    throwaway engine."""
    hw_by_model = {}
    for name, (model, params) in registry.items():
        eng = ContinuousBatchingEngine(model, params, ecfg, model_name=name)
        hw_by_model[name] = calibrate_from_engine(
            eng, token_capacity=ecfg.resolved_kv_blocks() * ecfg.block_size)
    return hw_by_model


def engine_config(args, dtype: torch.dtype) -> EngineConfig:
    """The engines' config; ``dtype`` is the weights' (the KV pool's)."""
    return EngineConfig(max_slots=args.slots, max_seq_len=128,
                        decode_burst=args.decode_burst,
                        attention_backend=args.backend,
                        prefix_sharing=args.prefix_sharing,
                        debug_invariants=bool(getattr(args, "debug_invariants",
                                                      False)),
                        device=args.device, dtype=dtype)


def build_cluster(args, registry, arch_names):
    """Engines + agents + controller honoring --hetero and --routing.

    Homogeneous: one calibration shared by every instance.  Hetero: one
    calibration per TIER (distinct ``(max_slots, decode_burst)``), so each
    InstanceInfo carries its own per-model profiles and the scheduler's
    placement is heterogeneity-aware."""
    base = engine_config(args, registry[arch_names[0]][1]["embed"].dtype)
    ecfgs = [hetero_engine_cfg(base, i) if getattr(args, "hetero", False)
             else base for i in range(args.instances)]
    hw_cache = {}
    engines, agents, infos = [], [], []
    for i, ecfg in enumerate(ecfgs):
        key = (ecfg.max_slots, ecfg.decode_burst)
        if key not in hw_cache:
            hw_cache[key] = calibrate_registry(registry, ecfg)
        m0, p0 = registry[arch_names[0]]
        eng = ContinuousBatchingEngine(m0, p0, ecfg, model_name=arch_names[0])
        vq = VirtualQueue(i)
        agents.append(QLMAgent(eng, vq, registry))
        engines.append(eng)
        infos.append(InstanceInfo(i, dict(hw_cache[key]), eng.model_name, vq))
    controller = QLMController(infos, QLMConfig(
        avg_batch_size=args.slots,
        routing=getattr(args, "routing", "solver"),
        debug_invariants=base.debug_invariants))
    controller.attach_engines(engines)
    return engines, agents, infos, controller


def build_workload(args, arch_names, t_start: float):
    rng = np.random.default_rng(args.seed)
    classes = ["interactive", "batch1", "batch2"]
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, 100, size=int(rng.integers(4, 24))).tolist()
        r = make_request(prompt, rng.choice(arch_names), rng.choice(classes),
                         arrival_time=t_start + arrivals[i],
                         max_new_tokens=args.max_new_tokens)
        reqs.append(r)
    return reqs


def summarize(reqs, controller, engines, t_start: float, now: float) -> dict:
    """Printed-stats accounting, mirroring QLMController.slo_attainment:
    requests that never got a first token (rejected / shed / expired, or
    still queued past their deadline at ``now``) are SLO misses."""
    failed = [r for r in reqs if r.failed]
    served = [r for r in reqs if r.ttft() is not None and not r.failed]
    dropped = [r for r in reqs if r.ttft() is None and not r.failed
               and (r.dropped() or now > r.deadline)]
    known = {id(r) for r in reqs}
    extra_rej = [r for r in controller.rejected if id(r) not in known]
    scored = len(served) + len(dropped) + len(extra_rej) + len(failed)
    met = sum(1 for r in served if r.slo_met())
    done_times = [r.completion_time for r in reqs if r.completion_time]
    span = max(max(done_times, default=now) - t_start, 1e-9)
    tokens = sum(e.stats.tokens_generated for e in engines)
    return {
        "requests": len(reqs),
        "served": len(served),
        "rejected": len(extra_rej) + sum(1 for r in reqs if r.rejected),
        "dropped_unserved": len(dropped),
        "failed": len(failed),
        "redeliveries": controller.redeliveries,
        "hangs": controller.hangs,
        "drains": controller.drains,
        "replacements": controller.replacements,
        "migrations": controller.migrations,
        "dead_instances": sum(1 for i in range(len(controller.instances))
                              if not controller.is_alive(i)),
        "slo_attainment": met / scored if scored else 1.0,
        "mean_ttft_s": float(np.mean([r.ttft() for r in served]))
        if served else None,
        "throughput_rps": len(served) / span,
        "evictions": sum(e.stats.evictions for e in engines),
        "swaps": sum(e.stats.model_swaps for e in engines),
        "tokens": tokens,
        "tokens_per_s": tokens / span,
        "prefix_hits": sum(e.stats.prefix_hits for e in engines),
        "prefix_shared_tokens": sum(e.stats.prefix_shared_tokens
                                    for e in engines),
    }


def _terminal(r) -> bool:
    return r.finished() or r.dropped()


def run_round_robin(args, registry, arch_names):
    """Single-thread polling loop: one round interleaves every engine in
    turn, on the wall clock.  Returns ``(stats, requests, engines)``."""
    engines, agents, infos, controller = build_cluster(args, registry,
                                                       arch_names)
    t_start = time.monotonic()
    reqs = build_workload(args, arch_names, t_start)
    pending = list(reqs)
    deadline = t_start + args.max_wall
    while not all(_terminal(r) for r in reqs):
        now = time.monotonic()
        if now > deadline:
            break
        while pending and pending[0].arrival_time <= now:
            controller.submit(pending.pop(0), now)
        for inst, eng, agent in zip(infos, engines, agents):
            inst.current_model = eng.model_name
            agent.run_iteration()
        controller.tick(time.monotonic())
        if not any(e.num_active() for e in engines) and pending:
            time.sleep(min(0.01, max(0.0,
                                     pending[0].arrival_time - now)))
    stats = summarize(reqs, controller, engines, t_start, time.monotonic())
    stats["driver"] = "round-robin"
    stats["routing"] = controller.cfg.routing
    return stats, reqs, engines


def run_threaded(args, registry, arch_names):
    """Thread-per-engine loop: the main thread plays open-loop client
    (submitting on the wall-clock arrival schedule) while every engine
    decodes on its own thread and the controller ticks on its own.
    Returns ``(stats, requests, engines)``."""
    engines, agents, infos, controller = build_cluster(args, registry,
                                                       arch_names)
    cluster = ThreadedCluster(controller, agents, engines)
    t_start = time.monotonic()
    reqs = build_workload(args, arch_names, t_start)
    cluster.start()
    try:
        for r in reqs:
            time.sleep(max(0.0, r.arrival_time - time.monotonic()))
            controller.submit(r, time.monotonic())
        cluster.wait(lambda: all(_terminal(r) for r in reqs),
                     timeout=args.max_wall)
    finally:
        cluster.stop()
    stats = summarize(reqs, controller, engines, t_start, time.monotonic())
    stats["driver"] = "threaded"
    stats["routing"] = controller.cfg.routing
    stats["engine_rounds"] = list(cluster.rounds)
    stats["controller_ticks"] = cluster.ticks
    return stats, reqs, engines


def run_once(args, registry, arch_names):
    run = run_threaded if args.threaded else run_round_robin
    return run(args, registry, arch_names)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--arch2", default=None,
                    help="second model for multi-model serving")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--decode-burst", type=int, default=1,
                    help="decode iterations per engine round trip "
                         "(QLMAgent.run_iteration drives steps())")
    ap.add_argument("--backend", default=None,
                    choices=[None, "cuda", "paged-cuda"],
                    help="attention backend: None / paged-cuda = the KV page "
                         "pool (full attention only; refuses mamba2-130m "
                         "and zamba2-1.2b, which have no pageable KV), "
                         "cuda = dense per-slot caches (sliding-window "
                         "models, mamba2 and zamba2 too)")
    ap.add_argument("--prefix-sharing", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="refcounted shared-prefix KV pages")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threaded", action="store_true",
                    help="thread-per-engine serve loop (ThreadedCluster)")
    ap.add_argument("--hetero", action="store_true",
                    help="heterogeneous capacity tiers (fast/mid/slow), "
                         "each calibrated separately")
    ap.add_argument("--routing", default="solver",
                    choices=["solver", "slice"],
                    help="group placement policy (core/routing.py)")
    ap.add_argument("--debug-invariants", action="store_true",
                    help="run the engine/queue invariant checkers every "
                         "round/tick")
    ap.add_argument("--max-wall", type=float, default=180.0,
                    help="wall-clock bound per run")
    ap.add_argument("--compare-drivers", action="store_true",
                    help="run threaded AND round-robin same-seed")
    ap.add_argument("--compare-routing", action="store_true",
                    help="run slice AND solver routing same-seed")
    ap.add_argument("--json", default=None, help="write final stats JSON")
    args = ap.parse_args(argv)

    arch_names = [args.arch] + ([args.arch2] if args.arch2 else [])
    registry = build_registry(arch_names, args.seed, args.device)
    if args.hetero:
        registry = shard_registry(registry)

    out = {}
    if args.compare_drivers:
        for threaded in (True, False):
            a = argparse.Namespace(**vars(args))
            a.threaded = threaded
            out["threaded" if threaded else "round-robin"] = \
                run_once(a, registry, arch_names)[0]
    elif args.compare_routing:
        for routing in ("slice", "solver"):
            a = argparse.Namespace(**vars(args))
            a.routing = routing
            out[routing] = run_once(a, registry, arch_names)[0]
    else:
        out["run"] = run_once(args, registry, arch_names)[0]

    for name, st in out.items():
        if len(out) > 1:
            print(f"--- {name} ---")
        for k, v in st.items():
            print(f"{k:18s} {v:.3f}" if isinstance(v, float)
                  else f"{k:18s} {v}")
    if args.compare_drivers:
        t, rr = out["threaded"]["tokens_per_s"], \
            out["round-robin"]["tokens_per_s"]
        print(f"tokens/s           threaded {t:.1f} vs round-robin {rr:.1f} "
              f"({t / max(rr, 1e-9):.2f}x)")
    if args.compare_routing:
        print(f"attainment         slice "
              f"{out['slice']['slo_attainment']:.3f} vs solver "
              f"{out['solver']['slo_attainment']:.3f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out["run"] if "run" in out else out


if __name__ == "__main__":
    main()
