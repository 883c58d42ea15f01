"""Async serving driver: QLM cluster behind the backpressure front end
(PyTorch twin of ``src/repro/launch/async_serve.py``).

Same reduced-model cluster of the port's engines as ``launch/serve.py``
(on the card by default, ``--device cpu`` for the kernels' plain
versions), but driven through
``serving.frontend.AsyncServer``: a bounded request queue with high/low
backpressure watermarks and 429-style rejection, per-request deadlines
(expired requests never dispatch), client cancellation that frees KV
mid-decode, token streaming, and graceful shedding of batch traffic when
interactive SLOs are predicted to be violated.

  PYTHONPATH=src python -m repro_torch.launch.async_serve --arch \
      granite-3-2b --requests 40 --rate 4.0 --queue-depth 32 \
      --shed-policy defer

The profiles are calibrated before the wall clock starts, which also
builds and loads the kernels the engines run, so no ``nvcc`` run lands
inside a request's TTFT.

Flags beyond serve.py's:

  --queue-depth N     hard bound on queued-unstarted requests (429 past it);
                      watermarks default to 3/4 (engage) and 1/2 (release)
  --shed-policy P     defer | drop | off — what happens to running
                      batch-class slots when an interactive violation is
                      predicted (defer = evict resumable, drop = cancel)
  --admit-drain B     off | slo | SECONDS — RWT admission gate bound
  --sessions N        drive N multi-turn sessions (--session-turns each)
                      through the queue instead of independent requests;
                      follow-up turns carry the conversation as a prompt
                      prefix (prefix-cache traffic)
  --slo-scale S       multiply every request's TTFT SLO by S (reduced
                      models on CPU need sub-second SLOs to see pressure)
  --compare-sync      also run the synchronous serve.py-style loop on an
                      identical same-seed workload and report both
  --json PATH         write the stats dict as JSON (CI smoke asserts on it)
  --device D          torch device of every engine (default cuda)
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np

from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.lso import QLMAgent
from repro_torch.core.qlm import QLMConfig, QLMController
from repro_torch.core.request import SLO_CLASSES, make_request
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.data.workload import SessionSpec, generate_sessions
from repro_torch.launch.serve import (build_registry, calibrate_registry,
                                      engine_config, summarize)
from repro_torch.serving import (AsyncServer, ContinuousBatchingEngine,
                                 FrontendConfig, run_session)

CLASSES = ("interactive", "batch1", "batch2")


def build_requests(args, arch_names):
    """Same-seed reproducible open-loop workload: (request, arrival_offset)
    pairs.  Rebuilt per run — Request objects are mutated by serving."""
    rng = np.random.default_rng(args.seed)
    offs = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    out = []
    for i in range(args.requests):
        prompt = rng.integers(0, 100,
                              size=int(rng.integers(4, 24))).tolist()
        r = make_request(prompt, rng.choice(arch_names), rng.choice(CLASSES),
                         max_new_tokens=args.max_new_tokens)
        if r.slo_class != "interactive":
            r.max_new_tokens = args.batch_new_tokens
        r.slo *= args.slo_scale
        out.append((r, float(offs[i])))
    return out


def build_cluster(args, registry, hw_by_model, arch_names):
    ecfg = engine_config(args, registry[arch_names[0]][1]["embed"].dtype)
    engines, agents, infos = [], [], []
    for i in range(args.instances):
        m0, p0 = registry[arch_names[0]]
        eng = ContinuousBatchingEngine(m0, p0, ecfg, model_name=arch_names[0])
        vq = VirtualQueue(i)
        agents.append(QLMAgent(eng, vq, registry))
        engines.append(eng)
        infos.append(InstanceInfo(i, dict(hw_by_model), eng.model_name, vq))
    controller = QLMController(
        infos, QLMConfig(avg_batch_size=args.slots,
                         reschedule_cooldown=args.reschedule_cooldown,
                         routing=getattr(args, "routing", "solver")))
    controller.attach_engines(engines)
    return engines, agents, infos, controller


def class_attainment(reqs, cls: str, now: float) -> float:
    """Per-class SLO attainment with the same scoring rules as
    QLMController.slo_attainment (drops and stranded-past-deadline
    requests are misses)."""
    scored = hits = 0
    for r in reqs:
        if r.slo_class != cls:
            continue
        met = r.slo_met()
        if met is not None:
            scored += 1
            hits += int(met)
        elif r.dropped() or now > r.deadline:
            scored += 1
    return hits / scored if scored else 1.0


def run_sync(args, registry, hw_by_model, arch_names) -> dict:
    """The serve.py-style synchronous polling loop (the baseline the
    async front end must beat on interactive attainment under overload)."""
    engines, agents, infos, controller = build_cluster(
        args, registry, hw_by_model, arch_names)
    pairs = build_requests(args, arch_names)
    t_start = time.monotonic()
    for r, off in pairs:
        r.arrival_time = t_start + off
    reqs = [r for r, _ in pairs]
    pending = list(reqs)
    deadline = t_start + args.max_wall
    while any(not r.finished() for r in reqs):
        now = time.monotonic()
        if now > deadline:
            break
        while pending and pending[0].arrival_time <= now:
            controller.submit(pending.pop(0), now)
        for inst, eng, agent in zip(infos, engines, agents):
            inst.current_model = eng.model_name
            agent.run_iteration()
        if not any(e.num_active() for e in engines) and pending:
            time.sleep(min(0.01, max(0.0,
                                     pending[0].arrival_time - now)))
    now = time.monotonic()
    stats = summarize(reqs, controller, engines, t_start, now)
    stats["slo_attainment"] = controller.slo_attainment(now)
    for cls in CLASSES:
        stats[f"attainment_{cls}"] = class_attainment(reqs, cls, now)
    return stats


async def run_async(args, registry, hw_by_model, arch_names) -> dict:
    engines, agents, infos, controller = build_cluster(
        args, registry, hw_by_model, arch_names)
    admission = None if args.admit_drain in (None, "off") \
        else ("slo" if args.admit_drain == "slo" else float(args.admit_drain))
    fcfg = FrontendConfig(
        queue_depth=args.queue_depth, shed_policy=args.shed_policy,
        admission=admission,
        interactive_slo_ceiling=SLO_CLASSES["interactive"] * args.slo_scale,
        shed_cooldown_s=args.shed_cooldown)
    server = AsyncServer(controller, agents, fcfg)
    free0 = [e.block_mgr.free_blocks for e in engines]
    t_start = time.monotonic()
    reqs, sessions = [], []

    async def feed(req, offset):
        req.arrival_time = t_start + offset
        await asyncio.sleep(max(0.0, req.arrival_time - time.monotonic()))
        await server.submit(req)

    async def feed_session(sess):
        await asyncio.sleep(max(0.0, sess.arrival_time - time.monotonic()))
        await run_session(server, sess)

    tasks = []
    async with server:
        if args.sessions > 0:
            spec = SessionSpec(n_sessions=args.sessions,
                               turns=args.session_turns, seed=args.seed,
                               model=arch_names[0], slo_class="interactive",
                               arrival_rate=args.rate,
                               think_time_s=args.think_time,
                               max_new_tokens=args.max_new_tokens,
                               vocab=100)
            sessions = generate_sessions(spec)
            for s in sessions:
                s.arrival_time = t_start + s.arrival_time
                s.slo_s = SLO_CLASSES[s.slo_class] * args.slo_scale
                tasks.append(asyncio.ensure_future(feed_session(s)))
        else:
            pairs = build_requests(args, arch_names)
            reqs = [r for r, _ in pairs]
            tasks = [asyncio.ensure_future(feed(r, off)) for r, off in pairs]
        try:
            await asyncio.wait_for(asyncio.gather(*tasks), args.max_wall)
            await asyncio.wait_for(server.drain(), args.max_wall)
        except asyncio.TimeoutError:
            for t in tasks:
                t.cancel()
            await server.stop(cancel_outstanding=True)
    now = time.monotonic()
    if args.sessions > 0:
        reqs = reqs + [r for s in sessions for r in s.requests]
    stats = summarize(reqs, controller, engines, t_start, now)
    stats["slo_attainment"] = controller.slo_attainment(now)
    for cls in CLASSES:
        stats[f"attainment_{cls}"] = class_attainment(reqs, cls, now)
    fs = server.stats
    stats.update({
        "accepted": fs.accepted,
        "rejected": fs.rejected,
        "rejected_backpressure": fs.rejected_backpressure,
        "expired": fs.expired,
        "cancelled": fs.cancelled,
        "shed_deferred": fs.shed_deferred,
        "shed_dropped": fs.shed_dropped,
        "deferred_groups": fs.deferred_groups,
        "tokens_streamed": fs.tokens_streamed,
        "acceptance_rate": fs.acceptance_rate,
        "rejection_rate": fs.rejection_rate,
        "expiry_rate": fs.expiry_rate,
        "mean_tokens_per_accepted": fs.mean_tokens_per_accepted,
        "max_queue_depth": fs.max_queue_depth,
        "backpressure_engagements": fs.backpressure_engagements,
        "rejected_unservable": fs.rejected_unservable,
        "rejected_capacity": fs.rejected_capacity,
        "engine_failures": fs.engine_failures,
        "redeliveries": controller.redeliveries,
        "failed_quarantined": len(controller.failed),
        "dead_instances": sum(1 for i in range(len(controller.instances))
                              if not controller.is_alive(i)),
        "kv_blocks_leaked": sum(
            f0 - e.block_mgr.free_blocks
            for f0, e in zip(free0, engines)),
        "clean_shutdown": int(not server._live),
    })
    if args.sessions > 0:
        stats["sessions"] = len(sessions)
        stats["session_turns_served"] = sum(
            1 for s in sessions for r in s.requests if r.ttft() is not None)
    return stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--arch2", default=None)
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--batch-new-tokens", type=int, default=None,
                    help="max_new_tokens for batch-class requests "
                         "(default: same as --max-new-tokens)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--decode-burst", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--backend", default=None,
                    choices=[None, "cuda", "paged-cuda"])
    ap.add_argument("--prefix-sharing", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queue-depth", type=int, default=32)
    ap.add_argument("--shed-policy", default="defer",
                    choices=["defer", "drop", "off"])
    ap.add_argument("--shed-cooldown", type=float, default=0.25)
    ap.add_argument("--admit-drain", default="off",
                    help="off | slo | SECONDS (RWT admission gate)")
    ap.add_argument("--sessions", type=int, default=0)
    ap.add_argument("--session-turns", type=int, default=3)
    ap.add_argument("--think-time", type=float, default=0.05)
    ap.add_argument("--slo-scale", type=float, default=1.0)
    ap.add_argument("--reschedule-cooldown", type=float, default=0.5)
    ap.add_argument("--routing", default="solver",
                    choices=["solver", "slice"],
                    help="group placement policy (core/routing.py)")
    ap.add_argument("--max-wall", type=float, default=120.0,
                    help="wall-clock bound; past it outstanding requests "
                         "are cancelled and the server shuts down cleanly")
    ap.add_argument("--compare-sync", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.batch_new_tokens is None:
        args.batch_new_tokens = args.max_new_tokens

    arch_names = [args.arch] + ([args.arch2] if args.arch2 else [])
    registry = build_registry(arch_names, args.seed, args.device)
    ecfg = engine_config(args, registry[arch_names[0]][1]["embed"].dtype)
    hw_by_model = calibrate_registry(registry, ecfg)

    stats = asyncio.run(run_async(args, registry, hw_by_model, arch_names))
    out = {"async": stats}
    if args.compare_sync:
        out["sync"] = run_sync(args, registry, hw_by_model, arch_names)
    for name, st in out.items():
        print(f"--- {name} ---")
        for k, v in st.items():
            print(f"{k:24s} {v:.3f}" if isinstance(v, float)
                  else f"{k:24s} {v}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
