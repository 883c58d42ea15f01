"""The async front end (``repro_torch.serving.frontend``, a copy of the JAX
package's) over the port's engines on the CPU: twins of the engine-backed
tests of ``tests/test_async_frontend.py`` (mid-decode cancellation frees
KV, deadline expiry never dispatches, session turns hit the prefix cache,
drain-stop streams every token, stop cancels what is outstanding, async
beats sync under overload, a crashed serve loop fails its waiters), on the
JAX tests' weights (``jax.random.key(0)``, carried across by
``models/convert.py``).  Streams served through the front end must carry
the JAX engine's greedy tokens for the same prompts (exact).

Stdlib asyncio only: each test drives its own ``asyncio.run``.
"""
import argparse
import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.core.request import Request as JaxRequest
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro_torch.configs import get_arch
from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.lso import QLMAgent
from repro_torch.core.qlm import QLMConfig, QLMController
from repro_torch.core.request import make_request
from repro_torch.core.rwt_estimator import HardwareProfile
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.data.workload import Session
from repro_torch.launch import async_serve
from repro_torch.launch.serve import calibrate_registry
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (AsyncServer, ContinuousBatchingEngine,
                                 EngineConfig, FrontendConfig, run_session)

torch.set_num_threads(2)
ARCH = "granite-3-2b"


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params), (port model, the same params)."""
    cfg = ARCHITECTURES[ARCH].reduced(num_layers=1, d_model=64)
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    tcfg = get_arch(ARCH).reduced(num_layers=1, d_model=64)
    return (jmodel, jparams), (build_model(tcfg), from_jax_params(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))


def _hw():
    return HardwareProfile(prefill_time=0.05, decode_per_token=0.02,
                           inefficiency=1.2, token_capacity=512,
                           swap_time=0.2, model_max_tokens=64)


def _stack(tiny, *, slots=4, fcfg=None):
    model, params = tiny[1]
    ecfg = EngineConfig(max_slots=slots, max_seq_len=128, block_size=8,
                        attention_backend="paged-cuda", prefix_sharing=True,
                        device="cpu")
    eng = ContinuousBatchingEngine(model, params, ecfg, model_name=ARCH)
    vq = VirtualQueue(0)
    agent = QLMAgent(eng, vq, {ARCH: (model, params)})
    info = InstanceInfo(0, {ARCH: _hw()}, eng.model_name, vq)
    controller = QLMController([info], QLMConfig(avg_batch_size=slots,
                                                 reschedule_cooldown=0.5))
    server = AsyncServer(controller, [agent], fcfg or FrontendConfig())
    return eng, controller, server


def _req(n_prompt=10, n_new=8, slo_class="interactive", seed=0):
    rng = np.random.default_rng(seed)
    return make_request(rng.integers(0, 100, size=n_prompt).tolist(), ARCH,
                        slo_class, arrival_time=time.monotonic(),
                        max_new_tokens=n_new)


def _jax_tokens(tiny, prompts, n_new):
    """The JAX engine's greedy tokens for ``prompts`` (one batch)."""
    jmodel, jparams = tiny[0]
    eng = JaxEngine(jmodel, jparams, JaxEngineConfig(
        attention_backend="paged-xla", max_slots=len(prompts),
        max_seq_len=128, block_size=8), model_name=ARCH)
    reqs = [JaxRequest(prompt_tokens=list(p), model=ARCH, slo=1e9,
                       max_new_tokens=n_new) for p in prompts]
    for r in reqs:
        assert eng.admit(r)
    while eng.num_active():
        eng.step()
    return [r.output_tokens for r in reqs]


def test_cancellation_mid_decode_frees_kv_blocks(tiny):
    eng, controller, server = _stack(tiny, slots=2)
    free0 = eng.block_mgr.free_blocks
    assert free0 == eng.block_mgr.num_blocks
    keeper = _req(n_prompt=12, n_new=6, seed=2)

    async def go():
        async with server:
            victim = _req(n_prompt=12, n_new=64, seed=1)
            vs = await server.submit(victim)
            ks = await server.submit(keeper)
            got = []
            async for tok in vs:
                got.append(tok)
                if len(got) == 3:
                    vs.cancel()                        # mid-decode
                    break
            kept = await ks.drain()
            await server.drain()
            assert vs.status == "cancelled"
            return got, kept

    got, kept = asyncio.run(go())
    assert len(got) == 3
    assert eng.stats.cancellations == 1
    assert eng.block_mgr.free_blocks == free0
    assert eng.block_mgr.used_blocks == 0 and eng.num_active() == 0
    assert controller.slo_attainment(time.monotonic()) == 1.0
    assert [kept] == _jax_tokens(tiny, [keeper.prompt_tokens], 6)


def test_deadline_expired_request_never_dispatches(tiny):
    eng, controller, server = _stack(tiny, slots=1,
                                     fcfg=FrontendConfig(shed_policy="off"))

    async def go():
        async with server:
            hog = _req(n_prompt=10, n_new=48, slo_class="batch1", seed=3)
            hs = await server.submit(hog)
            doomed = _req(n_prompt=10, n_new=8, seed=4)
            ds = await server.submit(doomed)
            assert ds.status == "queued"
            # no await since submit returned: the loop cannot have
            # dispatched it; backdate the arrival (the slo stays as
            # classified)
            doomed.arrival_time -= 1e9
            await ds.drain()
            assert ds.status == "expired"
            await hs.drain()
            await server.drain()

    asyncio.run(go())
    assert server.stats.expired == 1
    doomed = [r for r in controller.all_requests() if r.expired][0]
    assert doomed.ttft() is None and doomed.finished()
    assert eng.block_mgr.used_blocks == 0
    assert controller.slo_attainment(time.monotonic()) == pytest.approx(0.5)


def test_session_follow_up_turns_hit_prefix_cache(tiny):
    eng, controller, server = _stack(tiny, slots=2)
    rng = np.random.default_rng(11)
    sess = Session(session_id=0, model=ARCH, slo_class="interactive",
                   turn_prompts=[rng.integers(0, 100, size=16).tolist()
                                 for _ in range(3)],
                   max_new_tokens=8, arrival_time=time.monotonic())

    async def go():
        async with server:
            await run_session(server, sess)
            await server.drain()

    asyncio.run(go())
    assert len(sess.requests) == 3
    assert all(r.finished() and r.session_id == 0 for r in sess.requests)
    assert [r.turn for r in sess.requests] == [0, 1, 2]
    assert eng.stats.prefix_hits >= 2
    assert eng.stats.prefix_shared_tokens >= 2 * 16
    p0, p1, p2 = [list(r.prompt_tokens) for r in sess.requests]
    assert p1[:len(p0) + 8] == p0 + list(sess.requests[0].output_tokens)
    assert p2[:len(p1) + 8] == p1 + list(sess.requests[1].output_tokens)
    assert eng.block_mgr.used_blocks == 0
    # a turn served on shared prefix pages gives the JAX engine's tokens
    # for its whole prompt
    assert [r.output_tokens for r in sess.requests] == _jax_tokens(
        tiny, [r.prompt_tokens for r in sess.requests], 8)


def test_drain_stop_clean_shutdown_streams_all_tokens(tiny):
    eng, controller, server = _stack(tiny, slots=4)
    reqs = [_req(n_prompt=8, n_new=6, seed=i) for i in range(3)]

    async def go():
        async with server:
            streams = [await server.submit(r) for r in reqs]
            toks = [await s.drain() for s in streams]
            await server.drain()
            return toks

    toks = asyncio.run(go())
    assert all(len(t) == 6 for t in toks)
    assert toks == [r.output_tokens for r in reqs]
    assert toks == _jax_tokens(tiny, [r.prompt_tokens for r in reqs], 6)
    assert server.stats.tokens_streamed == 18
    assert not server._live and server._task is None
    assert server.stats.accepted == 3 and server.stats.rejected == 0
    assert eng.block_mgr.used_blocks == 0


def test_stop_cancels_outstanding(tiny):
    eng, controller, server = _stack(tiny, slots=2)

    async def go():
        await server.start()
        s = await server.submit(_req(n_prompt=10, n_new=64, seed=7))
        while s.request.first_token_time is None:
            await asyncio.sleep(0.005)
        await server.stop(cancel_outstanding=True)
        return s

    s = asyncio.run(go())
    assert s.status == "cancelled"
    assert eng.block_mgr.used_blocks == 0
    assert eng.block_mgr.free_blocks == eng.block_mgr.num_blocks


def _overload_args(requests):
    # the JAX test's arguments (reschedule_cooldown past the run throttles
    # the controller's re-solve for both runners, so the comparison
    # isolates what the front end adds), the backend the port's
    return argparse.Namespace(
        seed=0, rate=400.0, requests=requests, max_new_tokens=2,
        batch_new_tokens=100, slots=2, decode_burst=8, backend="paged-cuda",
        prefix_sharing=True, instances=1, queue_depth=512,
        shed_policy="defer", shed_cooldown=0.15, admit_drain="off",
        sessions=0, session_turns=0, think_time=0.0, slo_scale=0.08,
        reschedule_cooldown=1e9, max_wall=90.0, device="cpu")


def test_async_beats_sync_interactive_attainment_under_overload(tiny):
    """The JAX test's overload at half its length (200 requests in 0.5 s
    at 2 slots, not 400 in 1 s), which keeps the port's CPU engines
    within the test's time budget."""
    registry = {ARCH: tiny[1]}
    args = _overload_args(200)
    ecfg = EngineConfig(max_slots=args.slots, max_seq_len=128,
                        attention_backend=args.backend,
                        prefix_sharing=args.prefix_sharing, device="cpu")
    np.random.seed(0)            # calibrate_from_engine draws its prompts
    hw = calibrate_registry(registry, ecfg)

    sync_stats = async_serve.run_sync(args, registry, hw, [ARCH])
    async_stats = asyncio.run(async_serve.run_async(args, registry, hw,
                                                    [ARCH]))

    assert async_stats["clean_shutdown"] == 1
    assert async_stats["kv_blocks_leaked"] == 0
    assert async_stats["tokens_streamed"] > 0
    assert async_stats["attainment_interactive"] \
        > sync_stats["attainment_interactive"], (async_stats, sync_stats)


def test_serve_loop_crash_fails_waiters_instead_of_hanging(tiny):
    eng, controller, server = _stack(tiny, slots=2)

    class _Boom(RuntimeError):
        pass

    async def go():
        await server.start()
        stream = await server.submit(_req(n_prompt=6, n_new=64, seed=11))

        def explode():
            raise _Boom("engine round blew up")

        server.agents[0].run_iteration = explode
        with pytest.raises(_Boom):
            await asyncio.wait_for(stream.drain(), timeout=10)
        with pytest.raises(_Boom):
            await asyncio.wait_for(server.drain(), timeout=10)
        with pytest.raises(_Boom):
            await server.submit(_req(seed=12))
        with pytest.raises(_Boom):
            await server._task

    asyncio.run(go())


def test_async_serve_cli_serves_sessions_on_the_cpu():
    """``async_serve --device cpu --sessions 2``: every turn is served
    through the queue, later turns hit the prefix cache (a turn's prompt
    holds the earlier turns', at least one full 16-token page by the third
    turn), nothing leaks."""
    out = async_serve.main(["--device", "cpu", "--sessions", "2",
                            "--session-turns", "3", "--rate", "20",
                            "--max-new-tokens", "8", "--slots", "4"])
    st = out["async"]
    assert st["session_turns_served"] == st["requests"] == 6
    assert st["prefix_hits"] >= 2
    assert st["kv_blocks_leaked"] == 0 and st["clean_shutdown"] == 1
