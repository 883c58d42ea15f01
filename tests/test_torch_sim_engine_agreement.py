"""Simulator/engine agreement on the port (twins of the seven tests of
``tests/test_sim_engine_agreement.py``): the same deterministic QLM
scenario, driven once through the port's ``ClusterSimulator`` and once
through the port's engine under the port's QLM controller and agent, gives
the same admission, eviction and swap counts.  The engine serves reduced
granite and h2o-danube on the dense per-slot backend (``"cuda"``, which
holds both, so they swap on one engine) with the JAX weights carried
across (``models/convert.py``).  One assertion the reference lacks: on the
two-group scenario the port's engine counters equal the JAX engine's on
the same weights and the same trace.

The port's engine keeps no ``completed`` list: admissions are counted as
the requests that finished.  Twins name ``attention_backend="cuda"``: the
port's default (``None``) is the page pool, the reference's the dense
layout.

Tolerance: exact on counts; ``pytest.approx`` where the reference uses it
(float charges of the simulator's profile arithmetic).
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.core.global_scheduler import InstanceInfo as JaxInstanceInfo
from repro.core.lso import QLMAgent as JaxAgent
from repro.core.qlm import QLMConfig as JaxQLMConfig
from repro.core.qlm import QLMController as JaxController
from repro.core.request import make_request as jax_make_request
from repro.core.rwt_estimator import HardwareProfile as JaxHardwareProfile
from repro.core.virtual_queue import VirtualQueue as JaxVirtualQueue
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
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.engine import EngineStats
from repro_torch.sim.simulator import ClusterSimulator

torch.set_num_threads(2)
MODELS = ("granite-3-2b", "h2o-danube-1.8b")
COUNTS = [f.name for f in dataclasses.fields(EngineStats)
          if f.type in (int, "int")]

# the two packages' controller stacks, in the order _run_engine takes them
PORT = (ContinuousBatchingEngine, EngineConfig, VirtualQueue, QLMAgent,
        InstanceInfo, QLMController, QLMConfig, HardwareProfile)
JAX = (JaxEngine, JaxEngineConfig, JaxVirtualQueue, JaxAgent,
       JaxInstanceInfo, JaxController, JaxQLMConfig, JaxHardwareProfile)


@pytest.fixture(scope="module")
def registries():
    key = jax.random.key(0)
    jax_reg, port_reg = {}, {}
    for name in MODELS:
        jcfg = ARCHITECTURES[name].reduced(num_layers=2, d_model=128)
        tcfg = get_arch(name).reduced(num_layers=2, d_model=128)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(key)
        jax_reg[name] = (jmodel, jparams)
        port_reg[name] = (build_model(tcfg), from_jax_params(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    return jax_reg, port_reg


@pytest.fixture(scope="module")
def registry(registries):
    return registries[1]


HW = dict(prefill_time=0.05, decode_per_token=0.02, inefficiency=1.2,
          token_capacity=512, swap_time=0.2, model_max_tokens=64)
# slow enough that a queued interactive group's RWT-estimated completion
# busts its 20 s TTFT SLO, forcing the violation-triggered reorder (and so
# the head-change eviction) on both stacks
SLOW_HW = dict(prefill_time=0.05, decode_per_token=0.6, inefficiency=1.2,
               token_capacity=80, swap_time=0.2, model_max_tokens=8)


def _hw():
    return HardwareProfile(**HW)


def _slow_hw():
    return HardwareProfile(**SLOW_HW)


def _mk_reqs(now=0.0, make=make_request):
    """4 + 4 requests over two models, all at t=now: two request groups."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        r = make(rng.integers(0, 100, size=6).tolist(), MODELS[i % 2],
                 "batch1", arrival_time=now, max_new_tokens=3)
        r.true_output_tokens = 3
        reqs.append(r)
    return reqs


def _run_engine(registry, reqs, submit_late=None, max_slots=4, hw=HW,
                decode_burst=1, stack=PORT):
    (Engine, Config, VQ, Agent, Info, Controller, QConfig, Profile) = stack
    names = list(MODELS)
    m0, p0 = registry[names[0]]
    kw = {"device": "cpu"} if stack is PORT else {}
    eng = Engine(m0, p0, Config(max_slots=max_slots, max_seq_len=64,
                                decode_burst=decode_burst,
                                attention_backend="cuda" if stack is PORT
                                else None, **kw),
                 model_name=names[0])
    vq = VQ(0)
    agent = Agent(eng, vq, registry)
    info = Info(0, {n: Profile(**hw) for n in names}, eng.model_name, vq)
    controller = Controller([info], QConfig(avg_batch_size=max_slots,
                                            reschedule_cooldown=0.0))
    now = time.monotonic()
    for r in reqs:
        controller.submit(r, now)
    for it in range(400):
        info.current_model = eng.model_name
        agent.run_iteration()
        if submit_late is not None and it == submit_late[0]:
            for r in submit_late[1]:
                controller.submit(r, time.monotonic())
        late = submit_late[1] if submit_late else []
        if all(r.finished() for r in list(reqs) + list(late)):
            break
    return eng, controller


def _run_sim(reqs, max_batch=4, chunked=False, hw=_hw):
    profs = [{n: hw() for n in MODELS}]
    kw = {"traits_override": {"prefill_chunk_tokens": 16}} if chunked else {}
    sim = ClusterSimulator(profs, "qlm", max_batch_requests=max_batch, **kw)
    metrics = sim.run(reqs)
    return sim, metrics


def test_two_group_swap_and_admission_counts_agree(registries):
    jax_reg, registry = registries
    reqs_e = _mk_reqs(now=time.monotonic())
    eng, _ = _run_engine(registry, reqs_e)
    assert all(r.finished() for r in reqs_e)

    reqs_s = _mk_reqs(now=0.0)
    sim, metrics = _run_sim(reqs_s)
    assert metrics["completed"] == float(len(reqs_s))

    # admissions: every request served exactly once on both sides
    assert sum(r.finished() for r in reqs_e) == int(metrics["completed"]) == 8
    # evictions: group-ordered service drains each group before the head
    # changes: no HOL eviction on either side
    assert eng.stats.evictions == metrics["evictions"] == 0
    # swaps: the sim counts the cold model load, the engine starts loaded
    assert metrics["swaps"] - 1 == eng.stats.model_swaps
    assert eng.stats.model_swaps == 1

    # the port's engine counts what the JAX engine counts on the same trace
    reqs_j = _mk_reqs(now=time.monotonic(), make=jax_make_request)
    jeng, _ = _run_engine(jax_reg, reqs_j, stack=JAX)
    assert all(r.finished() for r in reqs_j)
    assert {k: getattr(eng.stats, k) for k in COUNTS} \
        == {k: getattr(jeng.stats, k) for k in COUNTS}
    assert [r.output_tokens for r in reqs_e] \
        == [r.output_tokens for r in reqs_j]


def test_head_change_eviction_counts_agree(registry):
    """An interactive group jumping the head evicts exactly one running
    batch request on both sides (evict until the head request fits)."""
    def mk_batch(now):
        out = []
        for _ in range(2):
            r = make_request(list(range(8)), MODELS[0], "batch2",
                             arrival_time=now, max_new_tokens=30)
            r.true_output_tokens = 30
            out.append(r)
        return out

    def mk_inter(now):
        r = make_request(list(range(8)), MODELS[0], "interactive",
                         arrival_time=now, max_new_tokens=2)
        r.true_output_tokens = 2
        return r

    now = time.monotonic()
    batch_e = mk_batch(now)
    inter_e = mk_inter(now)
    eng, _ = _run_engine(registry, batch_e, submit_late=(3, [inter_e]),
                         max_slots=2, hw=SLOW_HW)
    assert inter_e.finished() and all(r.finished() for r in batch_e)

    batch_s = mk_batch(0.0)
    inter_s = mk_inter(0.1)
    sim, metrics = _run_sim(batch_s + [inter_s], max_batch=2, hw=_slow_hw)
    assert metrics["completed"] == 3.0

    assert eng.stats.evictions == 1
    assert int(metrics["evictions"]) == 1
    assert all(r.finished() for r in batch_e) \
        and all(r.finished() for r in batch_s)


def test_swa_chunk_quantum_counts_agree(registry):
    """The engine clamps its chunk quantum to a model's sliding window; with
    HardwareProfile.sliding_window the simulator and the RWT prefill term
    charge the same chunk counts for a window model served with chunk >
    window."""
    name = "h2o-danube-1.8b"          # reduced() keeps sliding_window=64
    model, params = registry[name]
    assert model.cfg.sliding_window == 64
    eng = ContinuousBatchingEngine(
        model, params,
        EngineConfig(device="cpu", attention_backend="cuda", max_slots=1,
                     max_seq_len=256, prefill_chunk_tokens=128),
        model_name=name)
    assert eng._chunk_quantum() == 64
    prompt = list(range(100))
    r = make_request(prompt, name, "batch1", arrival_time=0.0,
                     max_new_tokens=2)
    assert eng.admit(r)
    for _ in range(20):
        eng.step()
        if r.finished():
            break
    assert r.finished()
    assert eng.stats.prefill_chunks == 2          # ceil(100 / 64)

    hw = HardwareProfile(**HW, sliding_window=64)
    sim = ClusterSimulator([{name: hw}], "qlm",
                           traits_override={"prefill_chunk_tokens": 128})
    r_s = make_request(prompt, name, "batch1", arrival_time=0.0,
                       max_new_tokens=2)
    r_s.true_output_tokens = 2
    sim.run([r_s])
    assert sim.instances[0].stats.prefill_rounds == 2
    hw_chunked = dataclasses.replace(hw, prefill_chunk_tokens=128)
    assert hw_chunked.chunk_quantum() == eng._chunk_quantum() == 64
    assert hw_chunked.prefill_seconds(100) == pytest.approx(
        hw.prefill_seconds(100) + 2 * hw.decode_per_token)


def test_burst_mode_counts_agree_and_dispatch_amortizes(registry):
    """The engine at ``decode_burst=4`` gives the simulator's admission,
    eviction and swap counts, and a burst width in HardwareProfile makes
    the simulator charge the per-dispatch overhead once a burst."""
    reqs_e = _mk_reqs(now=time.monotonic())
    eng, _ = _run_engine(registry, reqs_e, decode_burst=4)
    assert all(r.finished() for r in reqs_e)

    def hw_burst(burst):
        def mk():
            return HardwareProfile(**HW, decode_burst=burst,
                                   dispatch_overhead=0.01)
        return mk

    sim1, m1 = _run_sim(_mk_reqs(), hw=hw_burst(1))
    sim4, m4 = _run_sim(_mk_reqs(), hw=hw_burst(4))
    assert sum(r.finished() for r in reqs_e) == int(m4["completed"]) == 8
    assert eng.stats.evictions == int(m4["evictions"]) == 0
    assert m4["swaps"] - 1 == eng.stats.model_swaps == 1
    for key in ("completed", "evictions", "swaps", "preemptions"):
        assert m1[key] == m4[key], key
    busy1 = sum(i.stats.busy_time for i in sim1.instances)
    busy4 = sum(i.stats.busy_time for i in sim4.instances)
    assert busy4 < busy1
    assert hw_burst(4)().decode_seconds() == pytest.approx(0.02 + 0.01 / 4)
    assert hw_burst(1)().decode_seconds() == pytest.approx(0.03)
    assert hw_burst(4)().decode_seconds(1) == pytest.approx(0.03)


def test_calibration_threads_burst_width(registry):
    """calibrate_from_engine carries the engine's decode_burst into the
    profile."""
    from repro_torch.sim.profiles import calibrate_from_engine
    name = MODELS[0]
    model, params = registry[name]
    eng = ContinuousBatchingEngine(
        model, params, EngineConfig(device="cpu", attention_backend="cuda",
                                    max_slots=2, max_seq_len=64,
                                    decode_burst=4),
        model_name=name)
    hw = calibrate_from_engine(eng, token_capacity=512,
                               dispatch_overhead=0.005)
    assert hw.decode_burst == 4
    assert hw.decode_seconds() == pytest.approx(
        hw.decode_per_token + 0.005 / 4)


def test_effective_prefill_tokens_reflect_cache_hits():
    """Shared-prefix cache hits shrink both the RWT prefill term and the
    simulator's prefill work (Request.prefix_shared_tokens)."""
    hw = HardwareProfile(**HW, prefill_chunk_tokens=16)
    assert hw.prefill_seconds(64, effective_prompt_tokens=16) \
        == pytest.approx(0.05 * 16 / 1024 + 1 * 0.02)
    assert hw.prefill_seconds(64, effective_prompt_tokens=16) \
        < hw.prefill_seconds(64)
    from repro_torch.core.rwt_estimator import RWTEstimator, WorkloadProfile
    est = RWTEstimator()
    wl = WorkloadProfile(64.0, 1.0, 8.0, 1.0)
    full = est.request_completion(0, wl, hw, prompt_tokens=64.0)
    eff = est.request_completion(0, wl, hw, prompt_tokens=64.0,
                                 effective_prompt_tokens=16.0)
    assert eff.mean < full.mean

    def run_one(shared):
        r = make_request(list(range(100)), MODELS[0], "batch1",
                         arrival_time=0.0, max_new_tokens=2)
        r.true_output_tokens = 2
        r.prefix_shared_tokens = shared
        sim = ClusterSimulator([{MODELS[0]: hw}], "qlm",
                               traits_override={"prefill_chunk_tokens": 16})
        sim.run([r])
        return sim.instances[0].stats

    assert run_one(0).prefill_rounds == 7      # ceil(100 / 16)
    assert run_one(64).prefill_rounds == 3     # ceil((100 - 64) / 16)


def test_chunked_sim_same_counts_as_lump(registry):
    """The chunk-interleaved simulator accounting changes timing only: the
    two-group scenario's counts match the lump-prefill simulator's and so
    the engine's."""
    _, lump = _run_sim(_mk_reqs())
    _, chunk = _run_sim(_mk_reqs(), chunked=True)
    for key in ("completed", "evictions", "swaps", "preemptions"):
        assert lump[key] == chunk[key], key
    reqs_e = _mk_reqs(now=time.monotonic())
    eng, _ = _run_engine(registry, reqs_e)
    assert sum(r.finished() for r in reqs_e) == int(chunk["completed"])
    assert eng.stats.evictions == int(chunk["evictions"])
    assert eng.stats.model_swaps == int(chunk["swaps"]) - 1
