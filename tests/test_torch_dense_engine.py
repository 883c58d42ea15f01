"""The port's dense per-slot backend (``attention_backend="cuda"``) and its
int8 KV pools, on the CPU, against the JAX engine under the same trace and
the same weights (carried across by ``models/convert.py``):

  * ``"cuda"`` against the reference's ``"pallas"`` (Pallas decode kernels
    in interpret mode), float and int8, with mid-stream evict/resume and
    decode bursts; reduced granite, and reduced h2o-danube with prompts
    past its 64-token rolling window;
  * int8 ``"paged-cuda"`` against int8 ``"paged-pallas"`` (the repaired
    ``kv_quant`` fault: the pools hold int8 pages and scale pages), with
    and without prefix sharing;
  * a granite -> h2o-danube model swap on the dense layout, and the
    layout rules: cross-layout resume, a sliding-window model refused by
    the paged layout before anything is flushed.

Tolerance: exact on tokens.  int8 pages within 1 and scales within
rtol 1e-5: the two frameworks' float32 projections differ in the last
bits, which can move a value across a rounding boundary (the
quantization itself is bit for bit the reference's, see
tests/test_torch_model.py).
"""
import dataclasses

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
from repro_torch.core.request import Request
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

torch.set_num_threads(2)
GRANITE, DANUBE = "granite-3-2b", "h2o-danube-1.8b"
TINY = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=2)
BASE = dict(max_slots=3, max_seq_len=96, prefill_chunk_tokens=16,
            block_size=8, debug_invariants=True)
# the reference backend each port backend is held against
TWIN = {"cuda": "pallas", "paged-cuda": "paged-pallas"}


def _pair(arch, quant, seed, **over):
    jcfg = dataclasses.replace(ARCHITECTURES[arch].reduced(**TINY),
                               kv_quant=quant, **over)
    tcfg = dataclasses.replace(get_arch(arch).reduced(**TINY), kv_quant=quant,
                               **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return (jmodel, jparams), (build_model(tcfg), tparams)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, quant=False, seed=0, **over):
        key = (arch, quant, seed, tuple(sorted(over.items())))
        if key not in cache:
            cache[key] = _pair(arch, quant, seed, **over)
        return cache[key]
    return get


def _engines(pair, backend, **kw):
    (jm, jp), (tm, tp) = pair
    cfg = {**BASE, **kw}
    jax_eng = JaxEngine(jm, jp, JaxEngineConfig(attention_backend=TWIN[backend],
                                                **cfg), model_name="m1")
    port_eng = ContinuousBatchingEngine(tm, tp, EngineConfig(
        device="cpu", attention_backend=backend, **cfg), model_name="m1")
    return [(jax_eng, JaxRequest), (port_eng, Request)]


def _drain(eng, reqs, max_rounds=400):
    for _ in range(max_rounds):
        eng.steps()
        if all(r.finished() for r in reqs):
            break
    assert all(r.finished() for r in reqs)
    assert eng.block_mgr.used_blocks == 0


def _evict_resume_trace(eng, Req, prompts, n):
    reqs = [Req(prompt_tokens=list(p), model="m1", slo=1e9, max_new_tokens=n)
            for p in prompts]
    for r in reqs:
        assert eng.admit(r)
    for _ in range(3):
        eng.steps()
    assert eng.evict_request(reqs[1].req_id) is reqs[1]
    eng.steps()
    assert eng.admit(reqs[1])
    _drain(eng, reqs)
    return [r.output_tokens for r in reqs], eng.stats


@pytest.mark.parametrize("arch,quant,burst,lens", [
    (GRANITE, False, 1, (3, 21, 40)),
    (GRANITE, True, 4, (3, 21, 40)),
    # past the 64-token window: the rolling cache wraps during prefill and
    # during decode
    (DANUBE, False, 4, (70, 9, 58)),
    (DANUBE, True, 1, (70, 9, 58)),
])
def test_dense_backend_matches_jax_pallas(pairs, arch, quant, burst, lens):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in lens]
    (want, ws), (got, gs) = [
        _evict_resume_trace(eng, Req, prompts, 10)
        for eng, Req in _engines(pairs(arch, quant), "cuda",
                                 decode_burst=burst)]
    assert all(len(t) == 10 for t in want)
    assert got == want
    assert (gs.resumes, gs.evictions, gs.prefill_chunks) \
        == (ws.resumes, ws.evictions, ws.prefill_chunks)


@pytest.mark.parametrize("arch,over,quant,lens", [
    # S = 100 columns under a 128-token bucket
    (GRANITE, {}, False, (70, 85, 9)),
    (GRANITE, {}, True, (70, 85, 9)),
    # a 48-column rolling window under a 64-token bucket, wrapping
    (DANUBE, {"sliding_window": 48}, False, (70, 90, 9)),
    (DANUBE, {"sliding_window": 48}, True, (70, 90, 9)),
])
def test_chunk_bucket_past_the_cache_columns_matches_jax(pairs, arch, over,
                                                         quant, lens):
    """A padding bucket wider than the dense cache's S columns: the port
    pads to at most S, the reference drops the padding's writes; tokens
    equal."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in lens]
    (want, _), (got, _) = [
        _evict_resume_trace(eng, Req, prompts, 6)
        for eng, Req in _engines(pairs(arch, quant, **over), "cuda",
                                 max_seq_len=100, prefill_chunk_tokens=128)]
    assert all(len(t) == 6 for t in want)
    assert got == want


def test_dense_cache_layout_and_snapshot(pairs):
    """Dense int8 caches: int8 k/v slots plus scales, the reference's S
    columns; the snapshot is the slot's columns and the layout is
    "dense"."""
    _, (tm, tp) = pairs(DANUBE, True)
    eng = ContinuousBatchingEngine(tm, tp, EngineConfig(
        device="cpu", attention_backend="cuda", **BASE), model_name="m1")
    S = 64                                        # the reduced window
    assert eng.cache["k"].dtype == torch.int8
    assert tuple(eng.cache["k"].shape) == (1, 3, 2, S, 16)
    assert tuple(eng.cache["k_scale"].shape) == (1, 3, 2, S)
    r = Request(prompt_tokens=list(range(30)), model="m1", slo=1e9,
                max_new_tokens=4)
    assert eng.admit(r)
    eng.step()
    eng.step()
    eng.evict_request(r.req_id)
    snap = r.snapshot
    assert snap["layout"] == "dense" and snap["pinned"] == []
    assert tuple(snap["cache"]["k"].shape) == (1, 2, S, 16)
    assert tuple(snap["cache"]["v_scale"].shape) == (1, 2, S)
    assert not eng.prefix_sharing and eng.block_mgr.used_blocks == 0


def test_int8_paged_backend_matches_jax_paged_pallas(pairs):
    """The repaired ``kv_quant`` fault: the port's paged pools are int8 with
    scale pages holding the JAX engine's values, and the tokens match."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in (5, 21, 12)]
    engines = _engines(pairs(GRANITE, True), "paged-cuda",
                       prefix_sharing=False)
    (want, ws), (got, gs) = [_evict_resume_trace(eng, Req, prompts, 8)
                             for eng, Req in engines]
    assert got == want and gs.resumes == ws.resumes == 1
    (jax_eng, _), (port_eng, _) = engines
    assert port_eng.cache["k"].dtype == torch.int8
    assert set(port_eng.cache) == set(jax_eng.cache) \
        == {"k", "v", "k_scale", "v_scale"}
    n = jax_eng.block_mgr.num_blocks
    for name, tol in (("k", dict(atol=1, rtol=0)), ("v", dict(atol=1, rtol=0)),
                      ("k_scale", dict(atol=0, rtol=1e-5)),
                      ("v_scale", dict(atol=0, rtol=1e-5))):
        np.testing.assert_allclose(
            port_eng.cache[name][:, :n].numpy().astype(np.float64),
            np.asarray(jax_eng.cache[name]).astype(np.float64), **tol)


def _shared_trace(eng, Req, prompts, n):
    """Leader first (its chunks publish the shared blocks), then followers
    that attach the chain; one sharer is evicted and resumed mid-stream."""
    reqs = [Req(prompt_tokens=list(p), model="m1", slo=1e9, max_new_tokens=n)
            for p in prompts]
    assert eng.admit(reqs[0])
    while eng.prefilling_slots():
        eng.steps()
    for r in reqs[1:]:
        assert eng.admit(r)
    eng.steps()
    eng.steps()
    assert eng.evict_request(reqs[1].req_id) is reqs[1]
    assert reqs[1].snapshot["pinned"]
    eng.steps()
    assert eng.admit(reqs[1])
    _drain(eng, reqs)
    return [r.output_tokens for r in reqs], eng.stats


def test_int8_prefix_sharing_matches_jax_paged_pallas(pairs):
    """int8 pools share scale pages along with the int8 pages."""
    rng = np.random.default_rng(5)
    common = rng.integers(0, 100, size=16).tolist()
    prompts = [common + rng.integers(0, 100, size=t).tolist()
               for t in (5, 9, 3)]
    (want, ws), (got, gs) = [
        _shared_trace(eng, Req, prompts, 8)
        for eng, Req in _engines(pairs(GRANITE, True, seed=3), "paged-cuda",
                                 decode_burst=4)]
    assert got == want
    assert gs.prefix_hits == ws.prefix_hits == 2
    assert gs.prefix_shared_tokens == ws.prefix_shared_tokens == 2 * 16


def _swap_trace(eng, Req, other_model, other_params):
    """A granite request is flushed by the swap; the danube request runs
    past the window; swapping back serves granite again."""
    r1 = Req(prompt_tokens=[1, 2, 3], model="m1", slo=1e9, max_new_tokens=20)
    assert eng.admit(r1)
    eng.step()
    model, params = eng.model, eng.params
    evicted = eng.swap_model(other_model, other_params, "m2")
    assert [e.req_id for e in evicted] == [r1.req_id]
    assert r1.snapshot is None                  # the old model's KV is gone
    r2 = Req(prompt_tokens=list(range(3, 73)), model="m2", slo=1e9,
             max_new_tokens=6)
    assert eng.admit(r2)
    _drain(eng, [r2])
    eng.swap_model(model, params, "m1")
    r3 = Req(prompt_tokens=[4, 5, 6, 7], model="m1", slo=1e9,
             max_new_tokens=5)
    assert eng.admit(r3)
    _drain(eng, [r3])
    return [r2.output_tokens, r3.output_tokens], eng.stats.model_swaps


def test_model_swap_granite_to_danube_matches_jax(pairs):
    (jg, jgp), (tg, tgp) = pairs(GRANITE)
    (jd, jdp), (td, tdp) = pairs(DANUBE, seed=1)
    (want, wn), (got, gn) = [
        _swap_trace(eng, Req, *other)
        for (eng, Req), other in zip(
            _engines(((jg, jgp), (tg, tgp)), "cuda"),
            ((jd, jdp), (td, tdp)))]
    assert got == want and gn == wn == 2
    assert all(len(t) == n for t, n in zip(got, (6, 5)))


def test_layout_rules(pairs):
    (_, _), (tg, tgp) = pairs(GRANITE)
    (_, _), (td, tdp) = pairs(DANUBE, seed=1)
    paged = ContinuousBatchingEngine(tg, tgp, EngineConfig(
        device="cpu", **BASE), model_name="m1")
    r = Request(prompt_tokens=[1, 2, 3, 4, 5], model="m1", slo=1e9,
                max_new_tokens=8)
    assert paged.admit(r)
    paged.step()
    paged.step()
    with pytest.raises(ValueError, match="sliding window"):
        paged.swap_model(td, tdp, "m2")
    assert paged.num_active() == 1 and paged.model_name == "m1"
    with pytest.raises(ValueError, match="sliding window"):
        ContinuousBatchingEngine(td, tdp, EngineConfig(device="cpu", **BASE))
    # a paged snapshot cannot resume on the dense layout mid-decode
    paged.evict_request(r.req_id)
    dense = ContinuousBatchingEngine(tg, tgp, EngineConfig(
        device="cpu", attention_backend="cuda", **BASE), model_name="m1")
    with pytest.raises(ValueError, match="paged KV snapshot on a dense"):
        dense.admit(r)
