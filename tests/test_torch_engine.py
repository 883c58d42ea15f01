"""The port's engine (``repro_torch.serving.engine``, CPU) against the JAX
engine on ``paged-xla`` under the same trace and the same weights (carried
across by ``models/convert.py``): greedy token streams must be identical
through mid-stream evict/resume, prefix sharing (the followers' prefill
starts past the shared blocks, one sharer is evicted and resumed), OOM
preemption, and decode bursts of 1 and 4 — with the invariant checker on
every round (``debug_invariants=True``).  The copy-on-write page copy is
checked against the JAX engine's on the same pool.

Tolerance: exact on tokens; float32 atol = rtol = 1e-4 on page contents.
"""
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
BASE = dict(max_slots=4, max_seq_len=64, prefill_chunk_tokens=16,
            block_size=8, debug_invariants=True)


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2)
    jmodel = jax_build_model(ARCHITECTURES["granite-3-2b"].reduced(**kw))
    jparams = jmodel.init(jax.random.key(1))
    tcfg = get_arch("granite-3-2b").reduced(**kw)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return (jmodel, jparams), (build_model(tcfg), tparams)


def _engines(models, **kw):
    (jm, jp), (tm, tp) = models
    cfg = {**BASE, **kw}
    jax_eng = JaxEngine(jm, jp, JaxEngineConfig(attention_backend="paged-xla",
                                                **cfg), model_name="m1")
    port_eng = ContinuousBatchingEngine(tm, tp, EngineConfig(device="cpu",
                                                             **cfg),
                                        model_name="m1")
    return [(jax_eng, JaxRequest), (port_eng, Request)]


def _drain(eng, reqs, max_rounds=300):
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
    eng.steps()
    eng.steps()
    assert eng.evict_request(reqs[1].req_id) is reqs[1]
    eng.steps()
    assert eng.admit(reqs[1])
    _drain(eng, reqs)
    return [r.output_tokens for r in reqs], eng.stats


@pytest.mark.parametrize("burst", [1, 4])
def test_token_streams_match_jax_with_evict_resume(models, burst):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in (3, 17, 30, 9)]
    (want, ws), (got, gs) = [
        _evict_resume_trace(eng, Req, prompts, 6)
        for eng, Req in _engines(models, decode_burst=burst)]
    assert all(len(t) == 6 for t in want)
    assert got == want
    assert (gs.resumes, gs.evictions, gs.decode_iterations) \
        == (ws.resumes, ws.evictions, ws.decode_iterations)


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
    assert reqs[1].snapshot["pinned"]          # the shared chain is pinned
    eng.steps()
    assert eng.admit(reqs[1])
    _drain(eng, reqs)
    return [r.output_tokens for r in reqs], eng.stats


@pytest.mark.parametrize("burst", [1, 4])
def test_token_streams_match_jax_with_prefix_sharing(models, burst):
    rng = np.random.default_rng(5)
    common = rng.integers(0, 100, size=16).tolist()
    prompts = [common + rng.integers(0, 100, size=t).tolist()
               for t in (5, 9, 3, 12)]
    (want, ws), (got, gs) = [
        _shared_trace(eng, Req, prompts, 10)
        for eng, Req in _engines(models, decode_burst=burst)]
    assert got == want
    assert gs.prefix_hits == ws.prefix_hits == 3
    assert gs.prefix_shared_tokens == ws.prefix_shared_tokens == 3 * 16


def test_token_streams_match_jax_under_oom_preemption(models):
    """A pool too small for every sequence: decode-time append failures
    preempt (evict) and the victims resume later."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in (20, 14, 9)]
    outs = []
    for eng, Req in _engines(models, kv_blocks=9, prefix_sharing=False):
        reqs = [Req(prompt_tokens=p, model="m1", slo=1e9, max_new_tokens=16)
                for p in prompts]
        waiting = list(reqs)
        for _ in range(400):
            while waiting and eng.admit(waiting[0]):
                waiting.pop(0)
            eng.steps()
            for r in reqs:
                if r.snapshot is not None and r not in waiting \
                        and r not in eng.slots:
                    waiting.append(r)
            if all(r.finished() for r in reqs):
                break
        assert all(r.finished() for r in reqs)
        outs.append(([r.output_tokens for r in reqs], eng.stats.preemptions))
    (want, wp), (got, gp) = outs
    assert wp > 0 and gp == wp
    assert got == want


def test_copy_on_write_page_copy_matches_jax(models):
    """A forked sequence's shared partial tail block is copied before any
    dispatch: the port's COW copy lands the same page contents as the JAX
    engine's."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 100, size=21).tolist()   # tail block 2 partial
    pools = []
    for eng, Req in _engines(models):
        r = Req(prompt_tokens=prompt, model="m1", slo=1e9, max_new_tokens=4)
        assert eng.admit(r)
        while eng.prefilling_slots():
            eng.steps()
        table = eng.block_mgr.block_table(r.req_id)
        eng.block_mgr.fork(r.req_id, 10_000)
        clone = eng.block_mgr.block_table(10_000)
        assert clone[:-1] == table[:-1] and clone[-1] != table[-1]
        eng._apply_cow()
        assert eng.stats.cow_copies == 1
        k = np.asarray(eng.cache["k"])
        np.testing.assert_array_equal(k[:, clone[-1]], k[:, table[-1]])
        pools.append((k[:, :eng.block_mgr.num_blocks], clone[-1]))
        eng.block_mgr.free(10_000)
    (jk, jdst), (tk, tdst) = pools
    assert jdst == tdst
    np.testing.assert_allclose(tk, jk, atol=1e-4, rtol=1e-4)


def test_unported_paths_raise(models):
    """The reference's "paged-xla" backend stays refused; the page pool
    refuses the single-shot prefill and a fork of a mid-prefill slot with
    the reference's ValueError (the single-shot prefill and fork_slot are
    held against the JAX engine in test_torch_single_shot_prefill.py and
    test_torch_fork_slot.py)."""
    _, (tm, tp) = models
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(tm, tp, EngineConfig(
            device="cpu", attention_backend="paged-xla"))
    with pytest.raises(ValueError, match="require chunked prefill"):
        ContinuousBatchingEngine(tm, tp, EngineConfig(
            device="cpu", prefill_chunk_tokens=0))
    eng = ContinuousBatchingEngine(tm, tp, EngineConfig(
        device="cpu", attention_backend="paged-cuda", **BASE))
    r = Request(prompt_tokens=[1, 2, 3], model="m1", slo=1e9,
                max_new_tokens=2)
    assert eng.admit(r)
    with pytest.raises(ValueError, match="mid-prefill"):
        eng.fork_slot(0)


def _swap_cycle_trace(eng, Req, prompts, other_params):
    """A sharer evicted mid-decode stays resumable across a model-swap
    cycle (the swap materializes its pinned pages into the snapshot), a
    resident request is cancelled, and a crash salvage abandons the rest."""
    ra, rb = [Req(prompt_tokens=list(p), model="m1", slo=1e9,
                  max_new_tokens=8) for p in prompts[:2]]
    assert eng.admit(ra)
    while eng.prefilling_slots():
        eng.steps()
    assert eng.admit(rb)
    eng.steps()
    eng.steps()
    assert eng.evict_request(rb.req_id) is rb and rb.snapshot["pinned"]
    while not ra.finished():          # rb's pins keep the shared chain
        eng.steps()
    model, params = eng.model, eng.params
    eng.swap_model(model, other_params, "m2")
    assert rb.snapshot["pinned"] == []
    n_pages = rb.snapshot["cache"]["k"].shape[1]
    eng.swap_model(model, params, "m1")
    assert eng.admit(rb)
    rc = Req(prompt_tokens=list(prompts[2]), model="m1", slo=1e9,
             max_new_tokens=8)
    assert eng.admit(rc)
    eng.steps()
    assert eng.cancel_request(rc) and rc.cancelled
    _drain(eng, [rb])
    rd = Req(prompt_tokens=list(prompts[3]), model="m1", slo=1e9,
             max_new_tokens=8)
    assert eng.admit(rd)
    eng.steps()
    assert eng.abandon() == [rd] and eng.block_mgr.used_blocks == 0
    return [ra.output_tokens, rb.output_tokens], n_pages, eng.stats


def test_swap_cancel_and_abandon_match_jax(models):
    (jm, jp), (tm, tp) = models
    rng = np.random.default_rng(11)
    common = rng.integers(0, 100, size=16).tolist()
    prompts = [common + rng.integers(0, 100, size=t).tolist()
               for t in (5, 9, 3, 12)]
    other_j = jm.init(jax.random.key(2))
    other_t = from_jax_params(jax.tree.map(np.asarray, other_j), tm.cfg,
                              device="cpu")
    (want, wn, ws), (got, gn, gs) = [
        _swap_cycle_trace(eng, Req, prompts, other)
        for (eng, Req), other in zip(_engines(models), (other_j, other_t))]
    assert got == want and gn == wn
    assert (gs.model_swaps, gs.cancellations, gs.resumes) \
        == (ws.model_swaps, ws.cancellations, ws.resumes) == (2, 1, 1)
