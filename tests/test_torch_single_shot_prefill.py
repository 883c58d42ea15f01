"""The single-shot prefill of a dense transformer (``prefill_chunk_tokens
<= 0``) in the port's engine on the dense per-slot backend (``"cuda"``),
on the CPU, against the JAX engine on ``"pallas"`` (the reference's
counterpart of ``"cuda"``, Pallas decode in interpret mode) with the same
weights (``models/convert.py``):

  * token streams and the ``prefills`` / ``prefill_chunks`` /
    ``decode_iterations`` counters, for reduced granite in float and with
    int8 KV and for reduced h2o-danube with a prompt past its 64-token
    rolling window;
  * twins of the reference's chunked-prefill tests that run the
    single-shot path (``tests/test_chunked_prefill.py``): the first token
    agrees across the two paths, a completion inside ``admit`` reaches
    ``step()``'s return value once, a failed prefill leaves the engine
    clean, sliding-window chunked prefill gives the single-shot tokens, a
    mid-prefill snapshot on a non-chunking engine recomputes.  The port's
    engine keeps no ``completed`` list, so the twins read what ``step()``
    returns;
  * the page pool refuses ``prefill_chunk_tokens=0`` with the reference's
    ``ValueError``.

Twins of reference tests name ``attention_backend="cuda"``: the port's
default (``None``) is the page pool, the reference's the dense layout.

Tolerance: exact on tokens and counters.
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


def _pair(arch, quant=False):
    jcfg = dataclasses.replace(ARCHITECTURES[arch].reduced(**TINY),
                               kv_quant=quant)
    tcfg = dataclasses.replace(get_arch(arch).reduced(**TINY), kv_quant=quant)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return (jmodel, jparams), (build_model(tcfg), tparams)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, quant=False):
        if (arch, quant) not in cache:
            cache[(arch, quant)] = _pair(arch, quant)
        return cache[(arch, quant)]
    return get


def _port(pair, **kw):
    tm, tp = pair[1]
    cfg = {"max_slots": 4, "max_seq_len": 64, "attention_backend": "cuda",
           **kw}
    return ContinuousBatchingEngine(tm, tp, EngineConfig(device="cpu", **cfg),
                                    model_name="m1")


def _jax(pair, **kw):
    jm, jp = pair[0]
    cfg = {"max_slots": 4, "max_seq_len": 64, "attention_backend": "pallas",
           **kw}
    return JaxEngine(jm, jp, JaxEngineConfig(**cfg), model_name="m1")


def _req(prompt, n=8, cls=Request):
    return cls(prompt_tokens=list(prompt), model="m1", slo=1e9,
               max_new_tokens=n)


def _run_to_completion(eng, reqs, max_steps=200):
    for _ in range(max_steps):
        eng.step()
        if all(r.finished() for r in reqs):
            return
    raise AssertionError("requests did not finish")


def _single_shot_tokens(pair, prompt, n, **kw):
    """The port's single-shot tokens for one prompt."""
    eng = _port(pair, prefill_chunk_tokens=0, **kw)
    r = _req(prompt, n=n)
    assert eng.admit(r)
    _run_to_completion(eng, [r])
    return r.output_tokens


COUNTERS = ("prefills", "prefill_chunks", "decode_iterations",
            "tokens_generated", "evictions", "resumes")


@pytest.mark.parametrize("arch,quant,lens", [
    (GRANITE, False, (5, 19, 30)), (GRANITE, True, (5, 19, 30)),
    (DANUBE, False, (9, 90))])
def test_single_shot_engine_matches_jax(pairs, arch, quant, lens):
    """Several prompts admitted through the single-shot prefill, one of
    them evicted mid-decode and resumed, decoded to the end: the same
    tokens and counters as the JAX engine."""
    pair = pairs(arch, quant)
    rng = np.random.default_rng(len(lens) + quant)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in lens]
    runs = []
    for eng, cls in ((_jax(pair, prefill_chunk_tokens=0, max_seq_len=128),
                      JaxRequest),
                     (_port(pair, prefill_chunk_tokens=0, max_seq_len=128),
                      Request)):
        reqs = [_req(p, n=6, cls=cls) for p in prompts]
        for r in reqs:
            assert eng.admit(r)
        assert not eng.prefilling_slots()
        eng.step()
        eng.step()
        evicted = eng.evict_slot(0)
        assert eng.admit(evicted)
        _run_to_completion(eng, reqs)
        runs.append(([r.output_tokens for r in reqs],
                     {k: getattr(eng.stats, k) for k in COUNTERS}))
    assert runs[1] == runs[0]
    assert runs[1][1]["prefills"] == len(prompts)
    assert runs[1][1]["prefill_chunks"] == 0


def test_first_token_completion_agrees_across_paths(pairs):
    """max_new_tokens=1 completes with exactly one token on both the
    single-shot path (finish check at admit) and the chunked path (finish
    check on the final chunk), and equals the JAX engine's token."""
    pair = pairs(GRANITE)
    prompt = [5, 9, 2]
    outs = {}
    for chunk in (0, 16):
        eng = _port(pair, prefill_chunk_tokens=chunk)
        r = _req(prompt, n=1)
        assert eng.admit(r)
        for _ in range(5):
            if r.finished():
                break
            eng.step()
        assert r.finished()
        assert eng.block_mgr.used_blocks == 0 and eng.num_active() == 0
        outs[chunk] = list(r.output_tokens)
    assert outs[0] == outs[16]
    assert len(outs[0]) == 1
    jeng = _jax(pair, prefill_chunk_tokens=0)
    jr = _req(prompt, n=1, cls=JaxRequest)
    assert jeng.admit(jr) and jr.finished()
    assert jr.output_tokens == outs[0]


def test_step_returns_admit_completed_requests(pairs):
    """A request that finishes inside admit() (single-shot, max_new=1),
    pulled by step(), is in step()'s return value."""
    eng = _port(pairs(GRANITE), prefill_chunk_tokens=0)
    r = _req([5, 9, 2], n=1)
    queue = [r]
    eng.pull_source = lambda: queue.pop(0) if queue else None
    done = eng.step()
    assert r.finished()
    assert done == [r]


def test_direct_admit_completion_visible_without_step(pairs):
    """A direct admit() that completes at once leaves no slot busy, and the
    next step() returns it exactly once."""
    eng = _port(pairs(GRANITE), prefill_chunk_tokens=0)
    r = _req([5, 9, 2], n=1)
    assert eng.admit(r)
    assert r.finished() and eng.num_active() == 0
    assert eng.step() == [r]
    assert eng.step() == []


def test_failed_prefill_leaves_engine_clean(pairs):
    """An exception inside the single-shot prefill leaves no slot and no
    block behind, and the engine still serves."""
    eng = _port(pairs(GRANITE), prefill_chunk_tokens=0)

    def boom(prompt, extras):
        raise RuntimeError("device OOM")

    eng._prefill_one = boom
    r = _req([1, 2, 3], n=4)
    with pytest.raises(RuntimeError):
        eng.admit(r)
    assert eng.num_active() == 0
    assert eng.block_mgr.used_blocks == 0
    assert not eng.block_mgr.has(r.req_id)
    eng.step()
    del eng._prefill_one
    assert eng.admit(r)
    _run_to_completion(eng, [r])


def test_sliding_window_chunked_matches_single_shot(pairs):
    """Rolling window: chunked prefill (past the window too) gives the
    single-shot tokens, which are the JAX engine's."""
    pair = pairs(DANUBE)
    rng = np.random.default_rng(2)
    for plen in (20, 80):             # 80 > window (64): rolling wrap
        prompt = rng.integers(0, 100, size=plen).tolist()
        want = _single_shot_tokens(pair, prompt, n=4, max_seq_len=128)
        eng = _port(pair, prefill_chunk_tokens=16, max_seq_len=128)
        r = _req(prompt, n=4)
        assert eng.admit(r)
        _run_to_completion(eng, [r])
        assert r.output_tokens == want, plen
        jeng = _jax(pair, prefill_chunk_tokens=0, max_seq_len=128)
        jr = _req(prompt, n=4, cls=JaxRequest)
        assert jeng.admit(jr)
        _run_to_completion(jeng, [jr])
        assert jr.output_tokens == want, plen


def test_mid_prefill_snapshot_on_nonchunking_engine_recomputes(pairs):
    """A mid-prefill snapshot admitted to an engine that cannot chunk
    (prefill_chunk_tokens=0) recomputes the whole prefill instead of
    resuming at a chunk."""
    pair = pairs(GRANITE)
    prompt = np.random.default_rng(8).integers(0, 100, size=24).tolist()
    want = _single_shot_tokens(pair, prompt, n=6)

    eng = _port(pair, prefill_chunk_tokens=8)
    r = _req(prompt, n=6)
    assert eng.admit(r)
    eng.step()
    eng.evict_request(r.req_id)
    assert r.snapshot["prefill_pos"] == 8

    other = _port(pair, prefill_chunk_tokens=0)
    assert other.admit(r)
    assert other.stats.resumes == 0 and other.stats.prefills == 1
    _run_to_completion(other, [r])
    assert r.output_tokens == want


@pytest.mark.parametrize("backend", [None, "paged-cuda"])
def test_page_pool_refuses_single_shot_prefill(pairs, backend):
    tm, tp = pairs(GRANITE)[1]
    with pytest.raises(ValueError, match="require chunked prefill"):
        ContinuousBatchingEngine(tm, tp, EngineConfig(
            device="cpu", attention_backend=backend, prefill_chunk_tokens=0))
