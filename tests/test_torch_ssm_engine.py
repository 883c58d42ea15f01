"""The port's engine serving mamba2 (backend ``"cuda"``, ``device="cpu"``)
against the JAX engine on ``"pallas"`` under the same trace and the same
weights (carried across by ``models/convert.py``):

  * the single-shot admission (batch 1 at the exact prompt length, into a
    fresh state, then written into the slot) with decode bursts 1 and 2,
    and an SSM slot evicted mid-decode whose snapshot (conv history and
    SSM state, whole) resumes with the tokens of the uninterrupted run;
  * a request finished by its prefill token, returned by the next step;
  * a granite -> mamba2 -> granite model swap on the dense layout;
  * the layout rules: the page pool refuses the SSM (construction and
    swap, before anything is flushed) and the single-shot prefill; a
    dense transformer without chunked prefill serves on the dense layout
    (also after a swap from mamba2); modality extras ride the SSM's
    single-shot prefill, which ignores them, as the reference's does.

Tolerance: exact on tokens.
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
MAMBA, GRANITE = "mamba2-130m", "granite-3-2b"
TINY = {MAMBA: dict(num_layers=2, d_model=64),
        GRANITE: dict(num_layers=1, d_model=64, num_heads=4,
                      num_kv_heads=2)}
BASE = dict(max_slots=3, max_seq_len=96, prefill_chunk_tokens=16,
            block_size=8, debug_invariants=True)
PROMPT_LENS = (3, 21, 40)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, seed=0):
        if (arch, seed) not in cache:
            jcfg = ARCHITECTURES[arch].reduced(**TINY[arch])
            tcfg = get_arch(arch).reduced(**TINY[arch])
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            jmodel = jax_build_model(jcfg)
            jparams = jmodel.init(jax.random.key(seed))
            cache[arch, seed] = (
                (jmodel, jparams),
                (build_model(tcfg), from_jax_params(
                    jax.tree.map(np.asarray, jparams), tcfg, device="cpu")))
        return cache[arch, seed]
    return get


def _port_engine(model, params, **kw):
    return ContinuousBatchingEngine(model, params, EngineConfig(
        device="cpu", attention_backend="cuda", **{**BASE, **kw}),
        model_name="m1")


def _engines(pair, **kw):
    """The JAX engine on "pallas" and the port's on "cuda", same config."""
    (jm, jp), port = pair
    return [(JaxEngine(jm, jp, JaxEngineConfig(attention_backend="pallas",
                                               **{**BASE, **kw}),
                       model_name="m1"), JaxRequest),
            (_port_engine(*port, **kw), Request)]


def _drain(eng, reqs, max_rounds=400):
    for _ in range(max_rounds):
        eng.steps()
        if all(r.finished() for r in reqs):
            break
    assert all(r.finished() for r in reqs)
    assert eng.block_mgr.used_blocks == 0


def _trace(eng, Req, prompts, n, evict):
    reqs = [Req(prompt_tokens=list(p), model="m1", slo=1e9, max_new_tokens=n)
            for p in prompts]
    for r in reqs:
        assert eng.admit(r)
        assert eng.prefill_pos[eng.slots.index(r)] == r.prompt_len
    for _ in range(3):
        eng.steps()
    if evict:
        assert eng.evict_request(reqs[1].req_id) is reqs[1]
        eng.steps()
        assert eng.admit(reqs[1])
    _drain(eng, reqs)
    return [r.output_tokens for r in reqs], eng.stats


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, size=n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize("burst", [1, 2])
def test_single_shot_prefill_and_decode_match_jax_pallas(pairs, burst):
    """With an SSM slot evicted mid-decode and resumed; the port's tokens
    equal the JAX engine's and the port's own uninterrupted run."""
    runs = [_trace(eng, Req, _prompts(), 10, evict=True)
            for eng, Req in _engines(pairs(MAMBA), decode_burst=burst)]
    (want, ws), (got, gs) = runs
    assert all(len(t) == 10 for t in want)
    assert got == want
    assert (gs.prefills, gs.resumes, gs.evictions, gs.prefill_chunks) \
        == (ws.prefills, ws.resumes, ws.evictions, 0) == (3, 1, 1, 0)
    plain, _ = _trace(_port_engine(*pairs(MAMBA)[1], decode_burst=burst),
                      Request, _prompts(), 10, evict=False)
    assert plain == got


def test_state_snapshot_travels_whole(pairs):
    eng = _port_engine(*pairs(MAMBA)[1])
    cfg = eng.model.cfg
    r = Request(prompt_tokens=list(range(5)), model="m1", slo=1e9,
                max_new_tokens=6)
    assert eng.admit(r)
    eng.step()
    slot = eng.slots.index(r)
    state = {k: v[:, slot].clone() for k, v in eng.cache.items()}
    eng.evict_request(r.req_id)
    snap = r.snapshot
    assert snap["layout"] == "dense" and set(snap["cache"]) == {"conv", "ssm"}
    nh = cfg.ssm.num_heads(cfg.d_model)
    assert tuple(snap["cache"]["ssm"].shape) == (
        cfg.num_layers, nh, cfg.ssm.d_state, cfg.ssm.head_dim)
    assert snap["cache"]["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        assert torch.equal(snap["cache"][k], state[k])
    eng.cache["ssm"].fill_(7.0)           # the slot is reused meanwhile
    assert eng.admit(r)
    assert torch.equal(eng.cache["ssm"][:, eng.slots.index(r)], state["ssm"])


def test_request_finished_by_its_prefill_token(pairs):
    """max_new_tokens == 1: the single-shot admission emits the only
    token, frees the slot and the next step returns the request."""
    outs = []
    for eng, Req in _engines(pairs(MAMBA)):
        r = Req(prompt_tokens=[5, 6, 7, 8], model="m1", slo=1e9,
                max_new_tokens=1)
        assert eng.admit(r)
        assert r.finished() and eng.num_active() == 0
        assert eng.block_mgr.used_blocks == 0
        assert eng.step() == [r] and eng.step() == []
        outs.append(r.output_tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 1


def _swap_trace(eng, Req, ssm_model, ssm_params):
    """A granite request is flushed by the swap to mamba2; mamba2 serves
    two requests; swapping back serves granite again."""
    r1 = Req(prompt_tokens=[1, 2, 3], model="m1", slo=1e9, max_new_tokens=20)
    assert eng.admit(r1)
    eng.step()
    model, params = eng.model, eng.params
    evicted = eng.swap_model(ssm_model, ssm_params, "m2")
    assert [e.req_id for e in evicted] == [r1.req_id]
    assert r1.snapshot is None
    assert set(eng.cache) == {"conv", "ssm"}
    rs = [Req(prompt_tokens=list(range(3, 3 + n)), model="m2", slo=1e9,
              max_new_tokens=6) for n in (30, 7)]
    for r in rs:
        assert eng.admit(r)
    _drain(eng, rs)
    eng.swap_model(model, params, "m1")
    assert set(eng.cache) == {"k", "v"}
    r3 = Req(prompt_tokens=[4, 5, 6, 7], model="m1", slo=1e9,
             max_new_tokens=5)
    assert eng.admit(r3)
    _drain(eng, [r3])
    return [r.output_tokens for r in rs + [r3]], eng.stats.model_swaps


def test_model_swap_granite_to_mamba2_matches_jax(pairs):
    granite, mamba = pairs(GRANITE), pairs(MAMBA, seed=1)
    (want, wn), (got, gn) = [
        _swap_trace(eng, Req, *other)
        for (eng, Req), other in zip(_engines(granite), mamba)]
    assert got == want and gn == wn == 2
    assert [len(t) for t in got] == [6, 6, 5]


def test_layout_rules(pairs):
    _, (tg, tgp) = pairs(GRANITE)
    _, (tm, tmp) = pairs(MAMBA)
    with pytest.raises(ValueError, match="pageable KV"):
        ContinuousBatchingEngine(tm, tmp, EngineConfig(device="cpu", **BASE))
    paged = ContinuousBatchingEngine(tg, tgp, EngineConfig(
        device="cpu", **BASE), model_name="m1")
    r = Request(prompt_tokens=[1, 2, 3, 4, 5], model="m1", slo=1e9,
                max_new_tokens=8)
    assert paged.admit(r)
    paged.step()
    with pytest.raises(ValueError, match="pageable KV"):
        paged.swap_model(tm, tmp, "m2")
    assert paged.num_active() == 1 and paged.model_name == "m1"
    # the page pool refuses the single-shot prefill ...
    no_chunks = {**BASE, "prefill_chunk_tokens": 0}
    with pytest.raises(ValueError, match="require chunked prefill"):
        ContinuousBatchingEngine(tg, tgp, EngineConfig(
            device="cpu", **no_chunks))
    # ... the SSM's always runs, chunking configured or not
    eng = ContinuousBatchingEngine(tm, tmp, EngineConfig(
        device="cpu", attention_backend="cuda", **no_chunks), model_name="m2")
    s = Request(prompt_tokens=[1, 2, 3], model="m2", slo=1e9,
                max_new_tokens=3)
    assert eng.num_active() == 0
    assert eng.admit(s, extras={"patch_embeds": np.zeros((1, 4))})
    _drain(eng, [s])
    # ... and so does a dense transformer's on the dense layout (its tokens
    # are held against the JAX engine in test_torch_single_shot_prefill.py)
    eng.swap_model(tg, tgp, "m1")
    g = Request(prompt_tokens=[1, 2, 3], model="m1", slo=1e9,
                max_new_tokens=3)
    assert eng.admit(g) and eng.stats.prefills == 2
    _drain(eng, [g])
