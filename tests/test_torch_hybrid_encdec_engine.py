"""The port's engine serving the hybrid (zamba2) and the encoder-decoder
(whisper) on the dense backend (``"cuda"``, ``device="cpu"``) against the
JAX engine on ``"pallas"`` (its decode kernel in interpret mode) under the
same trace and the same weights (carried across by
``models/convert.py``):

  * the single-shot admission with decode bursts 1 and 2, one request
    evicted mid-decode, its slot taken by another request, and resumed in
    another slot: the tokens equal the JAX engine's and the port's own
    uninterrupted run; whisper's frames ride ``admit(..., extras=...)``
    and ``req.extras``;
  * the eviction snapshot holds every leaf of the nested cache for the
    slot: the sites' and the self caches' KV (all ``max_seq_len``
    columns), conv and SSM state whole, and whisper's cross K/V with every
    frame, also at ``max_seq_len`` below the frame count (where a KV slice
    of every leaf would cut the cross K/V to ``max_seq_len`` frames);
  * a granite -> zamba2 -> whisper -> granite swap on the dense layout;
  * the page pool refusing both families, at construction and at a swap,
    before anything is flushed, and refusing whisper's frames.

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
ZAMBA, WHISPER, GRANITE = "zamba2-1.2b", "whisper-medium", "granite-3-2b"
TINY = {ZAMBA: dict(num_layers=4, d_model=64),
        WHISPER: dict(num_layers=2, d_model=128),
        GRANITE: dict(num_layers=1, d_model=64, num_heads=4,
                      num_kv_heads=2)}
# whisper's frames outnumber the engine's max_seq_len
FRAMES = 48
BASE = dict(max_slots=4, max_seq_len=32, prefill_chunk_tokens=16,
            block_size=8, debug_invariants=True)
PROMPT_LENS = (3, 14, 9, 6)


def _cfg(registry, arch):
    cfg = registry[arch].reduced(**TINY[arch])
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, num_frames=FRAMES))
    return cfg


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, seed=0):
        if (arch, seed) not in cache:
            jcfg = _cfg(ARCHITECTURES, arch)
            tcfg = _cfg({arch: get_arch(arch)}, arch)
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


def _frames(cfg, n, seed=4):
    if cfg.encoder is None:
        return [None] * n
    # unit-scale frames: at 0.02 the tiny decoder's tokens barely depend on
    # the encoder's memory, and a cut cross K/V would not show in them
    rng = np.random.default_rng(seed)
    return [{"frame_embeds": rng.standard_normal(
        (cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)}
        for _ in range(n)]


def _drain(eng, reqs, max_rounds=400):
    for _ in range(max_rounds):
        eng.steps()
        if all(r.finished() for r in reqs):
            break
    assert all(r.finished() for r in reqs)
    assert eng.block_mgr.used_blocks == 0


def _trace(eng, Req, prompts, extras, n, evict):
    """Admit the first three prompts (the first through ``admit(...,
    extras=...)``, the rest carrying ``req.extras``) and decode three
    rounds; then, with ``evict``, evict the second request, let the fourth
    take its slot and resume it in the last free one (without, just admit
    the fourth).  The resumed slot never held the request: its snapshot
    must carry every leaf, cross K/V included."""
    reqs = [Req(prompt_tokens=list(p), model="m1", slo=1e9, max_new_tokens=n,
                extras=None if i == 0 else ex)
            for i, (p, ex) in enumerate(zip(prompts, extras))]
    for i, r in enumerate(reqs[:3]):
        assert eng.admit(r, extras=extras[0] if i == 0 else None)
        assert eng.prefill_pos[eng.slots.index(r)] == r.prompt_len
    for _ in range(3):
        eng.steps()
    if evict:
        slot = eng.slots.index(reqs[1])
        assert eng.evict_request(reqs[1].req_id) is reqs[1]
        assert eng.admit(reqs[3]) and eng.slots.index(reqs[3]) == slot
        eng.steps()
        assert eng.admit(reqs[1]) and eng.slots.index(reqs[1]) != slot
    else:
        assert eng.admit(reqs[3])
    _drain(eng, reqs)
    return [r.output_tokens for r in reqs], eng.stats


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, size=n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize("arch", [ZAMBA, WHISPER])
@pytest.mark.parametrize("burst", [1, 2])
def test_single_shot_serving_with_eviction_matches_jax_pallas(pairs, arch,
                                                               burst):
    cfg = pairs(arch)[1][0].cfg
    extras = _frames(cfg, len(PROMPT_LENS))
    runs = [_trace(eng, Req, _prompts(), extras, 10, evict=True)
            for eng, Req in _engines(pairs(arch), decode_burst=burst)]
    (want, ws), (got, gs) = runs
    assert all(len(t) == 10 for t in want)
    assert got == want
    assert (gs.prefills, gs.resumes, gs.evictions, gs.prefill_chunks) \
        == (ws.prefills, ws.resumes, ws.evictions, 0) == (4, 1, 1, 0)
    plain, _ = _trace(_port_engine(*pairs(arch)[1], decode_burst=burst),
                      Request, _prompts(), extras, 10, evict=False)
    assert plain == got


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch,quant", [(ZAMBA, False), (WHISPER, False),
                                        (WHISPER, True)])
def test_snapshot_holds_every_leaf_of_the_slot(pairs, arch, quant):
    """The snapshot of slot b is axis 1 of every leaf: KV leaves with
    their max_seq_len columns, every other leaf whole (whisper's cross
    K/V: all 48 frames at max_seq_len 32); a restore into a slot that was overwritten
    meanwhile brings back exactly those contents."""
    model, params = pairs(arch)[1]
    model = build_model(dataclasses.replace(model.cfg, kv_quant=quant))
    eng = _port_engine(model, params)
    cfg = model.cfg
    ex = _frames(cfg, 1)[0]
    r = Request(prompt_tokens=list(range(5)), model="m1", slo=1e9,
                max_new_tokens=8)
    assert eng.admit(r, extras=ex)
    eng.step()
    slot = eng.slots.index(r)
    S = BASE["max_seq_len"]
    want = {}
    for name, leaf in _leaves(eng.cache):
        kv = name.split("/")[-1] in ("k", "v", "k_scale", "v_scale")
        want[name] = (leaf[:, slot, :, :S] if kv else leaf[:, slot]).clone()
    eng.evict_request(r.req_id)
    snap = dict(_leaves(r.snapshot["cache"]))
    assert set(snap) == set(want)
    for name, t in snap.items():
        assert torch.equal(t, want[name]), name
    if cfg.encoder is not None:
        assert snap["cross_k"].shape[2] == FRAMES > S
        assert snap["self/k"].shape[2] == S
    else:
        assert snap["kv/k"].shape[0] == 2        # two sites
        assert snap["ssm"].dtype == torch.float32
    for _, leaf in _leaves(eng.cache):          # the slot is reused meanwhile
        leaf.fill_(3)
    assert eng.admit(r)
    slot = eng.slots.index(r)
    for name, leaf in _leaves(eng.cache):
        kv = name.split("/")[-1] in ("k", "v", "k_scale", "v_scale")
        got = leaf[:, slot, :, :S] if kv else leaf[:, slot]
        assert torch.equal(got, want[name]), name


def _swap_trace(eng, Req, others):
    """granite serves a request that the swap to zamba2 flushes; zamba2
    and then whisper (with frames) each serve two requests; granite again
    serves one."""
    r1 = Req(prompt_tokens=[1, 2, 3], model="m1", slo=1e9, max_new_tokens=20)
    assert eng.admit(r1)
    eng.step()
    model, params = eng.model, eng.params
    outs, caches = [], []
    for name, ((m, p), ex) in zip(("m2", "m3"), others):
        evicted = eng.swap_model(m, p, name)
        if name == "m2":
            assert [e.req_id for e in evicted] == [r1.req_id]
            assert r1.snapshot is None
        caches.append(sorted(eng.cache))
        rs = [Req(prompt_tokens=list(range(3, 3 + n)), model=name, slo=1e9,
                  max_new_tokens=6, extras=ex) for n in (12, 7)]
        for r in rs:
            assert eng.admit(r)
        _drain(eng, rs)
        outs += [r.output_tokens for r in rs]
    eng.swap_model(model, params, "m1")
    caches.append(sorted(eng.cache))
    r3 = Req(prompt_tokens=[4, 5, 6, 7], model="m1", slo=1e9,
             max_new_tokens=5)
    assert eng.admit(r3)
    _drain(eng, [r3])
    return outs + [r3.output_tokens], caches, eng.stats.model_swaps


def test_model_swap_granite_zamba2_whisper_granite_matches_jax(pairs):
    zamba, whisper = pairs(ZAMBA, seed=1), pairs(WHISPER, seed=2)
    ex = _frames(whisper[1][0].cfg, 1, seed=9)[0]
    runs = []
    for k, (eng, Req) in enumerate(_engines(pairs(GRANITE))):
        runs.append(_swap_trace(eng, Req, [(zamba[k], None),
                                           (whisper[k], ex)]))
    (want, wc, wn), (got, gc, gn) = runs
    assert got == want and gn == wn == 3
    assert [len(t) for t in got] == [6, 6, 6, 6, 5]
    assert gc == wc == [["conv", "kv", "ssm"],
                        ["cross_k", "cross_v", "self"], ["k", "v"]]


@pytest.mark.parametrize("arch", [ZAMBA, WHISPER])
def test_page_pool_refuses_both_families(pairs, arch):
    model, params = pairs(arch)[1]
    with pytest.raises(ValueError, match="pageable KV"):
        ContinuousBatchingEngine(model, params, EngineConfig(
            device="cpu", **BASE))
    tg, tgp = pairs(GRANITE)[1]
    paged = ContinuousBatchingEngine(tg, tgp, EngineConfig(
        device="cpu", **BASE), model_name="m1")
    r = Request(prompt_tokens=[1, 2, 3, 4, 5], model="m1", slo=1e9,
                max_new_tokens=8)
    assert paged.admit(r)
    paged.step()
    with pytest.raises(ValueError, match="pageable KV"):
        paged.swap_model(model, params, "m2")
    assert paged.num_active() == 1 and paged.model_name == "m1"
    # whisper's frames ride the single-shot prefill: refused by the pool
    ex = _frames(pairs(WHISPER)[1][0].cfg, 1)[0]
    w = Request(prompt_tokens=[1, 2], model="m1", slo=1e9, max_new_tokens=2,
                extras=ex)
    assert not paged.can_admit(w)
    with pytest.raises(ValueError, match="extras"):
        paged.admit(Request(prompt_tokens=[1, 2], model="m1", slo=1e9,
                            max_new_tokens=2), extras=ex)


def test_serve_cli_serves_zamba2_on_the_dense_backend():
    """``--backend cuda --arch zamba2-1.2b --device cpu``: every request is
    admitted through the single-shot prefill and served; the page pool
    refuses the hybrid."""
    from repro_torch.launch import serve
    argv = ["--arch", "zamba2-1.2b", "--device", "cpu", "--requests", "6",
            "--rate", "20", "--max-new-tokens", "4", "--slots", "4",
            "--debug-invariants"]
    stats = serve.main(["--backend", "cuda"] + argv)
    assert stats["requests"] == stats["served"] == 6
    assert stats["failed"] == stats["dropped_unserved"] == 0
    assert stats["tokens"] == 6 * 3
    with pytest.raises(ValueError, match="pageable KV"):
        serve.main(argv)


def test_whisper_serves_in_neither_serve_cli():
    """The reference's serve CLI draws no frame embeddings, so whisper's
    calibration prefill fails there (a ``KeyError``); the port's fails too,
    with a ``ValueError`` that names the model (a fact about the
    reference, ROADMAP.md Queue 3)."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    argv = ["--backend", "cuda", "--arch", "whisper-medium", "--requests",
            "2", "--max-new-tokens", "2"]
    with pytest.raises(ValueError, match="whisper-medium-reduced needs "
                                         "frame_embeds"):
        serve.main(argv + ["--device", "cpu"])
    with pytest.raises(KeyError, match="frame_embeds"):
        jax_serve.main(["--backend", "pallas"] + argv[2:])
