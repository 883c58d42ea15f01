"""The port's engine serving the MoE and VLM families on the CPU against
the JAX engine, on the same weights (``jax.random.key``, carried across by
``models/convert.py``):

  * reduced qwen3-moe-30b-a3b on the page pool (``"paged-cuda"`` against
    the reference's ``"paged-pallas"``, in interpret mode) with prefix
    sharing and decode bursts of 4, and reduced dbrx-132b chunked on both
    layouts; the burst makes no host sync;
  * reduced llava-next-34b with ``patch_embeds`` extras on the dense
    backend (``"cuda"`` against ``"xla"``), through the single-shot
    prefill; the page pool refuses them as the reference's does;
  * a fact about the reference: after a VLM's single-shot prefill its
    engine sets the slot's length to the text's, so decode does not
    continue from the end of the patch prefix, and its second token is
    not the teacher-forced one.  The port keeps those lengths;
  * the serve CLI with the MoE archs, a swap to one, and ``--hetero``.

Tolerance: exact on tokens and lengths.
"""
import jax
import jax.numpy as jnp
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
QWEN3, DBRX, LLAVA = "qwen3-moe-30b-a3b", "dbrx-132b", "llava-next-34b"
REDUCED = {QWEN3: dict(num_layers=2, d_model=128, num_heads=8, num_kv_heads=1),
           DBRX: dict(num_layers=2, d_model=96, num_heads=6, num_kv_heads=1),
           LLAVA: dict(num_layers=2, d_model=112, num_heads=7,
                       num_kv_heads=1)}
BASE = dict(max_slots=4, max_seq_len=64, prefill_chunk_tokens=16,
            block_size=8)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            jmodel = jax_build_model(ARCHITECTURES[arch].reduced(
                **REDUCED[arch]))
            jparams = jmodel.init(jax.random.key(2))
            tcfg = get_arch(arch).reduced(**REDUCED[arch])
            cache[arch] = ((jmodel, jparams), (build_model(tcfg),
                           from_jax_params(jax.tree.map(np.asarray, jparams),
                                           tcfg, device="cpu")))
        return cache[arch]
    return get


def _engines(pair, jax_backend, port_backend, **kw):
    (jm, jp), (tm, tp) = pair
    cfg = {**BASE, **kw}
    return [(JaxEngine(jm, jp, JaxEngineConfig(attention_backend=jax_backend,
                                               **cfg), model_name="m1"),
             JaxRequest),
            (ContinuousBatchingEngine(tm, tp, EngineConfig(
                device="cpu", attention_backend=port_backend,
                debug_invariants=True, **cfg), model_name="m1"), Request)]


def _serve(eng, Req, prompts, n, extras=None, admit_every=1):
    """Admit the prompts (``admit_every`` per round, so later ones find
    earlier ones' pages indexed), run ``steps()`` until every request
    finishes; returns the token streams."""
    reqs = [Req(prompt_tokens=list(p), model="m1", slo=1e9, max_new_tokens=n)
            for p in prompts]
    pending = list(enumerate(reqs))
    for _ in range(400):
        for _ in range(admit_every):
            if pending:
                i, r = pending[0]
                ex = None if extras is None else extras[i]
                if not eng.admit(r, extras=ex):
                    break
                pending.pop(0)
        eng.steps()
        if not pending and all(r.finished() for r in reqs):
            break
    assert all(r.finished() for r in reqs)
    assert eng.block_mgr.used_blocks == 0 or eng.prefix_sharing
    return [r.output_tokens for r in reqs]


def _prompts(seed, n, lo=4, hi=40, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + rng.integers(0, 500, size=int(rng.integers(lo, hi))
                                        ).tolist() for _ in range(n)]


def test_qwen3_moe_paged_with_sharing_and_bursts_matches_jax(pairs):
    """Six prompts, four sharing a 24-token prefix (three pages), admitted
    one a round: token streams equal the JAX engine's, and the port
    shares as many blocks as it does."""
    prefix = list(range(100, 124))
    prompts = _prompts(1, 4, prefix=prefix) + _prompts(2, 2)
    runs = []
    for eng, Req in _engines(pairs(QWEN3), "paged-pallas", "paged-cuda",
                             prefix_sharing=True, decode_burst=4):
        runs.append((_serve(eng, Req, prompts, 7),
                     eng.stats.prefix_shared_blocks))
    (want, wshared), (got, gshared) = runs
    assert got == want and gshared == wshared > 0


def test_dbrx_chunked_on_both_layouts_matches_jax(pairs):
    """Five prompts over four slots, chunked on both layouts, against the
    JAX engine on the kernel backends the port twins.  A chunk round's
    inactive rows route through the experts too and count toward the
    capacity: the kernels give such a row zeros, while the reference's
    ``"paged-xla"`` fallback averages every key of the row's stale pages,
    so on these prompts its tokens part from its own kernel path's (a
    fact about the reference, ROADMAP.md Queue 3)."""
    prompts = _prompts(3, 5)
    for jb, tb in (("paged-pallas", "paged-cuda"), ("pallas", "cuda")):
        want, got = [_serve(eng, Req, prompts, 6, admit_every=5)
                     for eng, Req in _engines(pairs(DBRX), jb, tb)]
        assert got == want
        if jb == "paged-pallas":
            fallback = _serve(*_engines(pairs(DBRX), "paged-xla", tb)[0],
                              prompts, 6, admit_every=5)
            assert fallback != want


def test_moe_decode_burst_never_syncs(pairs, monkeypatch):
    """No ``.item()``, ``.cpu()``, ``.tolist()``, ``nonzero`` or
    ``bool(tensor)`` inside the MoE decode burst."""
    _, (tm, tp) = pairs(QWEN3)
    eng = ContinuousBatchingEngine(tm, tp, EngineConfig(
        device="cpu", decode_burst=4, **BASE))
    burst = eng._decode_burst
    calls = []

    def host_sync(*_, **__):
        raise AssertionError("host sync inside the decode burst")

    def guarded(*args):
        with monkeypatch.context() as m:
            for name in ("item", "cpu", "tolist", "nonzero", "__bool__"):
                m.setattr(torch.Tensor, name, host_sync)
            out = burst(*args)
        calls.append(args[0])
        return out

    eng._decode_burst = guarded
    _serve(eng, Request, _prompts(4, 4), 9, admit_every=4)
    assert calls and max(calls) == 4


def _patches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [{"patch_embeds": (0.02 * rng.standard_normal(
        (cfg.vision.num_patch_tokens, cfg.d_model))).astype(np.float32)}
        for _ in range(n)]


def test_llava_extras_on_the_dense_backend_match_jax(pairs):
    """Four requests with their own patch embeddings, admitted one a round
    on the dense backend: the single-shot prefill takes the extras, and
    the tokens and slot lengths equal the JAX engine's."""
    (jm, _), _ = pairs(LLAVA)
    prompts = _prompts(5, 4, hi=20)
    extras = _patches(jm.cfg, 4, 6)
    runs = []
    for eng, Req in _engines(pairs(LLAVA), "xla", "cuda", decode_burst=2):
        runs.append(_serve(eng, Req, prompts, 5, extras=extras))
        assert eng.stats.prefills == 4 and eng.stats.prefill_chunks == 0
    want, got = runs
    assert got == want


def test_llava_slot_length_is_the_text_length_like_the_reference(pairs):
    """After the single-shot prefill both engines set the slot's length to
    ``prompt_len``, not ``prompt_len + num_patch_tokens``."""
    prompt = [5, 6, 7, 8, 9]
    (jm, _), _ = pairs(LLAVA)
    ex = _patches(jm.cfg, 1, 7)[0]
    for eng, Req in _engines(pairs(LLAVA), "xla", "cuda"):
        r = Req(prompt_tokens=prompt, model="m1", slo=1e9, max_new_tokens=4)
        assert eng.admit(r, extras=ex)
        slot = eng.slots.index(r)
        assert int(eng.lengths[slot]) == len(prompt)
        assert len(r.output_tokens) == 1


def test_reference_vlm_decode_starts_at_the_text_length():
    """The JAX package alone: its engine's second token for a VLM request
    is not the one its model gives by prefilling the prompt plus the
    first token (teacher forcing), for most prompts, because decode
    resumes at ``prompt_len`` inside the patch prefix.  The first token
    (the prefill's) agrees.  This is why the port keeps the reference's
    lengths: only so do both engines give the same tokens."""
    cfg = ARCHITECTURES[LLAVA].reduced(num_layers=2, d_model=64)
    model = jax_build_model(cfg)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    differ = 0
    for _ in range(4):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(4, 12))).tolist()
        pe = (0.02 * rng.standard_normal(
            (cfg.vision.num_patch_tokens, cfg.d_model))).astype(np.float32)
        eng = JaxEngine(model, params, JaxEngineConfig(max_slots=2,
                                                       max_seq_len=64))
        r = JaxRequest(prompt_tokens=prompt, model="m", slo=1e9,
                       max_new_tokens=2)
        assert eng.admit(r, extras={"patch_embeds": pe})
        assert int(eng.lengths[eng.slots.index(r)]) == len(prompt)
        while eng.num_active():
            eng.step()

        def teacher(seq):
            logits, _ = model.prefill(
                params, {"tokens": jnp.asarray(seq, jnp.int32)[None],
                         "patch_embeds": jnp.asarray(pe)[None]},
                model.init_cache(1, 64))
            return int(jnp.argmax(logits[0]))

        assert r.output_tokens[0] == teacher(prompt)
        differ += r.output_tokens[1] != teacher(prompt + r.output_tokens[:1])
    assert differ >= 3


def test_paged_refuses_extras_requests_gracefully(pairs):
    """Twin of the reference's test of that name: ``can_admit`` refuses a
    request with extras, so a pull loop hands it back, and an explicit
    ``admit(..., extras=...)`` raises the reference's ValueError."""
    _, (tm, tp) = pairs(LLAVA)
    eng = ContinuousBatchingEngine(tm, tp, EngineConfig(device="cpu",
                                                        **BASE))
    r = Request(prompt_tokens=[1, 2, 3], model="m1", slo=1e9,
                max_new_tokens=4)
    r.extras = {"patch_embeds": np.zeros((2, 4), np.float32)}
    assert not eng.can_admit(r)
    assert not eng.admit(r)
    queue = [r]
    eng.pull_source = lambda: queue.pop(0) if queue else None
    eng.step()                                   # must not raise
    assert eng.take_pushback() is r
    with pytest.raises(ValueError, match="need a dense backend"):
        eng.admit(Request(prompt_tokens=[1, 2], model="m1", slo=1e9,
                          max_new_tokens=2),
                  extras={"patch_embeds": np.zeros((2, 4))})
    assert eng.num_active() == 0


@pytest.mark.parametrize("flags", [
    ["--arch", QWEN3], ["--arch", DBRX], ["--arch2", QWEN3],
    ["--arch", QWEN3, "--hetero", "--instances", "3"]])
def test_serve_cli_serves_the_moe_archs(flags):
    """``--arch`` / ``--arch2`` resolve the MoE configs through the
    registry (reduced, as the reference CLI does), and ``--hetero``
    composes with them."""
    from repro_torch.launch import serve
    stats = serve.main(["--device", "cpu", "--requests", "6", "--rate", "20",
                        "--max-new-tokens", "4", "--slots", "4"] + flags)
    assert stats["served"] == stats["requests"] == 6
    assert stats["failed"] == stats["dropped_unserved"] == 0
