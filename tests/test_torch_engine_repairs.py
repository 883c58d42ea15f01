"""Engine surface the port had dropped from the reference, held against
the JAX engine (``paged-xla``) on the same weights: custom prefill
buckets, ``running_requests()``, the decode burst's single host sync, and
the reference's ``pages_per_tile`` / ``donate_buffers`` knobs.

Tolerance: exact on tokens and on the engine's counters.
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
# four prompts whose greedy streams under these weights first emit token
# 450 as their 4th to 6th token: with it as EOS every slot retires inside
# the first decode burst, which then runs idle iterations
EOS = 450
EOS_PROMPTS = ([26, 20, 68, 88, 14, 54, 56, 61, 24, 28, 38],
               [55, 85, 73, 21, 19, 22, 26, 79, 32, 25, 51, 78, 45, 0, 49],
               [65, 79, 76, 1, 49],
               [77, 14, 40, 61, 79, 45])


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
    return [(JaxEngine(jm, jp, JaxEngineConfig(attention_backend="paged-xla",
                                               **cfg), model_name="m1"),
             JaxRequest),
            (ContinuousBatchingEngine(tm, tp, EngineConfig(device="cpu",
                                                           **cfg),
                                      model_name="m1"), Request)]


def _serve(eng, Req, prompts, n):
    reqs = [Req(prompt_tokens=list(p), model="m1", slo=1e9, max_new_tokens=n)
            for p in prompts]
    for r in reqs:
        assert eng.admit(r)
    for _ in range(300):
        eng.steps()
        if all(r.finished() for r in reqs):
            break
    assert all(r.finished() for r in reqs)
    assert eng.block_mgr.used_blocks == 0
    return [r.output_tokens for r in reqs], eng.stats


def _counters(st):
    return (st.decode_iterations, st.tokens_generated, st.prefill_chunks,
            st.prefills)


def test_bucket_resolution():
    assert EngineConfig(prefill_chunk_tokens=128).resolved_buckets() == \
        (16, 32, 64, 128)
    assert EngineConfig(prefill_chunk_tokens=0).resolved_buckets() == ()
    assert EngineConfig(prefill_chunk_tokens=100).resolved_buckets() == \
        (16, 32, 64, 100)
    # custom buckets are completed up to the chunk size so padding never
    # falls back to exact (unbounded) lengths
    assert EngineConfig(prefill_buckets=(64, 8),
                        prefill_chunk_tokens=128).resolved_buckets() == \
        (8, 64, 128)
    assert EngineConfig(prefill_buckets=(8, 64),
                        prefill_chunk_tokens=32).resolved_buckets() == (8, 64)


def test_custom_buckets_match_jax(models):
    """Chunks padded to custom buckets (8 and 24, completed with 32) give
    the JAX engine's tokens and counters."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in (3, 21, 40, 9)]
    (want, ws), (got, gs) = [
        _serve(eng, Req, prompts, 5)
        for eng, Req in _engines(models, prefill_chunk_tokens=32,
                                 prefill_buckets=(24, 8))]
    assert got == want
    assert _counters(gs) == _counters(ws)


def test_running_requests_lists_the_slots(models):
    _, (tm, tp) = models
    eng = ContinuousBatchingEngine(tm, tp, EngineConfig(device="cpu",
                                                        **BASE))
    reqs = [Request(prompt_tokens=[1, 2, 3 + i], model="m1", slo=1e9,
                    max_new_tokens=n) for i, n in enumerate((2, 6, 6))]
    assert eng.running_requests() == []
    for r in reqs:
        assert eng.admit(r)
    assert eng.running_requests() == reqs
    while not reqs[0].finished():
        eng.step()
    assert eng.running_requests() == reqs[1:]
    assert eng.running_requests() == [r for r in eng.slots if r is not None]


@pytest.mark.parametrize("burst", [4, 8])
def test_eos_mid_burst_matches_jax(models, burst):
    """Every slot emits EOS inside a burst: the port's burst runs on past
    it with no slot live, and its tokens and counters (decode iterations
    count only iterations that emitted a token) equal the JAX engine's,
    whose loop stops at once."""
    (want, ws), (got, gs) = [
        _serve(eng, Req, EOS_PROMPTS, 12)
        for eng, Req in _engines(models, decode_burst=burst, eos_token=EOS)]
    assert got == want
    assert all(t[-1] == EOS and 4 <= len(t) <= 6 for t in got)
    assert _counters(gs) == _counters(ws)


def test_decode_burst_never_syncs(models, monkeypatch):
    """Nothing inside ``_decode_burst`` reads a tensor back to the host:
    ``Tensor.__bool__`` and ``Tensor.item`` raise while it runs."""
    _, (tm, tp) = models
    eng = ContinuousBatchingEngine(tm, tp, EngineConfig(
        device="cpu", decode_burst=4, eos_token=EOS, **BASE))
    burst = eng._decode_burst
    calls = []

    def host_sync(*_):
        raise AssertionError("host sync inside the decode burst")

    def guarded(*args):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "__bool__", host_sync)
            m.setattr(torch.Tensor, "item", host_sync)
            out = burst(*args)
        calls.append(args[0])
        return out

    eng._decode_burst = guarded
    got, _ = _serve(eng, Request, EOS_PROMPTS, 12)
    assert calls and max(calls) == 4
    with pytest.raises(AssertionError):     # the guard does fire
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "__bool__", host_sync)
            bool(torch.ones(()))
    assert all(t[-1] == EOS for t in got)


def test_reference_knobs_are_accepted(models):
    """``pages_per_tile`` reaches the model config and ``donate_buffers``
    is accepted; neither changes a token (nor does either in JAX)."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in (5, 18, 11)]
    _, (tm, tp) = models
    plain = ContinuousBatchingEngine(tm, tp, EngineConfig(device="cpu",
                                                          **BASE))
    base, _ = _serve(plain, Request, prompts, 6)
    (want, _), (got, _) = [
        _serve(eng, Req, prompts, 6)
        for eng, Req in _engines(models, pages_per_tile=2,
                                 donate_buffers=False)]
    assert got == want == base
    eng = _engines(models, pages_per_tile=2)[1][0]
    assert eng.model.cfg.paged_pages_per_tile == 2
    assert plain.model is tm
