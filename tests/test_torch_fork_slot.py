"""``fork_slot`` in the port's engine on the page pool (``"paged-cuda"``),
on the CPU, against the JAX engine on ``"paged-xla"`` with the same
weights (``models/convert.py``); the twin of the reference's
``tests/test_paged_engine.py::test_fork_slot_cow_divergence``:

  * the fork copies no page; the clone's partial tail block is copied on
    write exactly once, at the next dispatch;
  * ``forks`` and ``cow_copies`` equal the JAX engine's, and under greedy
    decoding the clone's tokens equal the source's, the unforked
    baseline's and the JAX engine's;
  * the dense layout (sharing inert) refuses with ``ValueError``, a fork
    with no free slot returns None, a fork of a mid-prefill slot raises.

Tolerance: exact on tokens and counters.
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
            block_size=8)


@pytest.fixture(scope="module")
def models():
    jcfg = ARCHITECTURES["granite-3-2b"].reduced(num_layers=1, d_model=64)
    tcfg = get_arch("granite-3-2b").reduced(num_layers=1, d_model=64)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(2))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return (jmodel, jparams), (build_model(tcfg), tparams)


def _engines(models, **kw):
    (jm, jp), (tm, tp) = models
    cfg = {**BASE, **kw}
    return [(JaxEngine(jm, jp, JaxEngineConfig(attention_backend="paged-xla",
                                               **cfg), model_name="m1"),
             JaxRequest),
            (ContinuousBatchingEngine(tm, tp, EngineConfig(
                device="cpu", attention_backend="paged-cuda", **cfg),
                model_name="m1"), Request)]


def _prompt():
    """Two full blocks of 8 and a 5-token partial tail."""
    return np.random.default_rng(5).integers(0, 100, size=21).tolist()


def _req(cls, prompt, n):
    return cls(prompt_tokens=list(prompt), model="m1", slo=1e9,
               max_new_tokens=n)


def test_fork_slot_cow_divergence(models):
    """fork_slot clones a running decode with zero page copies; the COW of
    the partial tail block isolates the two writers, and the clone
    continues exactly like the source and the unforked baseline."""
    results = []
    for (base, Req), (eng, _) in zip(_engines(models, prefix_sharing=False),
                                     _engines(models, prefix_sharing=True)):
        r_base = _req(Req, _prompt(), 10)
        assert base.admit(r_base)
        for _ in range(60):
            base.step()
            if r_base.finished():
                break
        assert r_base.finished()

        src = _req(Req, _prompt(), 10)
        assert eng.admit(src)
        while eng.prefilling_slots():
            eng.step()
        eng.step()
        eng.step()
        clone = eng.fork_slot(0)
        assert clone is not None and clone.output_tokens == src.output_tokens
        assert clone.first_token_time == src.first_token_time
        assert clone.generated == src.generated
        assert eng.stats.forks == 1
        assert eng.stats.cow_copies == 0          # the fork copies no page
        assert eng.block_mgr.block_table(clone.req_id)[:-1] \
            == eng.block_mgr.block_table(src.req_id)[:-1]
        eng.step()
        assert eng.stats.cow_copies == 1          # the tail, at dispatch
        for _ in range(60):
            eng.step()
            if src.finished() and clone.finished():
                break
        assert src.finished() and clone.finished()
        assert src.output_tokens == r_base.output_tokens
        assert clone.output_tokens == r_base.output_tokens
        assert eng.block_mgr.used_blocks == 0
        results.append((r_base.output_tokens, eng.stats.forks,
                        eng.stats.cow_copies))
    assert results[1] == results[0]


def test_fork_refusals(models):
    """The dense layout refuses; a full engine returns None; a mid-prefill
    slot raises, as in the reference."""
    _, (tm, tp) = models
    dense = ContinuousBatchingEngine(tm, tp, EngineConfig(
        device="cpu", attention_backend="cuda", **BASE), model_name="m1")
    rd = _req(Request, [1, 2, 3], 2)
    assert dense.admit(rd)
    with pytest.raises(ValueError, match="prefix_sharing"):
        dense.fork_slot(0)

    eng = ContinuousBatchingEngine(tm, tp, EngineConfig(
        device="cpu", attention_backend="paged-cuda",
        **{**BASE, "max_slots": 2}), model_name="m1")
    long = _req(Request, _prompt(), 4)
    assert eng.admit(long)
    with pytest.raises(ValueError, match="mid-prefill"):
        eng.fork_slot(0)
    while eng.prefilling_slots():
        eng.step()
    other = _req(Request, [7, 8, 9], 4)
    assert eng.admit(other)
    eng.step()
    assert eng._free_slot() is None
    assert eng.fork_slot(0) is None
    assert eng.stats.forks == 0
