"""The port's paged transformer (``repro_torch.models``) against the JAX
reference on the same weights: ``models/convert.py`` carries the JAX
``Model.init`` params across, then the logits of two prefill chunks and
three decode steps, and the page pools they write, must agree with
``repro.models.transformer.prefill_chunk_paged`` / ``decode_step_paged``
(XLA path) on reduced granite with GQA (4 query heads on 2 KV heads).

Tolerance: float32, atol = rtol = 1e-4 on logits and pages (matmul sums
and RoPE's sin/cos round differently in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
N, BS, NB = 16, 8, 6


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2)
    jcfg = ARCHITECTURES["granite-3-2b"].reduced(**kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tcfg = get_arch("granite-3-2b").reduced(**kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, build_model(tcfg), \
        from_jax_params(np_params, tcfg, device="cpu"), np_params


def test_convert_unstacks_layers_exactly(models):
    _, _, tmodel, tparams, np_params = models
    assert len(tparams["blocks"]) == tmodel.cfg.num_layers
    for i, blk in enumerate(tparams["blocks"]):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                blk["attn"][name].numpy(), np_params["blocks"]["attn"][name][i])
        np.testing.assert_array_equal(blk["mlp"]["down"].numpy(),
                                      np_params["blocks"]["mlp"]["down"][i])
    np.testing.assert_array_equal(tparams["embed"].numpy(), np_params["embed"])
    assert "lm_head" not in tparams          # granite ties its embeddings


def test_prefill_chunks_and_decode_steps_match_jax(models):
    jmodel, jparams, tmodel, tparams, _ = models
    rng = np.random.default_rng(0)
    # row 0: a 30-token prompt in two chunks of 16; row 1: a 9-token prompt
    # in the first chunk; row 2: an empty slot (all-sentinel table)
    bt = np.full((3, NB), N, np.int32)
    bt[0, :5] = [3, 7, 1, 12, 5]
    bt[1, :2] = [9, 2]
    prompts = [rng.integers(0, 500, size=30), rng.integers(0, 500, size=9)]
    chunks = [(np.array([0, 0, 0], np.int32), np.array([16, 9, 0], np.int32)),
              (np.array([16, 9, 0], np.int32), np.array([14, 0, 0], np.int32))]
    jcache = jmodel.init_paged_cache(N, BS)
    tcache = tmodel.init_paged_cache(N, BS, torch.float32, "cpu")
    tbt = torch.tensor(bt)

    def check_pages():
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name][:, :N].numpy(),
                                       np.asarray(jcache[name]), **TOL)

    for starts, valid in chunks:
        tokens = np.zeros((3, 16), np.int32)
        for b, p in enumerate(prompts):
            tokens[b, :valid[b]] = p[starts[b]:starts[b] + valid[b]]
        jl, jcache = jmodel.prefill_chunk_paged(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(starts),
            jnp.asarray(valid), jnp.asarray(bt))
        tl, tcache = tmodel.prefill_chunk_paged(
            tparams, tcache, torch.tensor(tokens), torch.tensor(starts),
            torch.tensor(valid), tbt)
        live = valid > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        check_pages()

    lengths = np.array([30, 9, 0], np.int32)
    tokens = np.array([prompts[0][-1], prompts[1][-1], 0], np.int32)
    for _ in range(3):
        jl, jcache = jmodel.decode_step_paged(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
            jnp.asarray(bt))
        tl, tcache = tmodel.decode_step_paged(
            tparams, tcache, torch.tensor(tokens), torch.tensor(lengths), tbt)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        check_pages()
        tokens = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tokens[:2],
                                      np.asarray(jl).argmax(-1)[:2])
        lengths = lengths + np.array([1, 1, 0], np.int32)
