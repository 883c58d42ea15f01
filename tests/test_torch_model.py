"""The port's transformer (``repro_torch.models``) against the JAX
reference on the same weights: ``models/convert.py`` carries the JAX
``Model.init`` params across, then the logits of prefill chunks and decode
steps, and the caches they write, must agree with
``repro.models.transformer`` (XLA path) on reduced granite with GQA (4
query heads on 2 KV heads): the paged pool in float and int8
(``prefill_chunk_paged`` / ``decode_step_paged``), and the dense per-slot
cache (``prefill_chunk`` / ``decode_step``) in float and int8 for granite
and for h2o-danube with prompts past its 64-token rolling window.  The
int8 quantizer itself is held bit for bit against the reference's.

Tolerance: float32, atol = rtol = 1e-4 on logits and float caches (matmul
sums and RoPE's sin/cos round differently in the two frameworks); int8
caches within 1 and their scales within rtol 1e-5 (those last-bit
differences can move a value across a rounding boundary); exact on
greedy tokens and on the quantizer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.models import attention as port_attention
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
N, BS, NB = 16, 8, 6


KW = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2)
INT8_TOL = {"k": dict(atol=1, rtol=0), "v": dict(atol=1, rtol=0),
            "k_scale": dict(atol=0, rtol=1e-5),
            "v_scale": dict(atol=0, rtol=1e-5)}


def _pair(arch, quant=False, seed=0):
    jcfg = dataclasses.replace(ARCHITECTURES[arch].reduced(**KW),
                               kv_quant=quant)
    tcfg = dataclasses.replace(get_arch(arch).reduced(**KW), kv_quant=quant)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    return jmodel, jparams, build_model(tcfg), from_jax_params(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _assert_cache_close(tleaf: torch.Tensor, jleaf, name: str,
                        quant: bool) -> None:
    if quant and name in ("k", "v"):
        assert tleaf.dtype == torch.int8 and np.asarray(jleaf).dtype == np.int8
    np.testing.assert_allclose(tleaf.numpy().astype(np.float64),
                               np.asarray(jleaf).astype(np.float64),
                               **(INT8_TOL[name] if quant else TOL))


@pytest.fixture(scope="module")
def models():
    kw = KW
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


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_is_bit_for_bit_the_references(dtype):
    """Rows with exact .5 quotients (round half to even), a zero row (the
    1e-8 scale floor) and random rows; the scale is stored in x's dtype."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 16)).astype(np.float32)
    x[0, 0] = np.arange(16) - 7.5          # amax 7.5: x / scale hits .5s
    x[0, 1] = np.linspace(-127, 127, 16) / 127 * 2.5
    x[1, 2] = 0.0
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.tensor(x, dtype=torch.bfloat16 if dtype == "bfloat16"
                      else torch.float32)
    jq, js = jax_attention._quantize_kv(jx)
    tq, ts = port_attention._quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == tx.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js).astype(np.float32))
    np.testing.assert_array_equal(
        port_attention._dequantize_kv(tq, ts, tx.dtype).float().numpy(),
        np.asarray(jax_attention._dequantize_kv(jq, js, jx.dtype))
        .astype(np.float32))


def test_int8_paged_chunks_and_decode_match_jax():
    """``kv_quant`` on the paged pool: int8 pages and scale pages written
    like the reference's, logits within tolerance."""
    jmodel, jparams, tmodel, tparams = _pair("granite-3-2b", quant=True)
    bt = np.full((2, NB), N, np.int32)
    bt[0, :4] = [3, 7, 1, 12]
    bt[1, :2] = [9, 2]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 500, size=27), rng.integers(0, 500, size=9)]
    jcache = jmodel.init_paged_cache(N, BS)
    tcache = tmodel.init_paged_cache(N, BS, torch.float32, "cpu")
    assert set(tcache) == {"k", "v", "k_scale", "v_scale"}
    assert tuple(tcache["k_scale"].shape) == (2, N + 1, 2, BS)
    tbt = torch.tensor(bt)
    for starts, valid in ((np.array([0, 0], np.int32),
                           np.array([16, 9], np.int32)),
                          (np.array([16, 9], np.int32),
                           np.array([11, 0], np.int32))):
        tokens = np.zeros((2, 16), np.int32)
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
    lengths = np.array([27, 9], np.int32)
    tokens = np.array([prompts[0][-1], prompts[1][-1]], np.int32)
    for _ in range(3):
        jl, jcache = jmodel.decode_step_paged(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
            jnp.asarray(bt))
        tl, tcache = tmodel.decode_step_paged(
            tparams, tcache, torch.tensor(tokens), torch.tensor(lengths), tbt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tokens = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tokens, np.asarray(jl).argmax(-1))
        lengths = lengths + 1
    for name in tcache:
        _assert_cache_close(tcache[name][:, :N], jcache[name], name, True)


@pytest.mark.parametrize("arch,quant", [("granite-3-2b", False),
                                        ("granite-3-2b", True),
                                        ("h2o-danube-1.8b", False),
                                        ("h2o-danube-1.8b", True)])
def test_dense_chunks_and_decode_match_jax(arch, quant):
    """The dense per-slot cache: three slots (a 90-token prompt in 32-token
    chunks, which wraps h2o-danube's 64-slot rolling window; a 20-token
    prompt; an empty slot), then four decode steps."""
    jmodel, jparams, tmodel, tparams = _pair(arch, quant)
    B, S, C = 3, 128, 32
    jcache = jmodel.init_cache(B, S)
    tcache = tmodel.init_cache(B, S, torch.float32, "cpu")
    S_eff = jcache["k"].shape[3]
    assert S_eff == (64 if arch.startswith("h2o") else S)
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 500, size=n) for n in (90, 20, 0)]
    starts = np.zeros(B, np.int32)
    while True:
        valid = np.array([min(C, len(p) - s) for p, s in zip(prompts, starts)],
                         np.int32)
        if not valid.any():
            break
        tokens = np.zeros((B, C), np.int32)
        for b, p in enumerate(prompts):
            tokens[b, :valid[b]] = p[starts[b]:starts[b] + valid[b]]
        jl, jcache = jmodel.prefill_chunk(jparams, jcache, jnp.asarray(tokens),
                                          jnp.asarray(starts),
                                          jnp.asarray(valid))
        tl, tcache = tmodel.prefill_chunk(tparams, tcache, torch.tensor(tokens),
                                          torch.tensor(starts),
                                          torch.tensor(valid))
        live = valid > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        starts = starts + valid
    lengths = starts.copy()
    tokens = np.array([p[-1] if len(p) else 0 for p in prompts], np.int32)
    for _ in range(4):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tokens),
                                        jnp.asarray(lengths))
        tl, tcache = tmodel.decode_step(tparams, tcache, torch.tensor(tokens),
                                        torch.tensor(lengths))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        tokens = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tokens[:2],
                                      np.asarray(jl).argmax(-1)[:2])
        lengths = lengths + 1
    for name in tcache:                # the live slots, every column
        _assert_cache_close(tcache[name][:, :2],
                            jcache[name][:, :2], name, quant)
