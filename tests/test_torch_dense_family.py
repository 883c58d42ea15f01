"""The rest of the dense family in the port against the JAX reference on
the same weights (``models/convert.py``): qwen1.5-32b (40 heads on 40 KV
heads, QKV bias) and deepseek-67b (64 heads on 8 KV heads), reduced so
that each keeps its group and head_dim 128, through the single-shot
``prefill``, ``prefill_chunk`` / ``decode_step`` over the dense per-slot
cache and the paged pair ``prefill_chunk_paged`` / ``decode_step_paged``;
and the single-shot prefill of granite (float and int8 KV) and of
h2o-danube with a prompt past its 64-token rolling window, the cache it
fills included.

qwen's biases are drawn nonzero on the JAX side before the weights are
carried across: both packages initialise them to zero, which would hide a
dropped bias.

Tolerance: float32, atol = rtol = 1e-4 on logits and float caches; int8
caches within 1 and their scales within rtol 1e-5 (the frameworks'
float32 projections differ in the last bits, which can move a value
across a rounding boundary); exact on greedy tokens.
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
from repro_torch.configs.registry import ARCHITECTURES as PORT_ARCHITECTURES
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = {"k": dict(atol=1, rtol=0), "v": dict(atol=1, rtol=0),
            "k_scale": dict(atol=0, rtol=1e-5),
            "v_scale": dict(atol=0, rtol=1e-5)}
QWEN, DEEPSEEK = "qwen1.5-32b", "deepseek-67b"
GRANITE, DANUBE = "granite-3-2b", "h2o-danube-1.8b"
# reduced widths: head_dim = d_model / num_heads = 128; groups 1 and 8
REDUCED = {QWEN: dict(num_layers=2, d_model=512, num_heads=4, num_kv_heads=4),
           DEEPSEEK: dict(num_layers=2, d_model=1024, num_heads=8,
                          num_kv_heads=1),
           GRANITE: dict(num_layers=2, d_model=128, num_heads=4,
                         num_kv_heads=2),
           DANUBE: dict(num_layers=2, d_model=128, num_heads=4,
                        num_kv_heads=2)}
N, BS, NB = 16, 8, 6


def _pair(arch, quant=False):
    jcfg = dataclasses.replace(ARCHITECTURES[arch].reduced(**REDUCED[arch]),
                               kv_quant=quant)
    tcfg = dataclasses.replace(get_arch(arch).reduced(**REDUCED[arch]),
                               kv_quant=quant)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        attn = jparams["blocks"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = (0.5 * rng.standard_normal(attn[name].shape)
                          ).astype(np.float32)
    tparams = from_jax_params(jparams, tcfg, device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, jparams), build_model(tcfg), \
        tparams


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, quant=False):
        if (arch, quant) not in cache:
            cache[(arch, quant)] = _pair(arch, quant)
        return cache[(arch, quant)]
    return get


def _cache_close(tleaf, jleaf, name, quant):
    np.testing.assert_allclose(tleaf.numpy().astype(np.float64),
                               np.asarray(jleaf).astype(np.float64),
                               **(INT8_TOL[name] if quant else TOL))


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_registry_holds_the_reference_config(arch):
    """Registered, equal to the reference's config, and reduced to the
    arch's own group with head_dim 128."""
    assert dataclasses.asdict(PORT_ARCHITECTURES[arch]) \
        == dataclasses.asdict(ARCHITECTURES[arch])
    full = get_arch(arch)
    cfg = full.reduced(**REDUCED[arch])
    assert cfg.resolved_head_dim == full.resolved_head_dim == 128
    assert cfg.num_heads // cfg.num_kv_heads \
        == full.num_heads // full.num_kv_heads
    assert cfg.qkv_bias == (arch == QWEN)


def test_qkv_biases_are_carried_across(pairs):
    _, jparams, _, tparams = pairs(QWEN)
    for i, block in enumerate(tparams["blocks"]):
        for name in ("bq", "bk", "bv"):
            want = np.asarray(jparams["blocks"]["attn"][name][i])
            assert np.abs(want).max() > 0.1
            np.testing.assert_array_equal(block["attn"][name].numpy(), want)


@pytest.mark.parametrize("arch,quant,plen", [
    (QWEN, False, 20), (DEEPSEEK, False, 20), (GRANITE, False, 30),
    (GRANITE, True, 30), (DANUBE, False, 90), (DANUBE, True, 90)])
def test_single_shot_prefill_matches_jax(pairs, arch, quant, plen):
    """``prefill`` of two prompts at once: last-position logits and the
    filled cache, every column (danube's 90 tokens keep the last 64 at
    their rolling columns)."""
    jmodel, jparams, tmodel, tparams = pairs(arch, quant)
    B, S = 2, 128
    tokens = np.random.default_rng(plen).integers(0, 500, size=(B, plen),
                                                  dtype=np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                jmodel.init_cache(B, S))
    tcache = tmodel.init_cache(B, S, torch.float32, "cpu")
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.tensor(tokens)},
                                tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in tcache:
        assert tcache[name].shape == jcache[name].shape, name
        _cache_close(tcache[name], jcache[name], name, quant)


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_dense_chunks_and_decode_match_jax(pairs, arch):
    """The dense per-slot cache: a 40-token prompt in 16-token chunks, a
    9-token prompt and an empty slot, then three decode steps."""
    jmodel, jparams, tmodel, tparams = pairs(arch)
    B, S, C = 3, 64, 16
    jcache = jmodel.init_cache(B, S)
    tcache = tmodel.init_cache(B, S, torch.float32, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 500, size=n) for n in (40, 9, 0)]
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
    for _ in range(3):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tokens),
                                        jnp.asarray(lengths))
        tl, tcache = tmodel.decode_step(tparams, tcache, torch.tensor(tokens),
                                        torch.tensor(lengths))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        tokens = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tokens[:2],
                                      np.asarray(jl).argmax(-1)[:2])
        lengths = lengths + 1
    for name in tcache:
        _cache_close(tcache[name][:, :2], jcache[name][:, :2], name, False)


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_paged_chunks_and_decode_match_jax(pairs, arch):
    """The page pool: a 30-token prompt over scattered pages in two
    chunks, a 9-token prompt, an empty slot; then three decode steps."""
    jmodel, jparams, tmodel, tparams = pairs(arch)
    rng = np.random.default_rng(2)
    bt = np.full((3, NB), N, np.int32)
    bt[0, :5] = [3, 7, 1, 12, 5]
    bt[1, :2] = [9, 2]
    prompts = [rng.integers(0, 500, size=30), rng.integers(0, 500, size=9)]
    jcache = jmodel.init_paged_cache(N, BS)
    tcache = tmodel.init_paged_cache(N, BS, torch.float32, "cpu")
    tbt = torch.tensor(bt)
    for starts, valid in ((np.array([0, 0, 0], np.int32),
                           np.array([16, 9, 0], np.int32)),
                          (np.array([16, 9, 0], np.int32),
                           np.array([14, 0, 0], np.int32))):
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
    lengths = np.array([30, 9, 0], np.int32)
    tokens = np.array([prompts[0][-1], prompts[1][-1], 0], np.int32)
    for _ in range(3):
        jl, jcache = jmodel.decode_step_paged(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
            jnp.asarray(bt))
        tl, tcache = tmodel.decode_step_paged(
            tparams, tcache, torch.tensor(tokens), torch.tensor(lengths), tbt)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        tokens = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tokens[:2],
                                      np.asarray(jl).argmax(-1)[:2])
        lengths = lengths + np.array([1, 1, 0], np.int32)
    for name in ("k", "v"):
        _cache_close(tcache[name][:, :N], jcache[name], name, False)


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_serve_cli_serves_the_arch_reduced_on_the_cpu(arch):
    """``--arch qwen1.5-32b`` / ``--arch deepseek-67b`` resolve and serve
    reduced on the CPU, as granite does."""
    from repro_torch.launch import serve
    stats = serve.main(["--device", "cpu", "--arch", arch, "--requests", "4",
                        "--rate", "8", "--max-new-tokens", "4"])
    assert stats["served"] == stats["requests"] == 4
    assert stats["tokens"] == 4 * 3      # decode tokens: the first of
    # each request comes from its prefill
