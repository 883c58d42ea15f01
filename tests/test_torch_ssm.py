"""The port's mamba2 (``repro_torch.models.ssm`` / ``ssm_lm``) against the
JAX reference on the same weights (carried across by
``models/convert.py``) at ``mamba2-130m.reduced(num_layers=2,
d_model=128)``: the weight bridge, the port's own init, one block's full
and step forms from a nonzero state, and the LM's single-shot prefill
(prompt lengths 1 and 2, below the conv's W - 1 = 3; 5, mid-chunk; 16, one
chunk exactly; 23, past a chunk) followed by 4 decode steps, for the
logits and both states (conv history and SSM state).

Tolerance: float32, atol = rtol = 1e-4 (matmul sums in another order;
torch's softplus returns its input above 20 where JAX's is exact, a
difference of at most about 2e-9).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models import ssm as port_ssm
from repro_torch.models.convert import from_jax_params, to_jax_layout

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "mamba2-130m"
KW = dict(num_layers=2, d_model=128)


@pytest.fixture(scope="module")
def models():
    jcfg = ARCHITECTURES[ARCH].reduced(**KW)
    tcfg = get_arch(ARCH).reduced(**KW)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return (jcfg, jmodel, jparams, np_params, tcfg, build_model(tcfg),
            from_jax_params(np_params, tcfg, device="cpu"))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


def test_convert_carries_the_ssm_tree_exactly(models):
    *_, np_params, tcfg, _, tparams = models
    assert len(tparams["blocks"]) == tcfg.num_layers == 2
    for name in ("embed", "final_norm"):
        np.testing.assert_array_equal(tparams[name].numpy(), np_params[name])
    for i, block in enumerate(tparams["blocks"]):
        np.testing.assert_array_equal(block["norm"].numpy(),
                                      np_params["blocks"]["norm"][i])
        assert set(block["mamba"]) == set(np_params["blocks"]["mamba"])
        for k, v in block["mamba"].items():
            np.testing.assert_array_equal(
                v.numpy(), np_params["blocks"]["mamba"][k][i])
    back = to_jax_layout(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    jax.tree.map(np.testing.assert_array_equal, back, np_params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_init_has_the_reference_shapes_and_dtypes(models, dtype):
    jcfg, jmodel, *_, tmodel, _ = models
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = jax.eval_shape(lambda k: jmodel.init(k, jdtype),
                          jax.random.key(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    got = to_jax_layout(tmodel.init(gen, dtype, "cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
    flat = [l for b in tmodel.init(gen, dtype, "cpu")["blocks"]
            for l in b["mamba"].values()]
    assert all(t.dtype == dtype for t in flat)
    # A_log spans log 1 .. log 16 and dt_bias maps to dt in [1e-3, 1e-1]
    block = tmodel.init(gen, torch.float32, "cpu")["blocks"][0]["mamba"]
    torch.testing.assert_close(block["A_log"][[0, -1]],
                               torch.log(torch.tensor([1.0, 16.0])))
    dt = torch.nn.functional.softplus(block["dt_bias"])
    assert bool(((dt > 1e-3 - 1e-6) & (dt < 1e-1 + 1e-6)).all())
    cache = tmodel.init_cache(3, 64, dtype, "cpu")
    jcache = jmodel.init_cache(3, 64, jdtype)
    for name in ("conv", "ssm"):
        assert tuple(cache[name].shape) == jcache[name].shape
    assert cache["conv"].dtype == dtype and cache["ssm"].dtype == torch.float32


def _random_states(rng, cfg, B):
    ssm = cfg.ssm
    conv_dim = ssm.d_inner(cfg.d_model) + 2 * ssm.n_groups * ssm.d_state
    return {"conv": rng.standard_normal(
                (B, ssm.conv_width - 1, conv_dim)).astype(np.float32),
            "ssm": rng.standard_normal(
                (B, ssm.num_heads(cfg.d_model), ssm.d_state,
                 ssm.head_dim)).astype(np.float32)}


@pytest.mark.parametrize("L", [1, 5, 16, 23])
def test_block_full_and_step_match_jax(models, L):
    jcfg, _, jparams, _, tcfg, _, tparams = models
    rng = np.random.default_rng(L)
    u = rng.standard_normal((2, L, tcfg.d_model)).astype(np.float32)
    st = _random_states(rng, tcfg, 2)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["mamba"])
    tp = tparams["blocks"][0]["mamba"]
    want, want_st = jax_ssm.mamba_block_full(
        jp, jcfg, jnp.asarray(u), jax.tree.map(jnp.asarray, st))
    got, got_st = port_ssm.mamba_block_full(
        tp, tcfg, torch.tensor(u), {k: torch.tensor(v) for k, v in st.items()})
    _close(got, want)
    for k in ("conv", "ssm"):
        _close(got_st[k], want_st[k])
    want, want_st = jax_ssm.mamba_block_step(
        jp, jcfg, jnp.asarray(u[:, :1]), jax.tree.map(jnp.asarray, st))
    got, got_st = port_ssm.mamba_block_step(
        tp, tcfg, torch.tensor(u[:, :1]),
        {k: torch.tensor(v) for k, v in st.items()})
    _close(got, want)
    for k in ("conv", "ssm"):
        _close(got_st[k], want_st[k])


@pytest.mark.parametrize("L", [1, 2, 5, 16, 23])
def test_prefill_then_decode_match_jax(models, L):
    jcfg, jmodel, jparams, _, tcfg, tmodel, tparams = models
    rng = np.random.default_rng(10 + L)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, L + 4)).astype(
        np.int32)
    jcache = jmodel.init_cache(2, 64)
    tcache = tmodel.init_cache(2, 64, torch.float32, "cpu")
    want, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :L])}, jcache)
    got, tcache = tmodel.prefill(tparams, {"tokens": torch.tensor(
        tokens[:, :L])}, tcache)
    _close(got, want)
    lengths = np.full(2, L, np.int32)
    for t in range(4):
        for k in ("conv", "ssm"):
            _close(tcache[k], jcache[k])
        step = tokens[:, L + t]
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(step),
                                          jnp.asarray(lengths))
        got, tcache = tmodel.decode_step(tparams, tcache, torch.tensor(step),
                                         torch.tensor(lengths))
        _close(got, want)
        lengths += 1
    assert got.shape == (2, tcfg.padded_vocab)
