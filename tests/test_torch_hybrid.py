"""The port's zamba2 hybrid (``repro_torch.models.hybrid``) against the JAX
reference on the same weights (carried across by ``models/convert.py``) at
``zamba2-1.2b.reduced(num_layers=4, d_model=128)``: four mamba layers and
the shared attention block at two sites (after layers 1 and 3).

  * the weight bridge (the mamba blocks unstacked, the shared block
    carried across whole and back), the port's own init, the state's
    shapes (one dense KV cache per site, the reference's);
  * the single-shot prefill (prompt lengths 1, 5, 16 and 23: below the
    conv's history, mid-chunk, one chunk, past a chunk) and three
    teacher-forced decode steps: logits, conv histories, SSM states and
    every site's KV cache, in float and with int8 KV;
  * the reference's ``test_decode_matches_prefill`` on the port.

Tolerance: float32, atol = rtol = 1e-4 on logits, states and float caches
(as ``tests/test_torch_ssm.py``); with int8 KV, caches within 1 (as
``tests/test_torch_model.py``) and logits, states and scales within 1e-3,
the port's int8 logit tolerance (one int8 step at a rounding boundary
moves what the later layers compute); the decode-vs-prefill pattern
within the reference test's 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import build_model as jax_build_model
from repro.models import hybrid as jax_hybrid
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models import hybrid as port_hybrid
from repro_torch.models.convert import from_jax_params, to_jax_layout

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
# int8 KV: a last-bit difference can put a value across a rounding
# boundary, one int8 step, which later layers carry on; logits and states
# within the port's int8 logit tolerance (chip_smoke.py's LOGIT_TOL)
Q_TOL = dict(atol=1e-3, rtol=1e-3)
INT8_TOL = {"k": dict(atol=1, rtol=0), "v": dict(atol=1, rtol=0),
            "k_scale": Q_TOL, "v_scale": Q_TOL}
ARCH = "zamba2-1.2b"
KW = dict(num_layers=4, d_model=128)
S = 48


def _pair(quant=False):
    jcfg = dataclasses.replace(ARCHITECTURES[ARCH].reduced(**KW),
                               kv_quant=quant)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(**KW), kv_quant=quant)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return (jcfg, jmodel, jparams, np_params, tcfg, build_model(tcfg),
            from_jax_params(np_params, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(quant=False):
        if quant not in cache:
            cache[quant] = _pair(quant)
        return cache[quant]
    return get


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.float().numpy().astype(np.float64),
                               np.asarray(want).astype(np.float64), **tol)


def _state_close(tstate, jstate, quant: bool) -> None:
    """Conv histories, SSM states and each site's KV cache, every
    column."""
    for k in ("conv", "ssm"):
        _close(tstate[k], jstate[k], Q_TOL if quant else TOL)
    for name, jleaf in jstate["kv"].items():
        tleaf = tstate["kv"][name]
        if quant and name in ("k", "v"):
            assert tleaf.dtype == torch.int8
        _close(tleaf, jleaf, INT8_TOL[name] if quant else TOL)


def test_sites_and_state_shapes(pairs):
    jcfg, jmodel, *_, tcfg, tmodel, _ = pairs()
    assert port_hybrid.attn_sites(tcfg) == jax_hybrid.attn_sites(jcfg) \
        == [1, 3]
    jstate = jmodel.init_cache(3, S)
    tstate = tmodel.init_cache(3, S, torch.float32, "cpu")
    assert set(tstate) == set(jstate) == {"conv", "ssm", "kv"}
    for k in ("conv", "ssm"):
        assert tuple(tstate[k].shape) == jstate[k].shape
    assert set(tstate["kv"]) == set(jstate["kv"]) == {"k", "v"}
    want = jstate["kv"]["k"].shape
    assert want[0] == 2
    assert tuple(tstate["kv"]["k"].shape) == want
    qstate = pairs(True)[5].init_cache(3, S, torch.bfloat16, "cpu")
    assert set(qstate["kv"]) == {"k", "v", "k_scale", "v_scale"}
    assert qstate["kv"]["k"].dtype == torch.int8
    assert qstate["kv"]["k_scale"].dtype == torch.bfloat16
    assert qstate["ssm"].dtype == torch.float32


def test_convert_carries_the_hybrid_tree_exactly(pairs):
    *_, np_params, tcfg, _, tparams = pairs()
    assert len(tparams["blocks"]) == tcfg.num_layers == 4
    # the shared block is stored once: a dict, not a list of layers
    shared = tparams["shared_attn"]
    assert isinstance(shared, dict) and set(shared) == {
        "attn_norm", "attn", "mlp_norm", "mlp"}
    for k, v in np_params["shared_attn"]["attn"].items():
        np.testing.assert_array_equal(shared["attn"][k].numpy(), v)
    for i, block in enumerate(tparams["blocks"]):
        for k, v in block["mamba"].items():
            np.testing.assert_array_equal(
                v.numpy(), np_params["blocks"]["mamba"][k][i])
    back = to_jax_layout(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    jax.tree.map(np.testing.assert_array_equal, back, np_params)


def test_convert_refuses_a_wrong_depth(pairs):
    *_, np_params, tcfg, _, _ = pairs()
    with pytest.raises(ValueError, match="'blocks'"):
        from_jax_params(np_params, dataclasses.replace(tcfg, num_layers=6),
                        device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_init_has_the_reference_shapes_and_dtypes(pairs, dtype):
    jcfg, jmodel, *_, tmodel, _ = pairs()
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = jax.eval_shape(lambda k: jmodel.init(k, jdtype),
                          jax.random.key(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tmodel.init(gen, dtype, "cpu")
    got = to_jax_layout(params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
    assert params["shared_attn"]["attn"]["wq"].dtype == dtype
    assert all(t.dtype == dtype for b in params["blocks"]
               for t in b["mamba"].values())


def _prefill_then_decode(pairs, L, quant):
    jcfg, jmodel, jparams, _, tcfg, tmodel, tparams = pairs(quant)
    rng = np.random.default_rng(30 + L)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, L + 3)).astype(
        np.int32)
    jstate = jmodel.init_cache(2, S)
    tstate = tmodel.init_cache(2, S, torch.float32, "cpu")
    want, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :L])}, jstate)
    got, tstate = tmodel.prefill(tparams, {"tokens": torch.tensor(
        tokens[:, :L])}, tstate)
    tol = Q_TOL if quant else TOL
    _close(got, want, tol)
    _state_close(tstate, jstate, quant)
    lengths = np.full(2, L, np.int32)
    for t in range(3):
        step = tokens[:, L + t]
        want, jstate = jmodel.decode_step(jparams, jstate, jnp.asarray(step),
                                          jnp.asarray(lengths))
        got, tstate = tmodel.decode_step(tparams, tstate, torch.tensor(step),
                                         torch.tensor(lengths))
        _close(got, want, tol)
        _state_close(tstate, jstate, quant)
        lengths += 1
    assert got.shape == (2, tcfg.padded_vocab)


@pytest.mark.parametrize("L", [1, 5, 16, 23])
def test_prefill_then_decode_match_jax(pairs, L):
    _prefill_then_decode(pairs, L, quant=False)


@pytest.mark.parametrize("L", [5, 23])
def test_int8_prefill_then_decode_match_jax(pairs, L):
    _prefill_then_decode(pairs, L, quant=True)


def test_decode_matches_prefill(pairs):
    """The reference's ``test_decode_matches_prefill`` on the port: the
    logits of prefilling L + 3 tokens equal those of prefilling L and
    decoding 3 teacher-forced tokens."""
    *_, tcfg, tmodel, tparams = pairs()
    B, L = 2, 10
    gen = torch.Generator()
    gen.manual_seed(3)
    tokens = torch.randint(0, tcfg.vocab_size, (B, L + 3), generator=gen,
                           dtype=torch.int32)
    want, _ = tmodel.prefill(tparams, {"tokens": tokens},
                             tmodel.init_cache(B, 32, torch.float32, "cpu"))
    got, state = tmodel.prefill(tparams, {"tokens": tokens[:, :L]},
                                tmodel.init_cache(B, 32, torch.float32,
                                                  "cpu"))
    lengths = torch.full((B,), L, dtype=torch.int32)
    for t in range(3):
        got, state = tmodel.decode_step(tparams, state, tokens[:, L + t],
                                        lengths)
        lengths = lengths + 1
    np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_full_config_builds_and_training_is_not_ported():
    """The full config builds without the paged paths.  The name is
    historical: training is ported now, and its half of the test went with
    the raise it checked (tests/test_torch_ssm_training.py trains the
    hybrid)."""
    cfg = get_arch(ARCH)
    assert (cfg.arch_type, cfg.num_layers, cfg.hybrid_attn_every) \
        == ("hybrid", 38, 6)
    model = build_model(cfg)
    assert port_hybrid.attn_sites(cfg) == [5, 11, 17, 23, 29, 35]
    assert model.prefill_chunk is None and model.init_paged_cache is None
