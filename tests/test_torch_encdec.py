"""The port's whisper encoder-decoder (``repro_torch.models.encdec``) and the
layers it adds (``layer_norm``, ``gelu_mlp``, ``sinusoidal_positions``)
against the JAX reference on the same weights (carried across by
``models/convert.py``) at ``whisper-medium.reduced(num_layers=2,
d_model=128)`` (16 frames), and once with 3 encoder layers on 2 decoder
layers:

  * the layers on random inputs (GELU in its tanh form, which the exact
    form misses by more than the tolerance; the population variance);
  * the weight bridge (both stacks unstacked and back), the port's own
    init, the cache's shapes;
  * the encoder's output, then the single-shot prefill (prompt lengths 1,
    6 and 17) and three teacher-forced decode steps: logits, the decoder's
    self caches and the cross K/V, in float and with int8 KV;
  * the reference's ``test_decode_matches_prefill`` on the port;
  * the modality stub: ``batch_struct`` / ``materialize_batch`` carry the
    frames; ``prefill`` without them raises, naming the model.

Tolerance: float32, atol = rtol = 1e-4 on outputs, logits and float
caches; with int8 KV, caches within 1 (as ``tests/test_torch_model.py``)
and logits and scales within 1e-3, the port's int8 logit tolerance (one
int8 step at a rounding boundary moves what the later layers compute);
the decode-vs-prefill pattern within the reference test's 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro.models import model_factory as jax_factory
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models import encdec as port_encdec
from repro_torch.models import layers as port_layers
from repro_torch.models import model_factory as port_factory
from repro_torch.models.convert import from_jax_params, to_jax_layout

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
Q_TOL = dict(atol=1e-3, rtol=1e-3)
INT8_TOL = {"k": dict(atol=1, rtol=0), "v": dict(atol=1, rtol=0),
            "k_scale": Q_TOL, "v_scale": Q_TOL}
ARCH = "whisper-medium"
KW = dict(num_layers=2, d_model=128)
S = 40


def _cfgs(quant=False, enc_layers=None):
    out = []
    for cfg in (ARCHITECTURES[ARCH].reduced(**KW),
                get_arch(ARCH).reduced(**KW)):
        if enc_layers is not None:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, num_layers=enc_layers))
        out.append(dataclasses.replace(cfg, kv_quant=quant))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(quant=False, enc_layers=None):
        key = (quant, enc_layers)
        if key not in cache:
            jcfg, tcfg = _cfgs(quant, enc_layers)
            jmodel = jax_build_model(jcfg)
            jparams = jmodel.init(jax.random.key(0))
            np_params = jax.tree.map(np.asarray, jparams)
            cache[key] = (jcfg, jmodel, jparams, np_params, tcfg,
                          build_model(tcfg),
                          from_jax_params(np_params, tcfg, device="cpu"))
        return cache[key]
    return get


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.float().numpy().astype(np.float64),
                               np.asarray(want).astype(np.float64), **tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layer_norm_gelu_mlp_and_positions_match_jax():
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(port_layers.layer_norm(torch.tensor(x), torch.tensor(scale),
                                  torch.tensor(bias), 1e-5),
           jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-5))
    mlp = {"fc1": rng.standard_normal((64, 96)).astype(np.float32) * 0.3,
           "b1": rng.standard_normal(96).astype(np.float32),
           "fc2": rng.standard_normal((96, 64)).astype(np.float32) * 0.1,
           "b2": rng.standard_normal(64).astype(np.float32)}
    want = jax_layers.gelu_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                               jnp.asarray(x))
    tmlp = {k: torch.tensor(v) for k, v in mlp.items()}
    _close(port_layers.gelu_mlp(tmlp, torch.tensor(x)), want)
    # the exact GELU is not the reference's: the tolerance tells them apart
    h = torch.nn.functional.gelu(torch.tensor(x) @ tmlp["fc1"] + tmlp["b1"])
    with pytest.raises(AssertionError):
        _close(h @ tmlp["fc2"] + tmlp["b2"], want)
    _close(port_layers.sinusoidal_positions(1500, 1024),
           jax_layers.sinusoidal_positions(1500, 1024))


# ---------------------------------------------------------------------------
# weights and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enc_layers", [None, 3])
def test_convert_carries_the_encdec_tree_exactly(pairs, enc_layers):
    jcfg, *_, np_params, tcfg, _, tparams = pairs(enc_layers=enc_layers)
    assert len(tparams["enc_blocks"]) == tcfg.encoder.num_layers \
        == (enc_layers or 2)
    assert len(tparams["dec_blocks"]) == tcfg.num_layers == 2
    for i, block in enumerate(tparams["dec_blocks"]):
        for k, v in block["cross_attn"].items():
            np.testing.assert_array_equal(
                v.numpy(), np_params["dec_blocks"]["cross_attn"][k][i])
    for name in ("enc_final_s", "enc_final_b", "final_s", "final_b",
                 "embed"):
        np.testing.assert_array_equal(tparams[name].numpy(),
                                      np_params[name])
    back = to_jax_layout(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    jax.tree.map(np.testing.assert_array_equal, back, np_params)
    with pytest.raises(ValueError, match="'enc_blocks'"):
        from_jax_params(np_params, dataclasses.replace(
            tcfg, encoder=dataclasses.replace(tcfg.encoder, num_layers=5)),
            device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_init_and_cache_have_the_reference_shapes(pairs, dtype):
    jcfg, jmodel, *_, tmodel, _ = pairs(enc_layers=3)
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
    assert params["dec_blocks"][0]["mlp"]["fc1"].dtype == dtype
    jcache = jmodel.init_cache(3, S, jdtype)
    tcache = tmodel.init_cache(3, S, dtype, "cpu")
    assert set(tcache) == set(jcache) == {"self", "cross_k", "cross_v"}
    for name in ("cross_k", "cross_v"):
        assert tuple(tcache[name].shape) == jcache[name].shape \
            == (2, 3, jcfg.num_kv_heads, 16, jcfg.resolved_head_dim)
        assert tcache[name].dtype == dtype
    k = jcache["self"]["k"].shape
    assert tuple(tcache["self"]["k"].shape) == k


# ---------------------------------------------------------------------------
# serving paths
# ---------------------------------------------------------------------------

def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal(
        (B, cfg.encoder.num_frames, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("enc_layers", [None, 3])
def test_encoder_matches_jax(pairs, enc_layers):
    jcfg, _, jparams, _, tcfg, _, tparams = pairs(enc_layers=enc_layers)
    f = _frames(tcfg, 2, 1)
    _close(port_encdec.encode(tparams, tcfg, torch.tensor(f)),
           jax_encdec.encode(jparams, jcfg, jnp.asarray(f)))


def _cache_close(tcache, jcache, quant: bool) -> None:
    """The self caches and the cross K/V, every column."""
    for name in ("cross_k", "cross_v"):
        _close(tcache[name], jcache[name])
    for name, jleaf in jcache["self"].items():
        tleaf = tcache["self"][name]
        if quant and name in ("k", "v"):
            assert tleaf.dtype == torch.int8
        _close(tleaf, jleaf, INT8_TOL[name] if quant else TOL)


def _prefill_then_decode(pairs, L, quant=False, enc_layers=None):
    jcfg, jmodel, jparams, _, tcfg, tmodel, tparams = pairs(quant,
                                                            enc_layers)
    rng = np.random.default_rng(50 + L)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, L + 3)).astype(
        np.int32)
    f = _frames(tcfg, 2, L)
    jcache = jmodel.init_cache(2, S)
    tcache = tmodel.init_cache(2, S, torch.float32, "cpu")
    want, jcache = jmodel.prefill(jparams, {
        "tokens": jnp.asarray(tokens[:, :L]),
        "frame_embeds": jnp.asarray(f)}, jcache)
    got, tcache = tmodel.prefill(tparams, {
        "tokens": torch.tensor(tokens[:, :L]),
        "frame_embeds": torch.tensor(f)}, tcache)
    tol = Q_TOL if quant else TOL
    _close(got, want, tol)
    _cache_close(tcache, jcache, quant)
    lengths = np.full(2, L, np.int32)
    for t in range(3):
        step = tokens[:, L + t]
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(step),
                                          jnp.asarray(lengths))
        got, tcache = tmodel.decode_step(tparams, tcache, torch.tensor(step),
                                         torch.tensor(lengths))
        _close(got, want, tol)
        _cache_close(tcache, jcache, quant)
        lengths += 1
    assert got.shape == (2, tcfg.padded_vocab)


@pytest.mark.parametrize("L", [1, 6, 17])
def test_prefill_then_decode_match_jax(pairs, L):
    _prefill_then_decode(pairs, L)


def test_unequal_encoder_depth_prefill_then_decode_match_jax(pairs):
    _prefill_then_decode(pairs, 6, enc_layers=3)


def test_int8_prefill_then_decode_match_jax(pairs):
    _prefill_then_decode(pairs, 6, quant=True)


def test_decode_matches_prefill(pairs):
    """The reference's ``test_decode_matches_prefill`` on the port."""
    *_, tcfg, tmodel, tparams = pairs()
    B, L = 2, 10
    gen = torch.Generator()
    gen.manual_seed(3)
    tokens = torch.randint(0, tcfg.vocab_size, (B, L + 3), generator=gen,
                           dtype=torch.int32)
    f = torch.tensor(_frames(tcfg, B, 3))
    want, _ = tmodel.prefill(tparams, {"tokens": tokens, "frame_embeds": f},
                             tmodel.init_cache(B, 32, torch.float32, "cpu"))
    got, cache = tmodel.prefill(
        tparams, {"tokens": tokens[:, :L], "frame_embeds": f},
        tmodel.init_cache(B, 32, torch.float32, "cpu"))
    lengths = torch.full((B,), L, dtype=torch.int32)
    for t in range(3):
        got, cache = tmodel.decode_step(tparams, cache, tokens[:, L + t],
                                        lengths)
        lengths = lengths + 1
    np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# the modality stub, the full config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_struct_carries_the_frames(kind):
    cfg = get_arch(ARCH)
    want = jax_factory.batch_struct(ARCHITECTURES[ARCH], 2, 24, kind)
    got = port_factory.batch_struct(cfg, 2, 24, kind)
    assert {k: v[0] for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    gen = torch.Generator()
    gen.manual_seed(0)
    batch = port_factory.materialize_batch(cfg, 2, 24, kind, gen,
                                           device="cpu")
    if kind != "decode":
        assert tuple(batch["frame_embeds"].shape) == (2, 1500, 1024)
        assert batch["frame_embeds"].dtype == torch.float32


def test_prefill_needs_frames_and_training_is_not_ported(pairs):
    """A prefill without frame embeddings raises, naming the model, and
    the full config builds.  The name is historical: training is ported
    now, and its half of the test went with the raise it checked
    (tests/test_torch_ssm_training.py trains the encoder-decoder)."""
    *_, tcfg, tmodel, tparams = pairs()
    cache = tmodel.init_cache(1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match=tcfg.name):
        tmodel.prefill(tparams, {"tokens": torch.zeros((1, 3),
                                                       dtype=torch.int32)},
                       cache)
    cfg = get_arch(ARCH)
    assert (cfg.arch_type, cfg.num_layers, cfg.encoder.num_layers,
            cfg.encoder.num_frames) == ("audio", 24, 24, 1500)
    model = build_model(cfg)
    assert model.prefill_chunk is None and model.init_paged_cache is None
