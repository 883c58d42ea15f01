"""The port's layer functions (``repro_torch.models.layers``) against the
JAX reference (``repro.models.layers``) on the same numpy inputs.

Tolerance: float32, atol = rtol = 1e-5 (the two frameworks round sin/cos,
rsqrt and matmul sums differently in the last bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as JAX_ARCHS
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.models import layers as tl

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    _close(tl.rms_norm(torch.tensor(x), torch.tensor(s), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    _close(tl.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_swiglu_mlp():
    rng = np.random.default_rng(2)
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in (("gate", (32, 64)), ("up", (32, 64)),
                      ("down", (64, 32)))}
    x = rng.standard_normal((4, 32)).astype(np.float32)
    _close(tl.swiglu_mlp({k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x)),
           jl.swiglu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)))


def test_mask_padded_logits():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 512)).astype(np.float32)
    _close(tl.mask_padded_logits(torch.tensor(logits), 500),
           jl.mask_padded_logits(jnp.asarray(logits), 500))
    same = tl.mask_padded_logits(torch.tensor(logits), 512)
    np.testing.assert_array_equal(same.numpy(), logits)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_unembed(tie):
    import dataclasses
    cfg_t = dataclasses.replace(get_arch("granite-3-2b").reduced(d_model=64),
                                tie_embeddings=tie)
    cfg_j = dataclasses.replace(JAX_ARCHS["granite-3-2b"].reduced(d_model=64),
                                tie_embeddings=tie)
    rng = np.random.default_rng(4)
    p = {"embed": rng.standard_normal((cfg_t.padded_vocab, 64))
         .astype(np.float32)}
    if not tie:
        p["lm_head"] = rng.standard_normal((64, cfg_t.padded_vocab)) \
            .astype(np.float32)
    tokens = rng.integers(0, cfg_t.vocab_size, size=(2, 5)).astype(np.int32)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    pt = {k: torch.tensor(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    _close(tl.embed_tokens(pt, torch.tensor(tokens)),
           jt.embed_tokens(pj, cfg_j, jnp.asarray(tokens)))
    _close(tl.unembed(pt, cfg_t, torch.tensor(x)),
           jt.unembed(pj, cfg_j, jnp.asarray(x)))


def test_init_draws_on_the_requested_device_with_reference_scales():
    cfg = get_arch("granite-3-2b").reduced(num_layers=1, d_model=128)
    from repro_torch.models import build_model
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    p = build_model(cfg).init(gen, torch.float32, "cpu")
    wq = p["blocks"][0]["attn"]["wq"]
    assert wq.device.type == "cpu" and wq.dtype == torch.float32
    # truncated normal at 2 std of 1/sqrt(fan_in)
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(128) + 1e-6
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
