"""The port's dense decode attention (``repro_torch.kernels.decode_attention``;
on CPU tensors its plain versions) against the JAX Pallas kernels
``decode_attention`` and ``decode_attention_quant`` in interpret mode and
the dense oracle, on the same numpy inputs: GQA groups, a cache length
that is no multiple of the Pallas block, a row with no valid key, and the
inclusive length convention at 1, mid-cache and the full cache (mirrors
``tests/test_kernels.py``).

Tolerance: float32, atol = rtol = 2e-5, as the reference kernel tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.decode_attention import decode_attention_quant
from repro_torch.kernels import decode_attention as da

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _port(*arrays):
    before = da.launches
    out = da.decode_attention(*[torch.from_numpy(a) for a in arrays])
    assert da.launches == before         # CPU tensors: the plain version
    return out.numpy()


def _port_quant(*arrays):
    before = da.quant_launches
    out = da.decode_attention_quant(*[torch.from_numpy(a) for a in arrays])
    assert da.quant_launches == before
    return out.numpy()


def _int8(rng, B, KVH, S, D):
    kq, vq = (rng.integers(-127, 128, size=(B, KVH, S, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((B, KVH, S)) * 0.1).astype(np.float32)
              for _ in range(2))
    return kq, vq, ks, vs


@pytest.mark.parametrize("B,H,KVH,S,D", [
    (2, 8, 2, 64, 32),
    (3, 4, 4, 40, 16),       # S is no multiple of the Pallas block
    (4, 32, 8, 129, 64),
    (2, 4, 1, 24, 80),       # h2o-danube's head_dim
])
def test_decode_matches_jax(B, H, KVH, S, D):
    rng = np.random.default_rng(30)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    lengths[0] = 1
    got = _port(q, k, v, lengths)
    np.testing.assert_allclose(
        got, np.asarray(ops.decode_attention(q, k, v, lengths)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.decode_attention_ref(q, k, v, lengths)), **TOL)


@pytest.mark.parametrize("B,H,KVH,S,D", [(2, 4, 2, 64, 16),
                                          (3, 8, 8, 33, 32)])
def test_decode_quant_matches_jax(B, H, KVH, S, D):
    rng = np.random.default_rng(31)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kq, vq, ks, vs = _int8(rng, B, KVH, S, D)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    got = _port_quant(q, kq, vq, ks, vs, lengths)
    want = decode_attention_quant(jnp.asarray(q), jnp.asarray(kq),
                                  jnp.asarray(vq), jnp.asarray(ks),
                                  jnp.asarray(vs), jnp.asarray(lengths),
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("length", [1, 20, 64])  # incl. the full cache
def test_decode_quant_length_convention(length):
    """The int8 and float kernels consume the same inclusive ``lengths``:
    identical int8 content through the int8 kernel and, dequantized,
    through the float kernel agree for every length, lengths == S too
    (the case in ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(13)
    B, H, KVH, S, D = 2, 4, 2, 64, 16
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kq, vq, ks, vs = _int8(rng, B, KVH, S, D)
    lengths = np.array([length, max(1, length - 1)], np.int32)
    got = _port_quant(q, kq, vq, ks, vs, lengths)
    k = kq.astype(np.float32) * ks[..., None]
    v = vq.astype(np.float32) * vs[..., None]
    np.testing.assert_allclose(got, _port(q, k, v, lengths), **TOL)
    want = decode_attention_quant(jnp.asarray(q), jnp.asarray(kq),
                                  jnp.asarray(vq), jnp.asarray(ks),
                                  jnp.asarray(vs), jnp.asarray(lengths),
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_decode_empty_row_is_zero():
    """A row with no valid key returns 0, as the Pallas kernels do."""
    rng = np.random.default_rng(32)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
    lengths = np.array([0, 5], np.int32)
    got = _port(q, k, k.copy(), lengths)
    assert not got[0].any()
    np.testing.assert_allclose(
        got, np.asarray(ops.decode_attention(q, k, k.copy(), lengths)), **TOL)
    kq, vq, ks, vs = _int8(rng, 2, 2, 8, 16)
    assert not _port_quant(q, kq, vq, ks, vs, lengths)[0].any()
