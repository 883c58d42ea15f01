"""The arithmetic of the int8 decode kernels, modelled in plain torch on the
CPU and held against the JAX Pallas kernels ``decode_attention_quant`` and
``paged_decode_attention_quant`` in interpret mode.

The CUDA kernels (``csrc/mma_attention.cuh``, ``Int8Layout`` and
``RowScales``; ``csrc/decode_mma.cuh``'s int8 sources) do not dequantize a
row before the products.  They convert each int8 value to bf16 (or f32)
unscaled, which is exact, multiply each key's scores by its k-scale and,
once the softmax has summed the probabilities into l, each key's
probabilities by its v-scale, and round those to bf16 for the P.V
product.  ``kernel_scheme`` below does the same in that order, and
``int8_via_magic`` repeats the kernel's bit-level conversion (the biased
byte as the low mantissa byte of 2^23).

Tolerance: the bf16 one, atol = rtol = 2e-2, as the card tests: q and the
scales are bf16 values on both sides, and the only rounding the scheme
adds to the reference's f32 is that of p * vs to bf16 (one bf16 ulp,
2^-8 relative).  The scales span 1e-8 to 10, log-uniform.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_quant
from repro.kernels.paged_decode_attention import paged_decode_attention_quant

TOL = dict(atol=2e-2, rtol=2e-2)


def int8_via_magic(x: np.ndarray) -> np.ndarray:
    """The kernel's int8 -> bf16 conversion, bit for bit: x + 128 as the
    low byte of the f32 2^23 + (x + 128), minus 2^23 + 128, then the top 16
    bits of that f32 as the bf16.  Returns the bf16 values as f32."""
    u = (x.view(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    return ((f.view(np.uint32) >> 16) << 16).view(np.float32)


def test_every_int8_value_is_exact_in_bf16():
    x = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    want = x.astype(np.float32)
    np.testing.assert_array_equal(int8_via_magic(x), want)
    np.testing.assert_array_equal(
        torch.from_numpy(x).to(torch.bfloat16).float().numpy(), want)


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as f32 (the values the card's bf16 holds)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def kernel_scheme(q, k, v, ks, vs, lengths):
    """The kernels' arithmetic on a dense (B, KVH, S, D) int8 cache: q and
    the scales bf16 values, k and v int8, lengths (B,) >= 1."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    qg = torch.from_numpy(q).reshape(B, KVH, H // KVH, D)
    kx = torch.from_numpy(int8_via_magic(k))
    vx = torch.from_numpy(int8_via_magic(v))
    s = torch.matmul(qg, kx.transpose(-1, -2))            # q . x_j, f32 sums
    s = s * torch.from_numpy(ks)[:, :, None, :]           # k-scale on scores
    live = torch.arange(S)[None, :] < torch.from_numpy(lengths)[:, None]
    s = s.masked_fill(~live[:, None, None, :], -math.inf)
    p = torch.exp((s - s.amax(-1, keepdim=True)) / math.sqrt(D))
    l = p.sum(-1, keepdim=True)                           # unscaled P into l
    pv = (p * torch.from_numpy(vs)[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.matmul(pv, vx) / l.clamp_min(1e-20)       # v-scale on P
    return out.reshape(B, H, D).numpy()


def _inputs(rng, B, H, KVH, S, D):
    q = _bf16(rng.standard_normal((B, H, D)).astype(np.float32))
    k, v = (rng.integers(-127, 128, size=(B, KVH, S, D)).astype(np.int8)
            for _ in range(2))
    ks, vs = (_bf16((10.0 ** rng.uniform(-8, 1, size=(B, KVH, S)))
                    .astype(np.float32)) for _ in range(2))
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = 1, S
    return q, k, v, ks, vs, lengths


@pytest.mark.parametrize("B,H,KVH,S,D", [(3, 8, 2, 40, 32), (2, 4, 4, 70, 16),
                                          (2, 16, 2, 33, 64)])
def test_scheme_matches_jax_dense(B, H, KVH, S, D):
    rng = np.random.default_rng(40)
    q, k, v, ks, vs, lengths = _inputs(rng, B, H, KVH, S, D)
    want = decode_attention_quant(*(jnp.asarray(a) for a in
                                    (q, k, v, ks, vs, lengths)),
                                  interpret=True)
    np.testing.assert_allclose(kernel_scheme(q, k, v, ks, vs, lengths),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("B,H,KVH,D,bs,nb", [(3, 8, 2, 32, 8, 5),
                                              (2, 16, 4, 64, 16, 3)])
def test_scheme_matches_jax_paged(B, H, KVH, D, bs, nb):
    """The same over int8 pages: the scheme runs on the pages gathered
    through the block table (sentinel ids past the live blocks)."""
    rng = np.random.default_rng(41)
    N = 2 * B * nb
    q, kp, vp, ksp, vsp, _ = _inputs(rng, N, H, KVH, bs, D)
    q = q[:B]
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    lengths = rng.integers(1, nb * bs + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = 1, nb * bs
    for b, n in enumerate(lengths):
        bt[b, -(-n // bs):] = N + 2
    want = paged_decode_attention_quant(
        *(jnp.asarray(a) for a in (q, kp, vp, ksp, vsp, bt, lengths)),
        interpret=True)

    def gather(pages):
        g = pages[np.clip(bt, 0, N - 1)]               # (B, nb, KVH, bs, ...)
        g = np.moveaxis(g, 2, 1)
        return g.reshape((B, KVH, nb * bs) + g.shape[4:])
    got = kernel_scheme(q, gather(kp), gather(vp), gather(ksp), gather(vsp),
                        lengths)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
