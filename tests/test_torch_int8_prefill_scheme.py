"""The arithmetic of the int8 paged prefill kernel, modelled in plain torch
on the CPU and held against the JAX Pallas kernel
``paged_prefill_attention_quant`` in interpret mode.

The CUDA kernel (``csrc/paged_prefill_attention.cu``, the ``Int8Prefix``
instance of ``prefill_mma_kernel``) runs the prefix through
``mma_attention.cuh``'s int8 key loop and then the chunk's float keys
through the float key loop, into one online softmax.  It does not
dequantize a prefix row before the products: it converts each int8 value
to bf16 (or f32) unscaled, which is exact, multiplies each prefix key's
scores by its k-scale and, once the softmax has summed the probabilities
into l, each prefix key's probabilities by its v-scale, and rounds those
to bf16 for the P.V product (bf16 scheme).  The chunk's keys are the
float projections, their probabilities rounded to bf16 as the float
kernel rounds them.  ``kernel_scheme`` below does the same in that order.

Tolerances: bf16 atol = rtol = 2e-2, as the card tests (q, the scales and
the chunk's k/v are bf16 values on both sides; the scheme adds only the
rounding of P (times a v-scale) to bf16, 2^-8 relative); f32 atol = rtol
= 1e-4, the card tests' f32 tolerance (the f32 scheme rounds nothing the
reference does not: its 3xTF32 products keep f32 accuracy).  The scales
span 1e-8 to 10, log-uniform.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_prefill_attention import \
    paged_prefill_attention_quant

from test_torch_int8_decode_scheme import int8_via_magic

torch.set_num_threads(2)
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),
       "float32": dict(atol=1e-4, rtol=1e-4)}


def _round(a: np.ndarray, scheme: str) -> np.ndarray:
    """``a`` as the values the scheme's dtype holds, in f32."""
    if scheme == "float32":
        return a.astype(np.float32)
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
        .float().numpy()


def _gather(pages: np.ndarray, bt: np.ndarray) -> np.ndarray:
    """(N, KVH, bs, ...) pages -> (B, KVH, nb * bs, ...) through the block
    table, sentinel ids clamped into the pool as the kernel clamps them."""
    g = pages[np.clip(bt, 0, pages.shape[0] - 1)]      # (B, nb, KVH, bs, ...)
    g = np.moveaxis(g, 2, 1)
    B, KVH, nb, bs = g.shape[:4]
    return g.reshape((B, KVH, nb * bs) + g.shape[4:])


def kernel_scheme(q, kp, vp, ksp, vsp, ck, cv, bt, starts, valid, scheme):
    """The kernel's arithmetic: q (B, H, C, D), int8 pages, scale pages,
    the chunk's float k/v, block table, starts and valid; every float
    input already holds values of the scheme's dtype.  Returns (B, H, C,
    D) f32; rows at or past valid[b] are garbage, as the kernel's."""
    B, H, C, D = q.shape
    KVH = kp.shape[1]
    G = H // KVH
    kx = torch.from_numpy(int8_via_magic(_gather(kp, bt)))  # exact, unscaled
    vx = torch.from_numpy(int8_via_magic(_gather(vp, bt)))
    ks = torch.from_numpy(_gather(ksp, bt))
    vs = torch.from_numpy(_gather(vsp, bt))
    S = kx.shape[2]
    qg = torch.from_numpy(q).reshape(B, KVH, G, C, D)
    # prefix: s_j = ks_j (q . x_j), every live position visible to all rows
    s_pre = torch.matmul(qg, kx[:, :, None].transpose(-1, -2))
    s_pre = s_pre * ks[:, :, None, None, :]
    live = torch.arange(S)[None, :] < torch.from_numpy(starts)[:, None]
    s_pre = s_pre.masked_fill(~live[:, None, None, None, :], -math.inf)
    # chunk: the float keys, causal and below valid
    s_chk = torch.matmul(qg, torch.from_numpy(ck)[:, :, None]
                         .transpose(-1, -2))
    c = torch.arange(C)
    vis = (c[None, :] <= c[:, None])[None] \
        & (c[None, None, :] < torch.from_numpy(valid)[:, None, None])
    s_chk = s_chk.masked_fill(~vis[:, None, None], -math.inf)
    # one online softmax over both segments (scores in raw units)
    s = torch.cat([s_pre, s_chk], dim=-1)
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)      # a row with no key
    p = torch.exp((s - m) / math.sqrt(D))
    l = p.sum(-1, keepdim=True)                        # unscaled P into l
    p_pre = p[..., :S] * vs[:, :, None, None, :]       # v-scale on P
    p_chk = p[..., S:]
    if scheme == "bfloat16":                           # P rounded for P.V
        p_pre = p_pre.to(torch.bfloat16).float()
        p_chk = p_chk.to(torch.bfloat16).float()
    out = (torch.matmul(p_pre, vx[:, :, None])
           + torch.matmul(p_chk, torch.from_numpy(cv)[:, :, None]))
    return (out / l.clamp_min(1e-20)).reshape(B, H, C, D).numpy()


def _case(rng, *, B, H, KVH, C, D, bs, nb, scheme):
    """q, int8 pages, scale pages (1e-8 .. 10, log-uniform), the chunk's
    k/v and a block table of distinct pages; float values rounded to the
    scheme's dtype."""
    N = 2 * B * nb
    q, ck, cv = (_round(rng.standard_normal(shape), scheme) for shape in
                 ((B, H, C, D), (B, KVH, C, D), (B, KVH, C, D)))
    kp, vp = (rng.integers(-127, 128, size=(N, KVH, bs, D)).astype(np.int8)
              for _ in range(2))
    ksp, vsp = (_round(10.0 ** rng.uniform(-8, 1, size=(N, KVH, bs)), scheme)
                for _ in range(2))
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    return q, kp, vp, ksp, vsp, ck, cv, bt


# (bs, H, KVH, C, D, starts, valid): an empty prefix, starts inside a
# page and off the 64-key tile edge (63, 65, 100), a page-aligned prefix
# (2 bs), valid == 0 and partial chunks; GQA groups 1, 2 and 4
CASES = [
    (8, 4, 2, 16, 32, [0, 19, 16, 11, 5], [16, 16, 5, 0, 13]),
    (16, 4, 4, 8, 16, [63, 65, 0, 100], [8, 3, 8, 0]),
    (8, 8, 2, 24, 32, [64, 2, 40], [24, 0, 17]),
]


@pytest.mark.parametrize("scheme", ["bfloat16", "float32"])
@pytest.mark.parametrize("bs,H,KVH,C,D,starts,valid", CASES)
def test_scheme_matches_jax(scheme, bs, H, KVH, C, D, starts, valid):
    rng = np.random.default_rng(42)
    starts = np.asarray(starts, np.int32)
    valid = np.asarray(valid, np.int32)
    B = len(starts)
    nb = -(-(int(starts.max()) + C) // bs)
    q, kp, vp, ksp, vsp, ck, cv, bt = _case(rng, B=B, H=H, KVH=KVH, C=C,
                                            D=D, bs=bs, nb=nb, scheme=scheme)
    N = kp.shape[0]
    # sentinel ids past each sequence's live blocks (and one past the
    # pool): the kernel clamps them and masks their keys
    for b, s in enumerate(starts):
        bt[b, -(-int(s) // bs):] = N + 2
    want = paged_prefill_attention_quant(
        *(jnp.asarray(a) for a in (q, kp, vp, ksp, vsp, ck, cv, bt, starts,
                                   valid)), interpret=True)
    got = kernel_scheme(q, kp, vp, ksp, vsp, ck, cv, bt, starts, valid,
                        scheme)
    want = np.asarray(want)
    for b, n in enumerate(valid):
        np.testing.assert_allclose(got[b, :, :n], want[b, :, :n],
                                   **TOL[scheme])


def test_scales_reach_scores_before_the_softmax_and_values_after():
    """The scheme is the dequantized attention: scaling scores by ks and P
    by vs (after l) equals attending over x * scale rows, in f32 (values
    up to 1270, so a few f32 ulps of the sums reach 3e-4: the f32
    tolerance)."""
    rng = np.random.default_rng(43)
    B, H, KVH, C, D, bs, nb = 2, 4, 2, 8, 16, 8, 3
    q, kp, vp, ksp, vsp, ck, cv, bt = _case(rng, B=B, H=H, KVH=KVH, C=C,
                                            D=D, bs=bs, nb=nb,
                                            scheme="float32")
    starts = np.array([20, 9], np.int32)
    valid = np.array([8, 5], np.int32)
    got = kernel_scheme(q, kp, vp, ksp, vsp, ck, cv, bt, starts, valid,
                        "float32")
    k = _gather(kp, bt).astype(np.float32) * _gather(ksp, bt)[..., None]
    v = _gather(vp, bt).astype(np.float32) * _gather(vsp, bt)[..., None]
    qg = q.reshape(B, KVH, H // KVH, C, D)
    keys = np.concatenate([k, ck], axis=2)[:, :, None]
    vals = np.concatenate([v, cv], axis=2)[:, :, None]
    s = np.einsum("bkgcd,bkgsd->bkgcs", qg, keys) / math.sqrt(D)
    S = k.shape[2]
    c = np.arange(C)
    vis = np.concatenate([
        np.broadcast_to((np.arange(S)[None, :] < starts[:, None])[:, None],
                        (B, C, S)),
        (c[None, :] <= c[:, None])[None] & (c[None, None, :]
                                            < valid[:, None, None])], -1)
    s = np.where(vis[:, None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bkgcs,bkgsd->bkgcd", p / p.sum(-1, keepdims=True),
                     vals).reshape(B, H, C, D)
    for b, n in enumerate(valid):
        np.testing.assert_allclose(got[b, :, :n], want[b, :, :n],
                                   **TOL["float32"])
