"""The port's paged prefill-chunk attention (``repro_torch.kernels
.paged_prefill_attention``; on CPU tensors its plain version) against the
JAX Pallas kernel in interpret mode and its gather oracle, on the same
numpy inputs: the first chunk (empty prefix), a chunk start straddling a
page edge, a page-aligned prefix, ``valid == 0`` rows, partial chunks, a
chunk of 256 and sentinel blocks (mirrors
``tests/test_paged_prefill_kernel.py``), and the int8 twin over int8
prefix pages with float in-chunk keys.  Rows past ``valid`` are garbage
on both sides and are not compared.

Tolerance: float32, atol = rtol = 2e-5, as the reference kernel tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import paged_prefill_attention as ppa

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _case(rng, *, B, H, KVH, C, D, bs, nb):
    N = 4 * B * nb
    q = rng.standard_normal((B, H, C, D)).astype(np.float32)
    kp = rng.standard_normal((N, KVH, bs, D)).astype(np.float32)
    vp = rng.standard_normal((N, KVH, bs, D)).astype(np.float32)
    ck = rng.standard_normal((B, KVH, C, D)).astype(np.float32)
    cv = rng.standard_normal((B, KVH, C, D)).astype(np.float32)
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    return q, kp, vp, ck, cv, bt


def _port(*arrays):
    before = ppa.launches
    out = ppa.paged_prefill_attention(*[torch.from_numpy(a) for a in arrays])
    assert ppa.launches == before        # CPU tensors: the plain version
    return out.numpy()


def _assert_valid_rows_close(got, want, valid):
    for b, n in enumerate(valid):
        np.testing.assert_allclose(got[b, :, :n], np.asarray(want)[b, :, :n],
                                   **TOL)


@pytest.mark.parametrize("bs,H,KVH", [(8, 4, 2), (16, 8, 1), (16, 4, 4)])
def test_paged_prefill_matches_jax_across_chunk_boundaries(bs, H, KVH):
    rng = np.random.default_rng(20)
    C, nb = 16, 6
    st = np.array([0, 19 if bs == 8 else 21, 2 * bs, 11, 0], np.int32)
    vd = np.array([C, C, 5, 0, 3], np.int32)
    arrays = _case(rng, B=5, H=H, KVH=KVH, C=C, D=32, bs=bs, nb=nb)
    got = _port(*arrays, st, vd)
    _assert_valid_rows_close(
        got, ops.paged_prefill_attention(*arrays, st, vd), vd)
    _assert_valid_rows_close(
        got, ref.paged_prefill_attention_ref(jnp.asarray(arrays[0]),
                                             *arrays[1:], st, vd), vd)


def test_paged_prefill_long_chunk_matches_jax():
    """A chunk of 256 queries (several q tiles in the TPU kernel)."""
    rng = np.random.default_rng(30)
    C, bs = 256, 8
    nb = (40 + C + bs - 1) // bs + 1
    st = np.array([40, 7, 0], np.int32)
    vd = np.array([C, C - 77, 0], np.int32)
    arrays = _case(rng, B=3, H=4, KVH=2, C=C, D=32, bs=bs, nb=nb)
    got = _port(*arrays, st, vd)
    _assert_valid_rows_close(
        got, ops.paged_prefill_attention(*arrays, st, vd), vd)


def test_paged_prefill_sentinel_blocks_ignored():
    """Blocks at or past the prefix may hold sentinel ids."""
    rng = np.random.default_rng(23)
    q, kp, vp, ck, cv, bt = _case(rng, B=1, H=2, KVH=2, C=8, D=16, bs=8,
                                  nb=4)
    st, vd = np.array([11], np.int32), np.array([8], np.int32)
    bt_sent = bt.copy()
    bt_sent[0, 2:] = kp.shape[0] + 7
    got = _port(q, kp, vp, ck, cv, bt_sent, st, vd)
    np.testing.assert_allclose(got, _port(q, kp, vp, ck, cv, bt, st, vd),
                               atol=1e-6)
    _assert_valid_rows_close(
        got, ops.paged_prefill_attention(q, kp, vp, ck, cv, bt_sent, st, vd),
        vd)


def test_paged_prefill_matches_full_causal_attention():
    """Chunk row c equals row start + c of plain causal attention over
    [prefix ; chunk] when the prefix lives in pages."""
    rng = np.random.default_rng(21)
    B, H, KVH, C, D, bs, nb, start = 1, 4, 2, 8, 16, 8, 4, 13
    L = start + C
    k_full = rng.standard_normal((B, KVH, L, D)).astype(np.float32)
    v_full = rng.standard_normal((B, KVH, L, D)).astype(np.float32)
    q_full = rng.standard_normal((B, H, L, D)).astype(np.float32)
    kp = rng.standard_normal((8, KVH, bs, D)).astype(np.float32)
    vp = rng.standard_normal((8, KVH, bs, D)).astype(np.float32)
    bt = rng.permutation(8)[:nb].reshape(1, nb).astype(np.int32)
    for p in range(start):
        kp[bt[0, p // bs], :, p % bs] = k_full[0, :, p]
        vp[bt[0, p // bs], :, p % bs] = v_full[0, :, p]
    got = _port(np.ascontiguousarray(q_full[:, :, start:]), kp, vp,
                np.ascontiguousarray(k_full[:, :, start:]),
                np.ascontiguousarray(v_full[:, :, start:]), bt,
                np.array([start], np.int32), np.array([C], np.int32))
    want = ref.flash_attention_ref(jnp.asarray(q_full), k_full, v_full,
                                   causal=True)[:, :, start:]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _port_quant(*arrays):
    before = ppa.quant_launches
    out = ppa.paged_prefill_attention_quant(*[torch.from_numpy(a)
                                              for a in arrays])
    assert ppa.quant_launches == before  # CPU tensors: the plain version
    return out.numpy()


@pytest.mark.parametrize("bs,H,KVH,C,D", [(8, 4, 2, 16, 32),
                                           (16, 8, 1, 32, 16),
                                           (8, 4, 4, 48, 32)])
def test_paged_prefill_quant_matches_jax(bs, H, KVH, C, D):
    """int8 prefix pages with scale pages and float in-chunk keys against
    the Pallas int8 kernel (interpret mode) and its gather oracle: the
    first chunk, a start inside a page, a page-aligned prefix, valid == 0
    and a partial chunk."""
    rng = np.random.default_rng(24)
    B = 5
    nb = -(-(2 * bs + 19 + C) // bs)
    q, _, _, ck, cv, bt = _case(rng, B=B, H=H, KVH=KVH, C=C, D=D, bs=bs,
                                nb=nb)
    N = 4 * B * nb
    kq, vq = (rng.integers(-127, 128, size=(N, KVH, bs, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((N, KVH, bs)) * 0.1 + 1e-3).astype(np.float32)
              for _ in range(2))
    st = np.array([0, 19, 2 * bs, 11, 5], np.int32)
    vd = np.array([C, C, 5, 0, C - 3], np.int32)
    got = _port_quant(q, kq, vq, ks, vs, ck, cv, bt, st, vd)
    _assert_valid_rows_close(
        got, ops.paged_prefill_attention_quant(q, kq, vq, ks, vs, ck, cv, bt,
                                               st, vd, interpret=True), vd)
    _assert_valid_rows_close(
        got, ref.paged_prefill_attention_quant_ref(
            jnp.asarray(q), kq, vq, ks, vs, ck, cv, bt, st, vd), vd)
    # the chunk's keys enter as given (float), not through the int8 pages
    kf = kq.astype(np.float32) * ks[..., None]
    vf = vq.astype(np.float32) * vs[..., None]
    _assert_valid_rows_close(got, _port(q, kf, vf, ck, cv, bt, st, vd), vd)
