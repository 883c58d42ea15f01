"""The port's paged decode attention (``repro_torch.kernels
.paged_decode_attention``; on CPU tensors its plain versions) against the
JAX Pallas kernels in interpret mode and the dense oracle, on the same
numpy inputs: multi-page sequences, GQA groups, length 1 and sentinel
blocks (mirrors ``tests/test_kernels.py``), for the float kernel and its
int8 twin.

Tolerance: float32, atol = rtol = 2e-5, as the reference kernel tests.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.paged_decode_attention import paged_decode_attention_quant
from repro_torch.kernels import paged_decode_attention as pda

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _paged_from_dense(k, v, bs, N, rng):
    """Scatter dense (B, KVH, S, D) k/v into a pool of N random pages."""
    B, KVH, S, D = k.shape
    nb = S // bs
    perm = rng.permutation(N)[:B * nb].reshape(B, nb)
    kp = rng.standard_normal((N, KVH, bs, D)).astype(np.float32)
    vp = rng.standard_normal((N, KVH, bs, D)).astype(np.float32)
    for b in range(B):
        for i in range(nb):
            kp[perm[b, i]] = k[b, :, i * bs:(i + 1) * bs]
            vp[perm[b, i]] = v[b, :, i * bs:(i + 1) * bs]
    return kp, vp, perm.astype(np.int32)


def _port(*arrays):
    before = pda.launches
    out = pda.paged_decode_attention(*[torch.from_numpy(a) for a in arrays])
    assert pda.launches == before        # CPU tensors: the plain version
    return out.numpy()


@pytest.mark.parametrize("B,H,KVH,S,D,bs", [
    (2, 8, 2, 64, 32, 16),
    (3, 4, 4, 40, 16, 8),
    (1, 6, 1, 24, 64, 4),
    (4, 32, 8, 96, 64, 16),
])
def test_paged_decode_matches_jax(B, H, KVH, S, D, bs):
    rng = np.random.default_rng(10)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    kp, vp, bt = _paged_from_dense(k, v, bs, 4 * B * (S // bs), rng)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    lengths[0] = 1
    got = _port(q, kp, vp, bt, lengths)
    np.testing.assert_allclose(
        got, np.asarray(ops.paged_decode_attention(q, kp, vp, bt, lengths)),
        **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.decode_attention_ref(q, k, v, lengths)), **TOL)


def test_paged_decode_sentinel_blocks_ignored():
    """Blocks past ``lengths`` may hold sentinel ids (>= pool size)."""
    rng = np.random.default_rng(11)
    B, H, KVH, S, D, bs = 2, 4, 2, 32, 16, 8
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    kp, vp, bt = _paged_from_dense(k, v, bs, 16, rng)
    lengths = np.array([7, 9], np.int32)   # needs 1 / 2 pages only
    bt_sent = bt.copy()
    bt_sent[0, 1:] = 16
    bt_sent[1, 2:] = 16 + 5
    got = _port(q, kp, vp, bt_sent, lengths)
    np.testing.assert_allclose(got, _port(q, kp, vp, bt, lengths), atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(ops.paged_decode_attention(q, kp, vp, bt_sent,
                                                   lengths)), **TOL)


def test_paged_decode_empty_row_is_zero():
    """A row with no valid key returns 0, as the Pallas kernel does."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kp = rng.standard_normal((4, 2, 8, 16)).astype(np.float32)
    bt = np.array([[0, 1], [2, 3]], np.int32)
    lengths = np.array([0, 5], np.int32)
    got = _port(q, kp, kp.copy(), bt, lengths)
    assert not got[0].any()
    np.testing.assert_allclose(
        got, np.asarray(ops.paged_decode_attention(q, kp, kp.copy(), bt,
                                                   lengths)), **TOL)


def test_mixed_devices_refused():
    q = torch.zeros(1, 2, 8)
    pages = torch.zeros(2, 1, 4, 8, device="meta")
    bt = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        pda.paged_decode_attention(q, pages, pages, bt,
                                   torch.ones(1, dtype=torch.int32))


def _quant_pool(rng, N, KVH, bs, D):
    """Random int8 pages (k, v) and their f32 per-row scales."""
    kq, vq = (rng.integers(-127, 128, size=(N, KVH, bs, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((N, KVH, bs)) * 0.1 + 1e-3).astype(np.float32)
              for _ in range(2))
    return kq, vq, ks, vs


def _port_quant(*arrays):
    before = pda.quant_launches
    out = pda.paged_decode_attention_quant(*[torch.from_numpy(a)
                                             for a in arrays])
    assert pda.quant_launches == before  # CPU tensors: the plain version
    return out.numpy()


@pytest.mark.parametrize("B,H,KVH,D,bs,nb", [
    (3, 8, 2, 32, 8, 6),
    (2, 4, 4, 16, 16, 3),
    (4, 32, 8, 64, 16, 4),
])
def test_paged_decode_quant_matches_jax(B, H, KVH, D, bs, nb):
    """int8 pages with scale pages against the Pallas int8 kernel
    (interpret mode), including a length-1 row, a full table and sentinel
    blocks past the live ones."""
    rng = np.random.default_rng(13)
    N = 2 * B * nb
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kq, vq, ks, vs = _quant_pool(rng, N, KVH, bs, D)
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    lengths = rng.integers(1, nb * bs + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = 1, nb * bs
    for b, n in enumerate(lengths):
        bt[b, -(-n // bs):] = N + 2
    got = _port_quant(q, kq, vq, ks, vs, bt, lengths)
    want = paged_decode_attention_quant(q, kq, vq, ks, vs, bt, lengths,
                                        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the same int8 content through the float kernel: one length convention
    kf = (kq.astype(np.float32) * ks[..., None])
    vf = (vq.astype(np.float32) * vs[..., None])
    np.testing.assert_allclose(got, _port(q, kf, vf, bt, lengths), **TOL)


def test_paged_decode_quant_empty_row_is_zero():
    rng = np.random.default_rng(14)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kq, vq, ks, vs = _quant_pool(rng, 4, 2, 8, 16)
    bt = np.array([[0, 1], [2, 3]], np.int32)
    got = _port_quant(q, kq, vq, ks, vs, bt, np.array([0, 9], np.int32))
    assert not got[0].any() and got[1].any()
