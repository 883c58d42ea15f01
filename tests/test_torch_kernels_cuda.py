"""The port's CUDA kernels (paged decode, paged prefill, dense decode, each
in float and int8-KV variants, flash attention with its autograd Function,
and the SSD scan) against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); skips elsewhere.  Imports no JAX,
so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: float32 atol = rtol = 1e-4 (the kernels sum the dot products
and the softmax in another order than cuBLAS, the tensor-core ones as
3xTF32 products; measured errors sit near 1e-6 to 5e-6); bfloat16 atol =
rtol = 2e-2 (both sides accumulate in f32 from the same bf16 inputs and
round the output to bf16, one ulp of which is 2^-8 near 1; the
tensor-core kernels also round the probabilities to bf16).  The SSD scan
in float32 is held to atol = rtol = 5e-4, the JAX kernel test's own
tolerance: its sums run over up to 128 + 64 terms of unit-normal inputs,
and at L 2048 one element of 3.1 M that nearly cancels differed by
1.03e-4 (measured on an H100).  Its final state is f32 whatever x's dtype
and held to that tolerance too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.kernels import ssd_scan as ss

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
SSD_TOL = {torch.float32: dict(atol=5e-4, rtol=5e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pool(rng, N, KVH, bs, D, dtype, dev):
    k = rng.standard_normal((N, KVH, bs, D)).astype(np.float32)
    v = rng.standard_normal((N, KVH, bs, D)).astype(np.float32)
    return (torch.tensor(k, dtype=dtype, device=dev),
            torch.tensor(v, dtype=dtype, device=dev))


def _table(rng, B, nb, N, live_blocks, dev):
    """Distinct random pages for the live blocks, sentinel N + 3 after."""
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    for b, n in enumerate(live_blocks):
        bt[b, n:] = N + 3
    return torch.tensor(bt, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,bs", [(32, 8, 64, 16), (4, 4, 64, 8),
                                         (6, 2, 128, 16), (8, 1, 32, 4)])
def test_paged_decode_kernel_matches_plain(dev, dtype, H, KVH, D, bs):
    rng = np.random.default_rng(0)
    lengths = np.array([1, bs, bs + 1, 5 * bs + 3, 100, 0], np.int32)
    B, nb = len(lengths), 8
    N = 4 * B * nb
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=dtype, device=dev)
    kp, vp = _pool(rng, N, KVH, bs, D, dtype, dev)
    bt = _table(rng, B, nb, N, [-(-int(n) // bs) for n in lengths], dev)
    ln = torch.tensor(np.minimum(lengths, nb * bs), device=dev)
    before = pda.launches
    out = pda.paged_decode_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert pda.launches == before + 1
    want = pda.paged_decode_attention_plain(q, kp, vp, bt, ln)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    assert torch.count_nonzero(out[-1]) == 0       # no valid key -> 0


# (H, KVH, D, bs, C, starts, valid, q scale); starts/valid None: the first
# cases' rows (an empty prefix, prefixes past and inside pages, a valid ==
# 0 row).  Then the tensor-core kernel's edges: prefixes of 63, 64, 65,
# 127 and 128 tokens around its 64-key tiles, prefixes ending mid-page in
# 8- and 16-token pages, chunks of 1, 15, 17, 100 and 129 positions, GQA
# groups of 1, 3, 4, 8 and 64, head_dim 16, 80 and 128 (and 17, whose rows
# the loader copies element by element), and q scaled so that scores reach
# about +-30 (3xTF32's residual term carries f32 there).
# Rows past a table's live blocks hold the sentinel N + 3.
PREFILL_CASES = [
    (32, 8, 64, 16, 16, None, None, 1.0),
    (32, 8, 64, 16, 128, None, None, 1.0),
    (32, 8, 64, 16, 512, None, None, 1.0),
    (6, 2, 128, 16, 100, None, None, 1.0),
    (4, 4, 32, 8, 64, None, None, 1.0),
    (32, 8, 64, 16, 64, [63, 64, 65, 127, 128], [64, 64, 40, 64, 1], 1.0),
    (12, 4, 80, 8, 17, [5, 13, 70, 0], [17, 9, 17, 0], 1.0),
    (4, 4, 16, 16, 15, [7, 30, 100], [15, 15, 8], 1.0),
    (32, 4, 128, 16, 1, [0, 1, 65, 300], [1, 1, 1, 0], 1.0),
    (8, 2, 128, 16, 129, [0, 64, 191], [129, 100, 129], 1.0),
    (4, 4, 80, 8, 100, [63, 64, 65], [100, 37, 64], 1.0),
    (64, 1, 64, 16, 17, [16, 40], [17, 3], 1.0),
    (8, 2, 17, 8, 40, [70, 3], [40, 25], 1.0),     # rows not 16-byte wide
    (32, 8, 64, 16, 128, [127, 0, 64], [128, 128, 90], 8.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,bs,C,starts,valid,qscale", PREFILL_CASES)
def test_paged_prefill_kernel_matches_plain(dev, dtype, H, KVH, D, bs, C,
                                            starts, valid, qscale):
    rng = np.random.default_rng(1)
    starts = np.array([0, 21, 2 * bs, 300, 7] if starts is None else starts,
                      np.int32)
    valid = np.array([C, C, C // 2 + 3, 0, C - 5] if valid is None
                     else valid, np.int32)
    B = len(starts)
    nb = -(-(int(starts.max()) + C) // bs)
    N = 2 * B * nb
    q = torch.tensor(rng.standard_normal((B, H, C, D)) * qscale, dtype=dtype,
                     device=dev)
    ck = torch.tensor(rng.standard_normal((B, KVH, C, D)), dtype=dtype,
                      device=dev)
    cv = torch.tensor(rng.standard_normal((B, KVH, C, D)), dtype=dtype,
                      device=dev)
    kp, vp = _pool(rng, N, KVH, bs, D, dtype, dev)
    bt = _table(rng, B, nb, N, [-(-int(s) // bs) for s in starts], dev)
    st = torch.tensor(starts, device=dev)
    vd = torch.tensor(valid, device=dev)
    before = ppa.launches
    out = ppa.paged_prefill_attention(q, kp, vp, ck, cv, bt, st, vd)
    torch.cuda.synchronize()
    assert ppa.launches == before + 1
    want = ppa.paged_prefill_attention_plain(q, kp, vp, ck, cv, bt, st, vd)
    for b, n in enumerate(valid):
        torch.testing.assert_close(out[b, :, :n].float(),
                                   want[b, :, :n].float(), **TOL[dtype])
        if n == 0:                       # an inactive row reads nothing
            assert torch.count_nonzero(out[b]) == 0


def _int8_rows(rng, shape, dtype, dev):
    """int8 k and v rows of ``shape`` (..., D) and their per-row scales."""
    rows = [torch.tensor(rng.integers(-127, 128, size=shape), dtype=torch.int8,
                         device=dev) for _ in range(2)]
    scales = [torch.tensor(rng.random(shape[:-1]) * 0.05 + 1e-3, dtype=dtype,
                           device=dev) for _ in range(2)]
    return rows + scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,bs", [(32, 8, 64, 16), (32, 8, 80, 16),
                                         (6, 2, 128, 16), (8, 1, 32, 4)])
def test_paged_decode_quant_kernel_matches_plain(dev, dtype, H, KVH, D, bs):
    rng = np.random.default_rng(3)
    lengths = np.array([1, bs, bs + 1, 5 * bs + 3, 100, 0], np.int32)
    B, nb = len(lengths), 8
    N = 4 * B * nb
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=dtype, device=dev)
    kq, vq, ks, vs = _int8_rows(rng, (N, KVH, bs, D), dtype, dev)
    bt = _table(rng, B, nb, N, [-(-int(n) // bs) for n in lengths], dev)
    ln = torch.tensor(np.minimum(lengths, nb * bs), device=dev)
    before = pda.quant_launches
    out = pda.paged_decode_attention_quant(q, kq, vq, ks, vs, bt, ln)
    torch.cuda.synchronize()
    assert pda.quant_launches == before + 1
    want = pda.paged_decode_attention_quant_plain(q, kq, vq, ks, vs, bt, ln)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    assert torch.count_nonzero(out[-1]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,bs,C", [(32, 8, 64, 16, 32),
                                           (32, 8, 80, 16, 128),
                                           (6, 2, 128, 16, 100)])
def test_paged_prefill_quant_kernel_matches_plain(dev, dtype, H, KVH, D, bs,
                                                  C):
    rng = np.random.default_rng(4)
    starts = np.array([0, 21, 2 * bs, 300, 7], np.int32)
    valid = np.array([C, C, C // 2 + 3, 0, C - 5], np.int32)
    B = len(starts)
    nb = -(-(int(starts.max()) + C) // bs)
    N = 2 * B * nb
    q = torch.tensor(rng.standard_normal((B, H, C, D)), dtype=dtype, device=dev)
    ck, cv = (torch.tensor(rng.standard_normal((B, KVH, C, D)), dtype=dtype,
                           device=dev) for _ in range(2))
    kq, vq, ks, vs = _int8_rows(rng, (N, KVH, bs, D), dtype, dev)
    bt = _table(rng, B, nb, N, [-(-int(s) // bs) for s in starts], dev)
    st = torch.tensor(starts, device=dev)
    vd = torch.tensor(valid, device=dev)
    before = ppa.quant_launches
    out = ppa.paged_prefill_attention_quant(q, kq, vq, ks, vs, ck, cv, bt, st,
                                            vd)
    torch.cuda.synchronize()
    assert ppa.quant_launches == before + 1
    want = ppa.paged_prefill_attention_quant_plain(q, kq, vq, ks, vs, ck, cv,
                                                   bt, st, vd)
    for b, n in enumerate(valid):
        torch.testing.assert_close(out[b, :, :n].float(),
                                   want[b, :, :n].float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,KVH,D,S", [(32, 8, 64, 129), (32, 8, 80, 65),
                                        (6, 2, 128, 300), (8, 1, 32, 7)])
def test_decode_kernels_match_plain(dev, dtype, quant, H, KVH, D, S):
    """Dense decode: lengths 0, 1, S (the full slot) and in between; the
    tail past lengths is masked, S need not be a tile multiple."""
    rng = np.random.default_rng(5)
    lengths = np.array([1, S, 0, S // 2 + 1, max(S - 3, 1)], np.int32)
    B = len(lengths)
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=dtype, device=dev)
    ln = torch.tensor(lengths, device=dev)
    if quant:
        args = (q, *_int8_rows(rng, (B, KVH, S, D), dtype, dev), ln)
        fn, plain, name = (da.decode_attention_quant,
                           da.decode_attention_quant_plain, "quant_launches")
    else:
        args = (q, *(torch.tensor(rng.standard_normal((B, KVH, S, D)),
                                  dtype=dtype, device=dev)
                     for _ in range(2)), ln)
        fn, plain, name = (da.decode_attention, da.decode_attention_plain,
                           "launches")
    before = getattr(da, name)
    out = fn(*args)
    torch.cuda.synchronize()
    assert getattr(da, name) == before + 1
    torch.testing.assert_close(out.float(), plain(*args).float(), **TOL[dtype])
    assert torch.count_nonzero(out[2]) == 0


# The split-KV float decode kernels over caps of 2048 keys a sequence
# (splits > 1): lengths 0 and 1, the split edges at multiples of 256 (and
# 1025, whose last split holds one key) +-1, the cap, above the cap; one
# or many splits in one batch; GQA groups 1, 4, 8, 64 at head_dim 64, 80
# and 128; in the page pool, sentinel ids (>= N, and -1) among the live
# blocks, inside a split, which both versions clamp into the pool.
SPLIT_CAP, SPLIT_BS = 2048, 16
SPLIT_LENGTHS = [0, 1, 255, 256, 257, 511, 1023, 1024, 1025, 2047, 2048,
                 2100]


def _split_case(kind, rng, dtype, dev, H, KVH, D, lengths):
    """(wrapper, plain version, args) of the float ``kind`` decode kernel
    ("paged" or "dense") over SPLIT_CAP keys a sequence."""
    B = len(lengths)
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=dtype, device=dev)
    ln = torch.tensor(np.asarray(lengths, np.int32), device=dev)
    if kind == "dense":
        k, v = (torch.tensor(rng.standard_normal((B, KVH, SPLIT_CAP, D)),
                             dtype=dtype, device=dev) for _ in range(2))
        return da.decode_attention, da.decode_attention_plain, (q, k, v, ln)
    nb = SPLIT_CAP // SPLIT_BS
    N = B * nb
    kp, vp = _pool(rng, N, KVH, SPLIT_BS, D, dtype, dev)
    bt = _table(rng, B, nb, N, [nb] * B, dev)
    bt[1, 20] = N + 3                  # inside a split of a live sequence
    bt[-2, 40:42] = -1
    bt[-1, 127] = N
    return (pda.paged_decode_attention, pda.paged_decode_attention_plain,
            (q, kp, vp, bt, ln))


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 8, 64])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_split_decode_kernels_match_plain(dev, kind, dtype, G, D):
    rng = np.random.default_rng(11)
    KVH = 2
    fn, plain, args = _split_case(kind, rng, dtype, dev, G * KVH, KVH, D,
                                  SPLIT_LENGTHS)
    plan = common.decode_plan(len(SPLIT_LENGTHS), G * KVH, KVH, SPLIT_CAP, D,
                              dtype)
    assert plan.splits >= 5                   # long sequences use several
    mod = pda if kind == "paged" else da
    before = mod.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1         # one count, whatever splits
    torch.testing.assert_close(out.float(), plain(*args).float(),
                               **TOL[dtype])
    assert torch.count_nonzero(out[0]) == 0   # no valid key -> 0
    # every merging CTA reset its arrival counter
    assert torch.count_nonzero(common.split_tickets(out.device, 1)) == 0


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_replays_in_a_cuda_graph(dev, kind, dtype):
    """The split count is fixed when the call is captured; each replay
    reads the lengths then in the buffer (0, the cap, and in between)."""
    rng = np.random.default_rng(12)
    fn, plain, args = _split_case(kind, rng, dtype, dev, 32, 8, 64,
                                  [SPLIT_CAP] * 4)
    ln = args[-1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for lengths in ([0, 0, 0, 0], [SPLIT_CAP] * 4, [1, 257, 1025, 5000],
                    rng.integers(0, SPLIT_CAP + 1, size=4), [0, 2048, 0, 64]):
        ln.copy_(torch.tensor(np.asarray(lengths, np.int32), device=dev))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), plain(*args).float(),
                                   **TOL[dtype])
        assert torch.count_nonzero(common.split_tickets(out.device, 1)) == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(2)
    q = torch.randn(2, 4, 64, device=dev)
    kp, vp = _pool(rng, 8, 2, 16, 64, torch.float32, dev)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    ln = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        pda.paged_decode_attention(q.half(), kp.half(), vp.half(), bt, ln)
    with pytest.raises(TypeError):
        pda.paged_decode_attention(q, kp, vp, bt.long(), ln)
    with pytest.raises(ValueError):
        pda.paged_decode_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), kp, vp, bt, ln)
    with pytest.raises(ValueError):
        pda.paged_decode_attention(q.cpu(), kp, vp, bt, ln)
    kq = torch.zeros(2, 2, 16, 64, dtype=torch.int8, device=dev)
    ks = torch.ones(2, 2, 16, device=dev)
    with pytest.raises(TypeError):         # pages must be int8
        da.decode_attention_quant(q, kq.float(), kq, ks, ks, ln)
    with pytest.raises(TypeError):         # scales in q's dtype
        da.decode_attention_quant(q, kq, kq, ks.bfloat16(), ks, ln)
    with pytest.raises(ValueError):
        da.decode_attention_quant(q, kq, kq, ks[:, :, :8], ks, ln)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,Lq,Lkv,D,window,qscale", [
    (2, 32, 8, 512, 512, 64, None, 1.0),    # granite's widths
    (1, 32, 8, 200, 200, 80, 17, 1.0),      # h2o-danube's head_dim, a window
    (2, 8, 2, 100, 100, 128, None, 1.0),    # D 128, not a tile multiple
    (1, 4, 1, 33, 65, 16, None, 1.0),       # MQA, Lq < Lkv
    (2, 4, 2, 80, 80, 32, 8, 1.0),
    (2, 4, 2, 80, 80, 32, 64, 1.0),
    # the tensor-core kernel's edges: Lq 1, 15, 17, 100 and 129 around its
    # 64-key tiles, groups of 1, 3, 4, 8 and 64, D 16, 80 and 128, window
    # edges inside a 64-key tile, rows past Lkv + window that see no key
    # (exact zeros), scores reaching about +-30 (3xTF32's residual term)
    (1, 4, 4, 1, 1, 64, None, 1.0),
    (2, 12, 4, 15, 15, 80, None, 1.0),
    (1, 8, 1, 17, 17, 128, None, 1.0),
    (2, 16, 4, 129, 129, 16, None, 1.0),
    (1, 3, 1, 100, 100, 80, 40, 1.0),
    (1, 8, 8, 300, 300, 64, 100, 1.0),
    (1, 64, 1, 70, 70, 32, None, 1.0),
    (1, 4, 2, 100, 40, 32, 8, 1.0),
    (2, 8, 2, 90, 90, 17, 33, 1.0),         # rows not 16-byte wide
    (2, 32, 8, 256, 256, 64, None, 8.0),
    (1, 32, 8, 129, 129, 80, 33, 8.0)])
def test_flash_kernel_matches_plain(dev, dtype, B, H, KVH, Lq, Lkv, D,
                                    window, qscale):
    rng = np.random.default_rng(6)
    q, k, v = (torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype,
                            device=dev)
               for shape, scale in (((B, H, Lq, D), qscale),
                                    ((B, KVH, Lkv, D), 1.0),
                                    ((B, KVH, Lkv, D), 1.0)))
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    blind = ~fa.visible_keys(Lq, Lkv, True, window, dev).any(-1)
    assert torch.count_nonzero(out[:, :, blind]) == 0  # no visible key -> 0


@pytest.mark.parametrize("causal,window", [(False, None), (False, 9),
                                           (False, 40), (False, 65)])
def test_flash_kernel_without_the_causal_mask(dev, causal, window):
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.standard_normal((1, 8, 70, 64)), dtype=torch.float32,
                     device=dev)
    k, v = (torch.tensor(rng.standard_normal((1, 2, 90, 64)),
                         dtype=torch.float32, device=dev) for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, want, **TOL[torch.float32])


@pytest.mark.parametrize("D,window", [(64, None), (80, 64)])
def test_flash_function_gradients_match_plain_autograd(dev, D, window):
    """Forward through the kernel, backward through the plain version:
    the gradients equal autograd of the plain version alone."""
    rng = np.random.default_rng(8)
    shapes = ((2, 32, 256, D), (2, 8, 256, D), (2, 8, 256, D))
    base = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=dev) for s in shapes]
    cot = torch.tensor(rng.standard_normal(shapes[0]), dtype=torch.float32,
                       device=dev)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        ts = [t.clone().requires_grad_() for t in base]
        (fn(*ts, causal=True, window=window) * cot).sum().backward()
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 4, 16, 64, device=dev)
    k = torch.randn(1, 2, 16, 64, device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                           k)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :, :32].contiguous(), k)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.randn(1, 4, 16, 192, device=dev),
                           torch.randn(1, 2, 16, 192, device=dev),
                           torch.randn(1, 2, 16, 192, device=dev))


# (B, L, H, P, G, N, chunk): the JAX kernel tests' shapes (G > 1 in the
# third), mamba2-130m's serving prefill (one chunk), a long prefill, a
# batch, and zamba2's SSM widths (64 heads, N 64)
SSD_SHAPES = {"(1,64,2,16,1,8,16)": (1, 64, 2, 16, 1, 8, 16),
              "(2,128,4,32,2,16,32)": (2, 128, 4, 32, 2, 16, 32),
              "groups (1,32,8,8,4,4,8)": (1, 32, 8, 8, 4, 4, 8),
              "mamba2 L64": (1, 64, 24, 64, 1, 128, 64),
              "mamba2 L2048": (1, 2048, 24, 64, 1, 128, 64),
              "mamba2 B4 L512": (4, 512, 24, 64, 1, 128, 64),
              "zamba2 widths": (1, 256, 64, 64, 1, 64, 64)}


def _ssd_inputs(rng, B, L, H, P, G, N, dtype, dev):
    def t(shape, dt=dtype):
        return torch.tensor(rng.standard_normal(shape), dtype=dt, device=dev)
    f32 = torch.float32
    # dt small, as the model's (dt_bias puts it near 1e-3 .. 1e-1), so the
    # state carries across chunks
    return (t((B, L, H, P)),
            torch.nn.functional.softplus(t((B, L, H), f32) - 3),
            -torch.exp(t((H,), f32)), t((B, L, G, N)), t((B, L, G, N)),
            t((B, H, N, P), f32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES.values(), ids=SSD_SHAPES.keys())
def test_ssd_scan_kernel_matches_plain(dev, dtype, with_state, shape):
    *dims, chunk = shape
    x, dt, A, Bm, Cm, init = _ssd_inputs(np.random.default_rng(9), *dims,
                                         dtype, dev)
    init = init if with_state else None
    before = ss.launches
    y, h = ss.ssd_scan(x, dt, A, Bm, Cm, chunk, init, return_state=True)
    y_only = ss.ssd_scan(x, dt, A, Bm, Cm, chunk, init)
    torch.cuda.synchronize()
    assert ss.launches == before + 2
    assert y.dtype == dtype and h.dtype == torch.float32
    assert torch.equal(y, y_only)
    want_y, want_h = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk, init,
                                       return_state=True)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(h, want_h, **SSD_TOL[torch.float32])


def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, dt, A, Bm, Cm, init = _ssd_inputs(np.random.default_rng(10), 1, 32,
                                         4, 16, 1, 8, torch.float32, dev)
    with pytest.raises(TypeError):         # x, Bm, Cm share one dtype
        ss.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), 16)
    with pytest.raises(TypeError):         # dt stays float32
        ss.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, 16)
    with pytest.raises(TypeError):         # so does the state
        ss.ssd_scan(x, dt, A, Bm, Cm, 16, init.bfloat16())
    with pytest.raises(ValueError):
        ss.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                    Bm, Cm, 16)
    with pytest.raises(ValueError):        # chunk not a multiple of 4
        ss.ssd_scan(x, dt, A, Bm, Cm, 2)
    with pytest.raises(ValueError):        # P not a multiple of 4
        ss.ssd_scan(x[..., :6].contiguous(), dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt, A.cpu(), Bm, Cm, 16)
    with pytest.raises(RuntimeError, match="no gradient"):
        ss.ssd_scan(x.requires_grad_(), dt, A, Bm, Cm, 16)
    with torch.no_grad():
        ss.ssd_scan(x, dt, A, Bm, Cm, 16)
