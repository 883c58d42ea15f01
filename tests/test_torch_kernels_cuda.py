"""The port's CUDA kernels (paged decode, paged prefill, dense decode, each
in float and int8-KV variants, and flash attention and the SSD scan, each
with its autograd Function, whose gradients are held against autograd of
the plain version, also at the training phase's shapes) against their
plain PyTorch versions, on the card.  Each Function's backward recomputes
the plain version and never reads the kernel's output, so its gradient
cases hold the Function's wiring (cotangents, which inputs get a
gradient), not the kernel; the kernel is held by the forward cases.

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
tolerance: its sums run over up to 128 + 64 terms of unit-normal inputs
through up to 32 chunks, in the tensor cores' f32 accumulators, which do
not round to nearest.  Its final state is f32 whatever x's dtype and held
to that tolerance too.

The SSD cases cover the kernel's slices of P (P 8, 16, 24, 32, 64), rows
that go through registers with every dimension padded (chunk 4, N 5, P
6), chunks of 100 and 128 rows (two row tiles a y warp, two key
segments), d_state 256, one stage where two do not fit (f32 at chunk 128
or d_state 256), and a CUDA-graph replay; the int8 prefill cases GQA
groups 1-64, D 64-128 and a 4 x 2048-token prefix.
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
    # chunks past 128 rows, where the reference's 128-row q tiles end
    # inside the kernel's tiles of 64 // group rows (groups 3, 6 and 7)
    (12, 2, 128, 16, 256, [0, 40, 300, 7], [1, 100, 128, 0], 1.0),
    (14, 2, 128, 16, 256, [0, 40, 300, 7], [120, 5, 129, 0], 1.0),
    (12, 2, 128, 16, 512, [0, 40, 300, 7], [130, 1, 300, 383], 1.0),
    (14, 2, 128, 16, 512, [0, 40, 300, 7], [130, 1, 300, 0], 1.0),
    (6, 2, 64, 16, 384, [0, 17], [100, 200], 1.0),
]


def _check_prefill(out, want, C, vd, dtype):
    """Every row of a prefill output, the padding rows past valid
    included, against the plain version; exact zeros past ``live_rows``
    (all of an inactive row: it reads nothing)."""
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    for b, n in enumerate(ppa.live_rows(C, vd).tolist()):
        assert torch.count_nonzero(out[b, :, n:]) == 0


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
    _check_prefill(out, want, C, vd, dtype)


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


# (H, KVH, D, bs, C, starts, valid); starts/valid None: an empty prefix,
# prefixes past and inside pages, a valid == 0 row.  GQA groups 1, 3, 4,
# 8 and 64 at head_dim 64, 80 and 128; prefixes of 63-65 tokens around
# the 64-key tiles and ending mid-page; 8-token pages (their 16-byte bf16
# scale pieces hold 8 keys); a 4 x 2048-token prefix (32 tiles a CTA)
PREFILL_QUANT_CASES = [
    (32, 8, 64, 16, 32, None, None),
    (32, 8, 80, 16, 128, None, None),
    (6, 2, 128, 16, 100, None, None),
    (8, 8, 64, 16, 32, [0, 63, 64, 65], [32, 32, 0, 17]),
    (16, 4, 80, 8, 64, [5, 64, 130, 1], [64, 40, 64, 1]),
    (64, 8, 128, 16, 17, [16, 300, 0], [17, 3, 9]),
    (64, 1, 64, 16, 17, [16, 40], [17, 3]),
    (32, 8, 64, 16, 128, [2048, 2048, 2048, 2048], [128, 128, 100, 128]),
    # past 128 rows: the reference's q tiles end inside the kernel's
    (12, 2, 128, 16, 256, [0, 40, 300, 7], [1, 100, 128, 0]),
    (14, 2, 128, 16, 512, [0, 40, 300, 7], [130, 1, 300, 383]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,bs,C,starts,valid", PREFILL_QUANT_CASES)
def test_paged_prefill_quant_kernel_matches_plain(dev, dtype, H, KVH, D, bs,
                                                  C, starts, valid):
    rng = np.random.default_rng(4)
    starts = np.array([0, 21, 2 * bs, 300, 7] if starts is None else starts,
                      np.int32)
    valid = np.array([C, C, C // 2 + 3, 0, C - 5] if valid is None
                     else valid, np.int32)
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
    _check_prefill(out, want, C, vd, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,KVH,D,S", [(32, 8, 64, 129), (32, 8, 80, 65),
                                        (6, 2, 128, 300), (8, 1, 32, 7),
                                        (32, 32, 64, 545), (16, 16, 64, 65)])
def test_decode_kernels_match_plain(dev, dtype, quant, H, KVH, D, S):
    """Dense decode: lengths 0, 1, S (the full slot) and in between; the
    tail past lengths is masked, S need not be a tile multiple.  The last
    two shapes are the serve paths' of zamba2's attention sites (32 heads
    on 32, a 545-column cache) and whisper's decoder (16 on 16, 65)."""
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


# The split-KV decode kernels (float and int8) over caps of 2048 keys a
# sequence
# (splits > 1): lengths 0 and 1, the split edges at multiples of 256 (and
# 1025, whose last split holds one key) +-1, the cap, above the cap; one
# or many splits in one batch; GQA groups 1, 4, 8, 64 at head_dim 64, 80
# and 128; in the page pool, sentinel ids (>= N, and -1) among the live
# blocks, inside a split, which both versions clamp into the pool.
SPLIT_CAP, SPLIT_BS = 2048, 16
SPLIT_LENGTHS = [0, 1, 255, 256, 257, 511, 1023, 1024, 1025, 2047, 2048,
                 2100]


def _split_case(kind, rng, dtype, dev, H, KVH, D, lengths, quant=False):
    """(wrapper, plain version, args) of the ``kind`` decode kernel
    ("paged" or "dense"; its int8 twin with ``quant``) over SPLIT_CAP keys
    a sequence."""
    B = len(lengths)
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=dtype, device=dev)
    ln = torch.tensor(np.asarray(lengths, np.int32), device=dev)
    sfx = "_quant" if quant else ""
    if kind == "dense":
        shape = (B, KVH, SPLIT_CAP, D)
        kv = (_int8_rows(rng, shape, dtype, dev) if quant else
              [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                            device=dev) for _ in range(2)])
        return (getattr(da, "decode_attention" + sfx),
                getattr(da, f"decode_attention{sfx}_plain"), (q, *kv, ln))
    nb = SPLIT_CAP // SPLIT_BS
    N = B * nb
    kv = (_int8_rows(rng, (N, KVH, SPLIT_BS, D), dtype, dev) if quant else
          _pool(rng, N, KVH, SPLIT_BS, D, dtype, dev))
    bt = _table(rng, B, nb, N, [nb] * B, dev)
    bt[1, 20] = N + 3                  # inside a split of a live sequence
    bt[-2, 40:42] = -1
    bt[-1, 127] = N
    return (getattr(pda, "paged_decode_attention" + sfx),
            getattr(pda, f"paged_decode_attention{sfx}_plain"),
            (q, *kv, bt, ln))


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 6, 7, 8, 64])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_split_decode_kernels_match_plain(dev, kind, quant, dtype, G, D):
    rng = np.random.default_rng(11)
    KVH = 2
    fn, plain, args = _split_case(kind, rng, dtype, dev, G * KVH, KVH, D,
                                  SPLIT_LENGTHS, quant)
    plan = common.decode_plan(len(SPLIT_LENGTHS), G * KVH, KVH, SPLIT_CAP, D,
                              dtype, quant)
    assert plan.splits >= 5                   # long sequences use several
    mod = pda if kind == "paged" else da
    counter = "quant_launches" if quant else "launches"
    before = getattr(mod, counter)
    out = fn(*args)
    torch.cuda.synchronize()
    assert getattr(mod, counter) == before + 1  # one count, whatever splits
    torch.testing.assert_close(out.float(), plain(*args).float(),
                               **TOL[dtype])
    assert torch.count_nonzero(out[0]) == 0   # no valid key -> 0
    # every merging CTA reset its arrival counter
    assert torch.count_nonzero(common.split_tickets(out.device, 1)) == 0


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_replays_in_a_cuda_graph(dev, kind, quant, dtype):
    """The split count is fixed when the call is captured; each replay
    reads the lengths then in the buffer (0, the cap, and in between)."""
    rng = np.random.default_rng(12)
    fn, plain, args = _split_case(kind, rng, dtype, dev, 32, 8, 64,
                                  [SPLIT_CAP] * 4, quant)
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
    the gradients equal autograd of the plain version alone (the
    Function's wiring; the backward does not read the kernel's output)."""
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


@pytest.mark.parametrize("B,H,KVH,L,D", [
    (1, 56, 8, 512, 128),     # llava-next-34b's group 7 at D 128
    (2, 32, 4, 512, 128),     # qwen3-moe-30b-a3b's group 8
    (2, 16, 16, 448, 64),     # whisper-medium's decoder, 448 tokens
    (2, 32, 32, 512, 64)])    # zamba2-1.2b's shared block
def test_flash_function_at_the_training_shapes(dev, B, H, KVH, L, D):
    """The training phase's attention shapes in f32: the forward (the
    kernel) against the plain version and the gradients (the Function's
    wiring) against autograd of it."""
    rng = np.random.default_rng(16)
    shapes = ((B, H, L, D), (B, KVH, L, D), (B, KVH, L, D))
    base = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=dev) for s in shapes]
    cot = torch.tensor(rng.standard_normal(shapes[0]), dtype=torch.float32,
                       device=dev)
    outs, grads = [], []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        ts = [t.clone().requires_grad_() for t in base]
        out = fn(*ts, causal=True)
        (out * cot).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in ts])
    torch.testing.assert_close(*outs, **TOL[torch.float32])
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
# batch, and zamba2's SSM widths (64 heads, N 64), also at its serve
# prefill's shortest and longest padded prompts (64 and 512); then the kernel's
# P-slice edges: P 8 (one slice), 16, 32 and 64 at mamba2's N and chunk,
# P 24 (a last slice half full), and ragged widths whose rows go through
# registers and whose chunk, state and slice all pad (Q 4, N 5, P 6); then
# chunks over 64 rows (zamba2's widths at 128; a ragged 100) and d_state 256,
# which in f32 take the one-stage layout
SSD_SHAPES = {"(1,64,2,16,1,8,16)": (1, 64, 2, 16, 1, 8, 16),
              "(2,128,4,32,2,16,32)": (2, 128, 4, 32, 2, 16, 32),
              "groups (1,32,8,8,4,4,8)": (1, 32, 8, 8, 4, 4, 8),
              "mamba2 L64": (1, 64, 24, 64, 1, 128, 64),
              "mamba2 L2048": (1, 2048, 24, 64, 1, 128, 64),
              "mamba2 B4 L512": (4, 512, 24, 64, 1, 128, 64),
              "zamba2 widths": (1, 256, 64, 64, 1, 64, 64),
              "zamba2 serve L64": (1, 64, 64, 64, 1, 64, 64),
              "zamba2 serve L512": (1, 512, 64, 64, 1, 64, 64),
              "P8": (1, 192, 4, 8, 1, 128, 64),
              "P16": (2, 128, 3, 16, 1, 128, 64),
              "P32": (1, 128, 2, 32, 1, 128, 64),
              "P64 G2": (1, 128, 4, 64, 2, 128, 64),
              "P24": (1, 96, 2, 24, 1, 32, 32),
              "ragged (1,24,3,6,1,5,4)": (1, 24, 3, 6, 1, 5, 4),
              "zamba2 chunk 128": (1, 256, 64, 64, 1, 64, 128),
              "chunk 128 N128": (1, 256, 4, 64, 1, 128, 128),
              "ragged chunk 100": (1, 200, 2, 24, 1, 40, 100),
              "N256": (1, 128, 4, 64, 1, 256, 64)}


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


def test_ssd_scan_replays_in_a_cuda_graph(dev):
    """The serving prefill's call (state in and out) captured once and
    replayed on new inputs copied into the captured buffers."""
    rng = np.random.default_rng(13)
    B, L, H, P, G, N, chunk = SSD_SHAPES["mamba2 L64"]
    args = list(_ssd_inputs(rng, B, L, H, P, G, N, torch.bfloat16, dev))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.ssd_scan(*args[:5], chunk, args[5], return_state=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ss.launches
    with torch.cuda.graph(graph):
        y, h = ss.ssd_scan(*args[:5], chunk, args[5], return_state=True)
    assert ss.launches == before + 1           # a capture counts once
    for seed in range(3):
        new = _ssd_inputs(np.random.default_rng(20 + seed), B, L, H, P, G, N,
                          torch.bfloat16, dev)
        for buf, val in zip(args, new):
            buf.copy_(val)
        graph.replay()
        torch.cuda.synchronize()
        want_y, want_h = ss.ssd_scan_plain(*args[:5], chunk, args[5],
                                           return_state=True)
        torch.testing.assert_close(y.float(), want_y.float(),
                                   **SSD_TOL[torch.bfloat16])
        torch.testing.assert_close(h, want_h, **SSD_TOL[torch.float32])


def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, dt, A, Bm, Cm, init = _ssd_inputs(np.random.default_rng(10), 1, 128,
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
    long = _ssd_inputs(np.random.default_rng(11), 1, 256, 4, 16, 1, 8,
                       torch.float32, dev)
    with pytest.raises(ValueError):        # chunks of at most 128 rows
        ss.ssd_scan(*long[:5], 256)
    wide = torch.zeros(1, 128, 1, 512, device=dev)
    with pytest.raises(ValueError):        # one f32 stage over 227 KB
        ss.ssd_scan(x, dt, A, wide, wide, 128)
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt, A.cpu(), Bm, Cm, 16)
    # an input that requires grad runs the kernel too (training)
    before = ss.launches
    ss.ssd_scan(x.requires_grad_(), dt, A, Bm, Cm, 16)
    with torch.no_grad():
        ss.ssd_scan(x, dt, A, Bm, Cm, 16)
    assert ss.launches == before + 2


# the training phase's SSD shapes, (B, L, H, P, G, N, chunk): mamba2-130m
# and zamba2-1.2b at batch 2 of 512 tokens, and a ragged one
SSD_TRAIN_SHAPES = {"mamba2 B2 L512": (2, 512, 24, 64, 1, 128, 64),
                    "zamba2 B2 L512": (2, 512, 64, 64, 1, 64, 64),
                    "groups (2,96,8,24,2,40,32)": (2, 96, 8, 24, 2, 40, 32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", SSD_TRAIN_SHAPES.values(),
                         ids=SSD_TRAIN_SHAPES.keys())
def test_ssd_scan_function_gradients_match_plain_autograd(dev, dtype,
                                                          with_state, shape):
    """Forward through the kernel, backward through the plain version: the
    forward within the kernel's tolerance of the plain version's, every
    input's gradient (cotangents on y and the final state) within the
    tolerance of autograd of the plain version alone.  The gradients hold
    the Function's wiring, not the kernel, whose output the backward does
    not read."""
    *dims, chunk = shape
    base = list(_ssd_inputs(np.random.default_rng(14), *dims, dtype, dev))
    if not with_state:
        base[5] = None
    rng = np.random.default_rng(15)
    B, L, H, P, G, N = dims
    gy = torch.tensor(rng.standard_normal((B, L, H, P)), dtype=dtype,
                      device=dev)
    gh = torch.tensor(rng.standard_normal((B, H, N, P)),
                      dtype=torch.float32, device=dev)
    results = []
    for fn in (ss.ssd_scan, ss.ssd_scan_plain):
        ts = [t if t is None else t.clone().requires_grad_() for t in base]
        before = ss.launches
        y, h = fn(*ts[:5], chunk, ts[5], return_state=True)
        assert ss.launches == before + (fn is ss.ssd_scan)
        ((y.float() * gy.float()).sum() + (h * gh).sum()).backward()
        results.append((y, h, [t.grad for t in ts if t is not None]))
    torch.cuda.synchronize()
    (y, h, got), (want_y, want_h, want) = results
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(h, want_h, **SSD_TOL[torch.float32])
    for name, g, w in zip("x dt A Bm Cm init_state".split(), got, want):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype],
                                   msg=name)


# ---------------------------------------------------------------------------
# the hybrid and the encoder-decoder served on the card against the CPU
# ---------------------------------------------------------------------------

def _logged(model, calls):
    """``model`` with its serving paths appending their logits (f32, on the
    CPU) to ``calls``."""
    import dataclasses

    def rec(fn):
        def run(*args):
            logits, cache = fn(*args)
            calls.append(logits.detach().float().cpu())
            return logits, cache
        return run
    return dataclasses.replace(model, prefill=rec(model.prefill),
                               decode_step=rec(model.decode_step))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-medium"])
def test_hybrid_and_encdec_engines_match_the_cpu(dev, arch):
    """Reduced zamba2 (four layers, two attention sites) and reduced
    whisper (frame embeddings on every request) served on the dense
    backend from the same f32 weights on the card (the kernels) and on
    the CPU (their plain versions), with decode bursts of 2 and one
    request evicted mid-decode and resumed.  whisper's tokens must be
    equal; zamba2's (its prefill through the SSD kernel) too, or parting
    first where the CPU's two best logits lie within 1e-3, its logits
    within 1e-3 up to there."""
    from repro_torch.configs import get_arch
    from repro_torch.core.request import Request
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    cfg = get_arch(arch).reduced(num_layers=4 if arch.startswith("zamba")
                                 else 2)
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen, torch.float32, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 100, size=n).tolist() for n in (5, 17, 30, 9)]
    frames = [None] * len(prompts)
    if cfg.encoder is not None:
        frames = [{"frame_embeds": rng.standard_normal(
            (cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)}
            for _ in prompts]
    runs = []
    for device in ("cuda", "cpu"):
        p = params if device == "cpu" else {
            k: ([{n: _to(v, device) for n, v in b.items()} for b in x]
                if isinstance(x, list) else _to(x, device))
            for k, x in params.items()}
        calls = []
        eng = ContinuousBatchingEngine(_logged(model, calls), p, EngineConfig(
            max_slots=4, max_seq_len=64, decode_burst=2, device=device,
            attention_backend="cuda", debug_invariants=True),
            model_name="m")
        reqs = [Request(prompt_tokens=pr, model="m", slo=1e9,
                        max_new_tokens=10, extras=ex)
                for pr, ex in zip(prompts, frames)]
        for r in reqs:
            assert eng.admit(r)
        eng.steps()
        eng.evict_request(reqs[1].req_id)
        eng.steps()
        assert eng.admit(reqs[1])
        for _ in range(100):
            eng.steps()
            if all(r.finished() for r in reqs):
                break
        assert all(r.finished() for r in reqs) and eng.stats.resumes == 1
        runs.append(([r.output_tokens for r in reqs], calls))
    (got, g_calls), (want, w_calls) = runs
    if cfg.ssm is None:
        assert got == want
        return
    for a, b in zip(g_calls, w_calls):
        flips = (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist()
        for r in flips:
            top2 = b[r].topk(2).values
            assert float(top2[0] - top2[1]) <= 1e-3
        if flips:
            return
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    assert got == want


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x.to(device)


def test_shard_registry_on_a_one_device_nccl_mesh(dev):
    """``serve.shard_registry`` on the card: every leaf placed on a
    one-device mesh (a one-rank ``nccl`` group) as ``spec_for`` gives it,
    and the page-pool engine's tokens with the placed params equal those
    without, bit for bit (bf16, reduced granite-3-2b)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.request import Request
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    model = build_model(get_arch("granite-3-2b").reduced())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, torch.bfloat16, dev)
    registry = {"g": (model, params)}
    mesh_lib.release()
    try:
        mesh = mesh_lib.make_local_mesh(dev)
        placed = serve.placed_registry(registry, mesh)["g"][1]
        want = sh.build_shardings(mesh, params, model.param_axes(),
                                  sh.ShardingRules.default())
        sh.map_leaves(lambda path, d, pl: (
            d.placements == tuple(pl) and d.to_local().is_cuda)
            or pytest.fail(path), placed, want)
    finally:
        mesh_lib.release()
    sharded = serve.shard_registry(registry)["g"][1]

    def tokens(p):
        eng = ContinuousBatchingEngine(model, p, EngineConfig(
            max_slots=4, max_seq_len=64, dtype=torch.bfloat16),
            model_name="m")
        rng = np.random.default_rng(1)
        reqs = [Request(prompt_tokens=rng.integers(0, 100, n).tolist(),
                        model="m", slo=1e9, max_new_tokens=8)
                for n in (5, 12, 3, 9)]
        for r in reqs:
            assert eng.admit(r)
        while not all(r.finished() for r in reqs):
            eng.steps()
        return [r.output_tokens for r in reqs]

    assert tokens(sharded) == tokens(params)
