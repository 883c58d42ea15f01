"""The launch plans of the port's tensor-core attention kernels, checked
on the CPU.

``repro_torch.kernels.common.attention_plan`` (flash attention and the
float paged prefill), for every (H, KVH, D) of the port's registry and
the card tests' widths: every query row is covered exactly once, the
shared ring fits the H100's 227 KB a block, the grid's y and z stay
within their limits, and the padded head_dim is one the kernels
instantiate.  The C entry points refuse a plan whose bytes differ from
their ring's, so the card tests hold this formula to the kernels.

``decode_plan`` and ``split_range`` (the split-KV decode kernels, float
and int8): every live key of a sequence falls in exactly one split for
any length, the plan is a function of shapes alone, the serving shapes
run one split (no workspace, no merge), and widths the kernels do not
take are refused.  With ``quant`` (int8 KV) the shared bytes are those of
the int8 layout (``csrc/mma_attention.cuh``, ``Int8Layout``), which the C
entry points also check.

``attention_plan(..., quant=True)`` (the int8 paged prefill): the float
twin's rows and grid, the int8 prefix ring and the chunk's float ring
from one base, q's TF32 parts (f32) past the larger of the two
(``PrefillInt8Layout``), within 227 KB.

``ssd_plan`` (the SSD scan): the slices of P cover every column once, the
grid is (slices, H, B), the shared bytes are those of ``ssd::layout``
(two stages of B, C, x's slice and dt where they fit, else one; two
states; each warp's cumsum or weights) and fit, the serving prefill's CTA
count, every shape the CUDA-core kernel before it took up to d_state 256
(bf16) or 160 (f32) is taken, and shapes the kernel does not take are
refused; it reads shapes only."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.kernels import common

SMEM_PER_BLOCK = 232448           # H100: 227 KB of dynamic shared memory
GRID_YZ_MAX = 65535               # CUDA's limit on grid y and z
REGISTRY = sorted({(c.num_heads, c.num_kv_heads, c.resolved_head_dim)
                   for c in ARCHITECTURES.values() if c.num_kv_heads > 0})
# the card tests' widths, D 1..128 edges and G 1..64
WIDTHS = sorted(set(REGISTRY) | {
    (32, 8, 64), (6, 2, 128), (4, 4, 32), (12, 4, 80), (4, 4, 16),
    (32, 4, 128), (8, 2, 128), (4, 4, 80), (64, 1, 64), (32, 8, 80),
    (8, 1, 128), (16, 4, 16), (3, 1, 80), (8, 8, 64), (64, 1, 32),
    (4, 2, 32), (4, 1, 16), (8, 2, 64), (4, 4, 1), (6, 3, 17), (2, 1, 127)})
LENGTHS = (1, 15, 17, 64, 100, 129, 512, 2048)


def test_registry_widths_are_planned():
    assert (32, 8, 64) in REGISTRY and (32, 8, 80) in REGISTRY


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D", WIDTHS)
def test_plan_covers_every_row_once_and_fits(dtype, H, KVH, D):
    esize = torch.empty((), dtype=dtype).element_size()
    for L in LENGTHS:
        B = 3
        plan = common.attention_plan(B, H, KVH, L, D, dtype)
        G = H // KVH
        assert plan.group == G and plan.rows == G * plan.tile_q
        assert 1 <= plan.tile_q <= L and plan.rows <= common.MMA_ROWS
        assert plan.d_pad == min(p for p in common.MMA_D_PADS if p >= D)
        q_split = (2 * common.MMA_THREADS * plan.d_pad // 2 * 4
                   if dtype == torch.float32 else 0)
        assert plan.smem_bytes == (common.MMA_STAGES[dtype] * 2
                                   * common.MMA_TILE_KEYS
                                   * (plan.d_pad * esize + 16) + q_split)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        gx, gy, gz = plan.grid
        assert (gy, gz) == (KVH, B)
        assert gy <= GRID_YZ_MAX and gz <= GRID_YZ_MAX
        # CTA x, row r -> (query head r // tile_q of the group, position
        # x * tile_q + r % tile_q); positions >= L are padding rows
        seen = torch.zeros((G, L), dtype=torch.int64)
        for x in range(gx):
            r = torch.arange(plan.rows)
            pos = x * plan.tile_q + r % plan.tile_q
            live = pos < L
            seen.index_put_((r[live] // plan.tile_q, pos[live]),
                            torch.ones(int(live.sum()), dtype=torch.int64),
                            accumulate=True)
        assert torch.equal(seen, torch.ones_like(seen)), (L, plan)


@pytest.mark.parametrize("H,KVH,D", [(65, 1, 64), (32, 8, 129), (32, 8, 0),
                                     (30, 8, 64)])
def test_plan_refuses_what_the_kernels_do_not_take(H, KVH, D):
    with pytest.raises(ValueError):
        common.attention_plan(1, H, KVH, 16, D, torch.float32)


# (B, KVH, cap): the serving shapes (8 slots, 8-entry tables of 16-token
# pages; the 129-row dense slot), long context (8 x 4096), one long
# sequence, many short ones, and caps off the tile and split grid
DECODE_SHAPES = [(8, 8, 128), (8, 8, 129), (8, 8, 4096), (1, 8, 4096),
                 (1, 1, 100000), (64, 8, 512), (12, 2, 2048), (3, 2, 300),
                 (2, 1, 257), (5, 4, 1)]


@pytest.mark.parametrize("B,KVH,cap", DECODE_SHAPES)
def test_split_ranges_cover_every_live_key_once(B, KVH, cap):
    plan = common.decode_plan(B, 4 * KVH, KVH, cap, 64, torch.bfloat16)
    assert plan.grid == (plan.splits, KVH, B)
    assert 1 <= plan.splits <= common.SPLIT_MAX
    assert plan.splits <= max(1, -(-cap // common.SPLIT_MIN_KEYS))
    rng = np.random.default_rng(cap)
    lengths = {0, 1, cap - 1, cap, cap + 1, cap + 1000, -3, 63, 64, 65,
               255, 256, 257, 1025} | set(rng.integers(0, cap + 1, 40).tolist())
    for n in sorted(lengths):
        live = min(max(n, 0), cap)
        seen = np.zeros(max(cap, 1), np.int64)
        used = 0
        for x in range(plan.splits):
            lo, hi = common.split_range(n, cap, plan.splits, x)
            assert 0 <= lo <= hi <= live
            if hi > lo:
                used += 1
                assert lo % common.MMA_TILE_KEYS == 0   # splits start on tiles
                assert x == 0 or hi - lo <= common.split_range(
                    n, cap, plan.splits, 0)[1]
            seen[lo:hi] += 1
        assert (seen[:live] == 1).all() and (seen[live:] == 0).all(), n
        # short sequences use few splits: none holds fewer than the minimum
        # unless the whole sequence is shorter than it
        assert used <= max(1, -(-live // common.SPLIT_MIN_KEYS))


def test_decode_plan_reads_shapes_only():
    """The plan takes integers and a dtype, nothing that holds lengths, so
    a call's split count is known on the host and fixed under capture."""
    params = inspect.signature(common.decode_plan).parameters
    assert list(params) == ["B", "H", "KVH", "cap", "D", "dtype", "quant"]
    a = common.decode_plan(8, 32, 8, 4096, 64, torch.bfloat16)
    assert a == common.decode_plan(8, 32, 8, 4096, 64, torch.bfloat16)
    assert a.splits > 1 and a.workspace_floats == 8 * 8 * a.splits * 4 * 66


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [128, 129, 256])
def test_serving_shapes_run_one_split(dtype, cap):
    """8 slots, 8-entry tables of 16-token pages (cap 128) or the 129-row
    dense slot: one CTA per (slot, KV head), no workspace, no merge."""
    for H, KVH, D in REGISTRY:
        plan = common.decode_plan(8, H, KVH, cap, D, dtype)
        assert plan.splits == 1 and plan.workspace_floats == 0
        assert plan.grid == (1, KVH, 8)
        assert plan.smem_bytes == common.attention_plan(
            8, H, KVH, 1, D, dtype).smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("H,KVH,D,cap", [(65, 1, 64, 128), (32, 8, 129, 128),
                                         (32, 8, 0, 128), (30, 8, 64, 128),
                                         (32, 8, 64, 0)])
def test_decode_plan_refuses_what_the_kernels_do_not_take(H, KVH, D, cap):
    with pytest.raises(ValueError):
        common.decode_plan(1, H, KVH, cap, D, torch.float32)


def _int8_layout_bytes(d_pad, dtype):
    """Int8Layout<T, Dp>::kSmem: one converted (K, V) tile pair of 64
    rows of d_pad elements plus 16 bytes, 3 stages of int8 K and V rows
    (d_pad bytes each) with one scale per key each, and in f32 the q
    split."""
    esize = torch.empty((), dtype=dtype).element_size()
    conv = 2 * 64 * (d_pad * esize + 16)
    stages = 3 * (2 * 64 * d_pad + 2 * 64 * esize)
    q_split = 4 * d_pad * 128 if dtype == torch.float32 else 0
    return conv + stages + q_split


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D", WIDTHS)
def test_int8_decode_plan_fits(dtype, H, KVH, D):
    for cap in (1, 128, 129, 2048, 4096):
        plan = common.decode_plan(8, H, KVH, cap, D, dtype, quant=True)
        assert plan.d_pad == min(p for p in common.MMA_D_PADS if p >= D)
        assert plan.smem_bytes == _int8_layout_bytes(plan.d_pad, dtype)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        # never more shared memory than the float twin's ring
        assert plan.smem_bytes < common.decode_plan(8, H, KVH, cap, D,
                                                    dtype).smem_bytes
        per_sm = min(common.SPLIT_CTAS_PER_SM,
                     common.SMEM_PER_SM // (plan.smem_bytes + 1024))
        if dtype == torch.bfloat16:              # D 128: as its float twin
            assert per_sm == (3 if plan.d_pad <= 96 else 2)
        assert plan.splits == max(1, min(
            common.H100_SMS * per_sm // (8 * KVH),
            -(-cap // common.SPLIT_MIN_KEYS), common.SPLIT_MAX))
        assert plan.grid == (plan.splits, KVH, 8)
        assert plan.workspace_floats == (
            8 * KVH * plan.splits * (H // KVH) * (D + 2)
            if plan.splits > 1 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_plans_at_the_serve_caps_and_long_context(dtype):
    """The serving caps (at most 256 keys a sequence) run one split; 8 x
    4096 at granite's widths runs the float twins' 6 splits in bf16."""
    for H, KVH, D in REGISTRY:
        for cap in (128, 129, 256):
            plan = common.decode_plan(8, H, KVH, cap, D, dtype, quant=True)
            assert plan.splits == 1 and plan.workspace_floats == 0
    plan = common.decode_plan(8, 32, 8, 4096, 64, torch.bfloat16, quant=True)
    assert plan.smem_bytes == 43776
    assert plan.splits == 6 and plan.grid == (6, 8, 8)
    assert plan.workspace_floats == 8 * 8 * 6 * 4 * 66
    # shapes only: the same plan for every call of the same shapes
    assert plan == common.decode_plan(8, 32, 8, 4096, 64, torch.bfloat16,
                                      quant=True)


@pytest.mark.parametrize("H,KVH,D,cap", [(65, 1, 64, 128), (32, 8, 129, 128),
                                         (32, 8, 0, 128), (30, 8, 64, 128),
                                         (32, 8, 64, 0)])
def test_int8_decode_plan_refuses_what_the_kernels_do_not_take(H, KVH, D,
                                                               cap):
    with pytest.raises(ValueError):
        common.decode_plan(1, H, KVH, cap, D, torch.bfloat16, quant=True)


def _float_ring(d_pad, dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    return common.MMA_STAGES[dtype] * 2 * 64 * (d_pad * esize + 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D", WIDTHS)
def test_int8_prefill_plan_puts_q_past_both_rings(dtype, H, KVH, D):
    q_split = 4 * 128 * (min(p for p in common.MMA_D_PADS if p >= D))
    for L in LENGTHS:
        plan = common.attention_plan(3, H, KVH, L, D, dtype, quant=True)
        float_plan = common.attention_plan(3, H, KVH, L, D, dtype)
        assert (plan.group, plan.tile_q, plan.rows, plan.d_pad, plan.grid) \
            == (float_plan.group, float_plan.tile_q, float_plan.rows,
                float_plan.d_pad, float_plan.grid)
        qs = q_split if dtype == torch.float32 else 0
        int8_ring = _int8_layout_bytes(plan.d_pad, dtype) - qs
        float_ring = _float_ring(plan.d_pad, dtype)
        # q's parts start where neither loop's ring reaches
        assert plan.smem_bytes - qs == max(int8_ring, float_ring)
        assert plan.smem_bytes <= SMEM_PER_BLOCK


def test_int8_prefill_plan_at_the_serve_shape():
    """granite's widths in bf16: the float ring (55,296 bytes) is the
    larger, so the int8 twin takes the float twin's shared bytes; in f32
    at D 128 q's 64 KB follow the 132 KB float ring."""
    plan = common.attention_plan(8, 32, 8, 32, 64, torch.bfloat16,
                                 quant=True)
    assert plan.smem_bytes == 55296 == common.attention_plan(
        8, 32, 8, 32, 64, torch.bfloat16).smem_bytes
    assert plan.grid == (2, 8, 8) and plan.rows == 64
    assert common.attention_plan(1, 8, 2, 16, 128, torch.float32,
                                 quant=True).smem_bytes == 135168 + 65536


@pytest.mark.parametrize("H,KVH,D", [(65, 1, 64), (32, 8, 129), (32, 8, 0),
                                     (30, 8, 64)])
def test_int8_prefill_plan_refuses_what_the_kernel_does_not_take(H, KVH, D):
    with pytest.raises(ValueError):
        common.attention_plan(1, H, KVH, 16, D, torch.bfloat16, quant=True)


# (B, L, H, P, G, N, chunk): mamba2-130m's serving prefill, long prefills
# and a batch, zamba2's widths (at chunk 64 and 128), d_state 256,
# the JAX tests' shapes, a half-full last slice (P 24) and ragged widths
# that pad everywhere
SSD_PLAN_SHAPES = [(1, 64, 24, 64, 1, 128, 64), (1, 2048, 24, 64, 1, 128, 64),
                   (4, 512, 24, 64, 1, 128, 64), (1, 256, 64, 64, 1, 64, 64),
                   (1, 256, 64, 64, 1, 64, 128), (1, 128, 4, 64, 1, 256, 64),
                   (1, 64, 2, 16, 1, 8, 16), (2, 128, 4, 32, 2, 16, 32),
                   (1, 32, 8, 8, 4, 4, 8), (1, 96, 2, 24, 1, 32, 32),
                   (1, 24, 3, 6, 1, 5, 4)]


def _ssd_layout_bytes(dtype, Q, N, stages):
    """ssd::layout<T>(Q, N, stages).total: ``stages`` stages of B and C (Qp
    rows of Np elements plus 16 bytes), x's slice (Qp rows of 16 plus 8
    bf16 / 4 f32 elements) and dt (Qp floats); two f32 states of Np rows
    of 24; eight warps' cumsums or weights (Qp floats each)."""
    esize = torch.empty((), dtype=dtype).element_size()
    Qp, Np = -(-Q // 16) * 16, -(-N // 16) * 16
    stage = (2 * Qp * (Np * esize + 16)
             + Qp * (16 + (4 if esize == 4 else 8)) * esize + 4 * Qp)
    return stages * stage + 2 * Np * 24 * 4 + 8 * Qp * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_PLAN_SHAPES)
def test_ssd_plan_slices_cover_p_once_and_fit(dtype, shape):
    B, L, H, P, G, N, Q = shape
    plan = common.ssd_plan(B, L, H, P, G, N, Q, dtype)
    assert plan.slice_p == common.SSD_SLICE == 16
    assert plan.grid == (plan.slices, H, B)
    seen = np.zeros(P, np.int64)
    for x in range(plan.slices):
        seen[x * plan.slice_p:(x + 1) * plan.slice_p] += 1
    assert (seen == 1).all()
    assert (plan.slices - 1) * plan.slice_p < P
    assert (plan.q_pad, plan.n_pad) == (-(-Q // 16) * 16, -(-N // 16) * 16)
    two = _ssd_layout_bytes(dtype, Q, N, 2)
    assert plan.stages == (2 if two <= SMEM_PER_BLOCK else 1)
    assert plan.smem_bytes == _ssd_layout_bytes(dtype, Q, N, plan.stages)
    assert plan.smem_bytes <= SMEM_PER_BLOCK


def test_ssd_plan_at_the_serve_shape():
    """mamba2-130m's single-shot prefill (B 1, one 64-token chunk, 24
    heads of 64, N 128): P / 16 CTAs a head, where the old kernel ran one,
    every one of them in the first wave (two fit an SM)."""
    plan = common.ssd_plan(1, 64, 24, 64, 1, 128, 64, torch.bfloat16)
    assert plan.grid == (4, 24, 1) and plan.stages == 2
    per_sm = common.SMEM_PER_SM // (plan.smem_bytes + 1024)
    assert per_sm >= 2 and plan.grid[0] * 24 <= common.H100_SMS * per_sm


def test_ssd_plan_reads_shapes_only():
    params = inspect.signature(common.ssd_plan).parameters
    assert list(params) == ["B", "L", "H", "P", "G", "N", "Q", "dtype"]


def _old_kernel_took(Q, N, P):
    """The CUDA-core SSD kernel this one replaced (``_fits`` and
    ``_shared_bytes`` of its wrapper): chunk and P multiples of 4, at most
    16 rows of each product a thread of 256, every array f32 in 227 KB."""
    def fits(rows, cols):
        if cols % 4 or cols // 4 > 256:
            return False
        return -(-rows // (256 // (cols // 4))) <= 16
    smem = 4 * (Q * P + N * P + N * (Q + 4) + Q * (N + 1) + Q * (Q + 1)
                + 2 * Q)
    return fits(Q, Q) and fits(Q, P) and fits(N, P) and smem <= 232448


@pytest.mark.parametrize("dtype,max_state", [(torch.bfloat16, 256),
                                             (torch.float32, 160)])
def test_ssd_plan_takes_what_the_old_kernel_took(dtype, max_state):
    """Every (chunk, d_state, P) the replaced kernel took, up to d_state
    ``max_state``, has a plan (f32 above 160 only at small chunks: its
    two copies of B and C a chunk)."""
    taken = 0
    for Q in range(4, 129, 4):
        for N in (*range(1, 33), *range(40, max_state + 1, 8)):
            for P in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256):
                if _old_kernel_took(Q, N, P):
                    common.ssd_plan(1, Q, 1, P, 1, N, Q, dtype)
                    taken += 1
    assert taken > 10000


@pytest.mark.parametrize("B,L,H,P,G,N,Q,dtype", [
    (1, 256, 4, 64, 1, 128, 256, torch.bfloat16),   # chunk over 128
    (1, 128, 4, 64, 1, 512, 128, torch.float32),    # one stage over 227 KB
    (1, 100, 4, 64, 1, 128, 64, torch.bfloat16),    # L % chunk
    (1, 64, 6, 64, 4, 128, 64, torch.bfloat16),     # H % G
    (1, 64, 4, 64, 1, 128, 64, torch.float16),      # dtype
    (1, 64, 4, 64, 1, 0, 64, torch.bfloat16),       # d_state 0
    (0, 64, 4, 64, 1, 128, 64, torch.bfloat16),
    (1, 64, 4, 0, 1, 128, 64, torch.bfloat16)])
def test_ssd_plan_refuses_what_the_kernel_does_not_take(B, L, H, P, G, N, Q,
                                                        dtype):
    with pytest.raises(ValueError):
        common.ssd_plan(B, L, H, P, G, N, Q, dtype)
