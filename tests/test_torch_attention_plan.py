"""The launch plans of the port's tensor-core attention kernels, checked
on the CPU.

``repro_torch.kernels.common.attention_plan`` (flash attention and the
float paged prefill), for every (H, KVH, D) of the port's registry and
the card tests' widths: every query row is covered exactly once, the
shared ring fits the H100's 227 KB a block, the grid's y and z stay
within their limits, and the padded head_dim is one the kernels
instantiate.  The C entry points refuse a plan whose bytes differ from
their ring's, so the card tests hold this formula to the kernels.

``decode_plan`` and ``split_range`` (the split-KV float decode kernels):
every live key of a sequence falls in exactly one split for any length,
the plan is a function of shapes alone, the serving shapes run one split
(no workspace, no merge), and widths the kernels do not take are
refused."""
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
    assert list(params) == ["B", "H", "KVH", "cap", "D", "dtype"]
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
