"""The launch plan of the port's tensor-core attention kernels
(``repro_torch.kernels.common.attention_plan``: flash attention and the
float paged prefill), checked on the CPU for every (H, KVH, D) of the
port's registry and the card tests' widths: every query row is covered
exactly once, the shared ring fits the H100's 227 KB a block, the grid's
y and z stay within their limits, and the padded head_dim is one the
kernels instantiate.  The C entry points refuse a plan whose bytes differ
from their ring's, so the card tests hold this formula to the kernels."""
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
