"""The FLOP and byte counters against hand counts."""
import pytest

from qlm_bench import counting, families, harness


def _model(name):
    """A configuration's sizes and its family's attention layers."""
    config = harness.load_json("configs", name)
    return config["model"], families.of(config).attention_layers(
        config["model"])


def test_decode_launch_by_hand():
    # 2 sequences of 100 and 28 keys, 32 heads on 8, D 64, bf16:
    # q and out 2 rows x 32 x 64 x 2 B each, k and v 128 rows x 8 x 64 x 2 B
    nbytes = 2 * (2 * 32 * 64 * 2) + 2 * 128 * 8 * 64 * 2
    flops = 4 * 32 * 64 * 128
    assert counting.attn_bytes(2, H=32, KVH=8, D=64, q_rows=2, kv_rows=128) \
        == nbytes
    assert counting.decode_least_s(2, 32, 8, 64, [100, 28]) \
        == pytest.approx(max(nbytes / 3.35e12, flops / 989e12))


def test_prefill_launch_by_hand():
    # one row: 3 new tokens after 5 cached; causal inside the chunk
    H, KVH, D = 4, 2, 16
    flops = 4 * H * D * (3 * 5 + 1 + 2 + 3)
    nbytes = (3 + 3) * H * D * 2 + 2 * 5 * KVH * D * 2 + 2 * 3 * KVH * D * 2
    got = counting.prefill_least_s(2, H, KVH, D, [5], [3])
    assert got == pytest.approx(max(nbytes / 3.35e12, flops / 989e12))
    # flops-bound at a long chunk
    assert counting.prefill_least_s(2, 32, 8, 64, [4000], [2000]) \
        == pytest.approx(4 * 32 * 64 * (2000 * 4000 + 2000 * 2001 / 2)
                         / 989e12)


def test_token_flops_by_hand():
    g, layers = _model("granite-3-2b")
    d, F, L, V = 2048, 8192, 40, 49155
    proj = 2 * d * 2048 + 2 * d * 512          # q, o; k, v
    per = 2 * (proj + 3 * d * F) + 4 * 32 * 64 * 10
    assert counting.token_flops(g, layers, 10, False) == L * per
    assert counting.token_flops(g, layers, 10, True) == L * per + 2 * d * V
    x, layers = _model("dbrx-132b-8of40")
    d, Fe, E, k = 6144, 10752, 16, 4
    proj = 2 * d * 6144 + 2 * d * 1024
    per = 2 * (proj + k * 3 * d * Fe + d * E) + 4 * 48 * 128 * 1
    assert counting.token_flops(x, layers, 1, False) == 8 * per


@pytest.mark.parametrize("start,end", [(0, 1), (0, 57), (16, 200)])
def test_prompt_flops_is_the_sum_of_its_tokens(start, end):
    g, layers = _model("granite-3-2b")
    want = sum(counting.token_flops(g, layers, p + 1, p == end - 1)
               for p in range(start, end))
    assert counting.prompt_flops(g, layers, start, end, True) \
        == pytest.approx(want)
    assert counting.prompt_flops(g, layers, start, end, False) \
        == pytest.approx(want - 2 * 2048 * 49155)
