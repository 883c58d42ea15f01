"""Architecture families: a new one comes in as files alone, ``decoder``
refuses what its reference does not compute and draws the weights it
drew before it was a family, and the counting takes a window."""
import copy
import dataclasses
import hashlib
import json
import shutil
import types
from pathlib import Path

import pytest
import torch

from qlm_bench import counting, families, harness
from qlm_bench.tests.small import SEED, one_thread, small

FIXTURE = Path(__file__).resolve().parent / "family_qkv_bias.py"


def _tiny_qwen(family: str) -> tuple:
    """(spec, config, traffic): granite's small cell with the port's
    qwen1.5-32b block (q/k/v biases, 4 heads on 4) at its published
    rotary base and norm epsilon, under ``family``."""
    spec, config, traffic = small("granite-3-2b.mixed-slo")
    config = copy.deepcopy(config)
    config.update(name="tiny-qwen1.5", arch="qwen1.5-32b", family=family)
    config["model"].update(num_kv_heads=4, rope_theta=1000000.0,
                           rms_norm_eps=1e-6, tie_embeddings=False)
    return spec, config, traffic


def _tree(bench: Path) -> dict:
    return {p: p.read_bytes() for p in bench.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_family_comes_in_as_files(tmp_path):
    """A family module and a configuration that names it, dropped into a
    copy, run ``correct`` on the port's paged path; no file changes."""
    bench = tmp_path / "qlm_bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec, config, traffic = _tiny_qwen("qkv-bias-decoder")
    shutil.copy(FIXTURE, bench / "families" / "qkv-bias-decoder.py")
    (bench / "configs" / "tiny-qwen1.5.json").write_text(json.dumps(config))
    (bench / "traffic" / "short.json").write_text(json.dumps(traffic))
    spec = copy.deepcopy(spec)
    spec["workloads"].append({"name": "tiny-qwen1.5.short",
                              "config": "tiny-qwen1.5", "traffic": "short",
                              "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    before = _tree(harness.BENCH)

    assert harness.model_config(config, bench).qkv_bias
    family = families.of(config, bench)
    params = family.make_weights(config["model"], SEED, torch.float32,
                                 torch.device("cpu"))
    assert params["blocks"][0]["attn"]["bq"].abs().max() > 0.1
    tokens = torch.arange(40) % 500
    with one_thread():
        biased = family.logits(config["model"], params, tokens)
        plain = families.load("decoder").logits(config["model"], params,
                                                tokens)
        out = harness.run_cell("tiny-qwen1.5.short", SEED, 1.0, False,
                               device="cpu", bench=bench)
    # the biases move the logits far beyond the limit: the port adds them
    assert (biased - plain).abs().max() > 100 * \
        config["check"]["limits"]["max_logit_gap"]
    assert out["correct"], out["checks"]
    assert out["checks"]["requests_compared"]["value"] >= 1
    assert _tree(harness.BENCH) == before


@pytest.mark.parametrize("arch,sizes", [
    ("qwen1.5-32b", {}),                    # q/k/v biases
    ("h2o-danube-1.8b", {}),                # a sliding window
    ("granite-3-2b", {"kv_quant": True}),   # int8 KV
    ("mamba2-130m", {}),                    # an SSM
    ("zamba2-1.2b", {}),                    # a hybrid
])
def test_the_decoder_refuses_what_its_reference_does_not_compute(arch,
                                                                  sizes):
    config = {"name": arch, "arch": arch, "family": "decoder",
              "model": sizes}
    with pytest.raises(ValueError, match="the reference computes"):
        harness.model_config(config)


def test_the_tiny_qwen_is_refused_by_the_decoder():
    _, config, _ = _tiny_qwen("decoder")
    with pytest.raises(ValueError, match="the reference computes"):
        harness.model_config(config)


def test_a_configuration_names_its_family():
    _, config, _ = small("granite-3-2b.mixed-slo")
    harness.model_config(config)
    del config["family"]
    with pytest.raises(ValueError, match='"family"'):
        harness.model_config(config)
    with pytest.raises(ValueError, match='"family"'):
        harness.make_params(config, SEED, "cpu")


def _digest(tree) -> str:
    """sha256 over every leaf's path, shape, dtype and bytes, in key
    order."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            h.update(path.encode())
            h.update(str(tuple(node.shape)).encode() + str(node.dtype)
                     .encode())
            h.update(node.contiguous().view(torch.uint8).numpy().tobytes())

    walk(tree, "")
    return h.hexdigest()


# ``weights.make_weights`` of the tree before the decoder family held it,
# at the small cells' sizes, on the CPU, from ``small.SEED``
PARENT_DIGESTS = {
    ("granite-3-2b.mixed-slo", torch.float32):
        "8e2a0401b8fabc7f8eb8d26c1b2e3d13a4b68be725b35c91dde061e7f71ce676",
    ("granite-3-2b.mixed-slo", torch.bfloat16):
        "ca6f0056c2dc0c68d19af129425bbc678ef846de442050ec009421cd217c69b2",
    ("dbrx-132b-8of40.mixed-slo", torch.float32):
        "ef72bbf5d629c6e7c97108d2907d160a4e98fb549c44e28f2f81336fd445ac62",
    ("dbrx-132b-8of40.mixed-slo", torch.bfloat16):
        "2a85c67569345a371326383d51c18fa40128235b49c983b46a67b9cca0968d0b",
}


@pytest.mark.parametrize("cell,dtype", list(PARENT_DIGESTS),
                         ids=lambda v: str(v).replace("torch.", ""))
def test_the_decoder_draws_the_weights_bit_for_bit(cell, dtype):
    _, config, _ = small(cell)
    params = families.of(config).make_weights(config["model"], SEED, dtype,
                                              torch.device("cpu"))
    assert _digest(params) == PARENT_DIGESTS[(cell, dtype)]


# --- counting with a window --------------------------------------------

H, KVH, D = 32, 8, 128


def test_a_window_over_every_context_counts_as_none():
    ctx = [100, 28, 4000, 1]
    assert counting.decode_least_s(2, H, KVH, D, ctx, 4000) \
        == counting.decode_least_s(2, H, KVH, D, ctx)
    starts, valid = [0, 5, 3900, 128], [128, 3, 100, 128]
    assert counting.prefill_least_s(2, H, KVH, D, starts, valid, 4000) \
        == counting.prefill_least_s(2, H, KVH, D, starts, valid)
    m = harness.load_json("configs", "granite-3-2b")["model"]
    full = [(40, 32, 8, 64, None)]
    wide = [(40, 32, 8, 64, 4096)]
    for c in (0, 1, 700, 4096):
        assert counting.token_flops(m, wide, c, True) \
            == counting.token_flops(m, full, c, True)
    for a, b in ((0, 1), (16, 200), (0, 4096)):
        assert counting.prompt_flops(m, wide, a, b, True) \
            == counting.prompt_flops(m, full, a, b, True)


def test_a_decode_past_the_window_counts_the_window():
    W = 1024
    assert counting.decode_least_s(2, H, KVH, D, [5000, 3000, 700], W) \
        == counting.decode_least_s(2, H, KVH, D, [W, W, 700])
    # by hand: 64 sequences of 5000 keys read 1024 each
    assert counting.decode_least_s(2, H, KVH, D, [5000] * 64, W) \
        == pytest.approx(max(
            (2 * 64 * H * D * 2 + 2 * 64 * W * KVH * D * 2) / 3.35e12,
            4 * H * D * 64 * W / 989e12))


def test_a_windowed_prefill_by_hand():
    W = 1024
    # a chunk of 128 after 2000 cached: every query reads W keys, of which
    # W - 1 cached keys are read at all
    nbytes = (128 + 128) * H * D * 2 + 2 * (W - 1) * KVH * D * 2 \
        + 2 * 128 * KVH * D * 2
    flops = 4 * H * D * 128 * W
    assert counting.prefill_least_s(2, H, KVH, D, [2000], [128], W) \
        == pytest.approx(max(nbytes / 3.35e12, flops / 989e12))
    # the keys of every span of contexts, against a count one by one
    for a, b, w in ((0, 5, 3), (1000, 1050, W), (0, 2048, W), (10, 11, 4),
                    (3000, 3100, W), (7, 9, 9), (0, 0, 5)):
        assert counting.keys(a, b, w) \
            == sum(min(c, w) for c in range(a + 1, b + 1))
        assert counting.keys(a, b, None) == sum(range(a + 1, b + 1))


def test_mixed_layers_count_the_sum_of_their_groups():
    """Mellum2-12B-A2.5B's layout: 21 layers over a window of 1,024 and 7
    over the whole context."""
    m = {"d_model": 2304, "vocab_size": 98304, "d_ff": 896 * 8}
    win, full = (21, 32, 4, 128, 1024), (7, 32, 4, 128, None)
    for c in (1, 1024, 3000):
        assert counting.token_flops(m, [win, full], c, False) \
            == pytest.approx(counting.token_flops(m, [win], c, False)
                             + counting.token_flops(m, [full], c, False))
    for a, b in ((0, 57), (900, 1200), (0, 4000)):
        assert counting.prompt_flops(m, [win, full], a, b, False) \
            == pytest.approx(counting.prompt_flops(m, [win], a, b, False)
                             + counting.prompt_flops(m, [full], a, b, False))


@dataclasses.dataclass
class _Model:
    prefill_chunk_paged: object
    decode_step_paged: object


def test_the_ledger_counts_each_group():
    """The wrapped model's decode and prefill launches add ``count`` least
    times of each group, at its window."""
    slot = types.SimpleNamespace(max_new_tokens=10, generated=0,
                                 prompt_len=3000)
    eng = types.SimpleNamespace(
        lengths=[2999, 10], slots=[slot, slot], prefill_pos=[2000, 0],
        decode_slots=lambda: [0, 1], prefilling_slots=lambda: [0],
        cfg=types.SimpleNamespace(prefill_chunk_tokens=128))
    win, full = (21, 32, 4, 128, 1024), (7, 32, 4, 128, None)
    ledger = harness.Ledger(engine=eng, on=True)
    model = harness.wrapped(_Model(lambda *a: None, lambda *a: None),
                            ledger, 2, [win, full])
    model.decode_step_paged(None, None, None, None, None)
    model.prefill_chunk_paged(None, None, torch.zeros(1, 128), None, None,
                              None)
    ctx = [3000, 11]
    assert ledger.decode_least_s == pytest.approx(
        21 * counting.decode_least_s(2, 32, 4, 128, ctx, 1024)
        + 7 * counting.decode_least_s(2, 32, 4, 128, ctx))
    assert ledger.prefill_least_s == pytest.approx(
        21 * counting.prefill_least_s(2, 32, 4, 128, [2000], [128], 1024)
        + 7 * counting.prefill_least_s(2, 32, 4, 128, [2000], [128]))
    assert ledger.decode_launches == ledger.prefill_launches == 28
