"""The reference against the port on the CPU at a reduced size: granite,
and dbrx dropless (capacity factor E / k), logits and served tokens."""
import copy
import types

import pytest
import torch

from qlm_bench import families, harness, reference
from qlm_bench.tests.small import one_thread, run_small, small


def _port_logits(config, params, tokens):
    from repro_torch.models import build_model
    model = build_model(harness.model_config(config))
    cache = model.init_cache(1, 256, torch.float32, "cpu")
    logits, _ = model.prefill(params, {"tokens": tokens[None]}, cache)
    return logits[0, :config["model"]["vocab_size"]]


@pytest.mark.parametrize("cell", ["granite-3-2b.mixed-slo",
                                  "dbrx-132b-8of40.mixed-slo"])
def test_reference_logits_match_the_port(cell):
    _, config, _ = small(cell)
    if "moe" in config["model"]:
        moe = config["model"]["moe"]
        moe["capacity_factor"] = moe["num_experts"] / moe["experts_per_token"]
    family = families.of(config)
    params = family.make_weights(config["model"], 7, torch.float32,
                                 torch.device("cpu"))
    tokens = torch.randint(0, 500, (40,), generator=torch.Generator()
                           .manual_seed(3))
    want = _port_logits(config, params, tokens)
    got = family.logits(config["model"], params, tokens, first=39)[0]
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), \
        (got - want).abs().max()


def test_dropless_needs_the_capacity_factor():
    """At the port's default capacity factor the dispatch drops pairs of
    a skewed batch and parts from the dropless reference; at E / k it
    does not (the configuration's assumed factor)."""
    from repro_torch.models import moe as port_moe
    _, config, _ = small("dbrx-132b-8of40.mixed-slo")
    m = config["model"]
    params = families.of(config).make_weights(m, 11, torch.float32,
                                              torch.device("cpu"))
    bp = params["blocks"][0]["moe"]
    x = torch.randn(1, 64, m["d_model"], generator=torch.Generator()
                    .manual_seed(5))
    x[:, :, 0] += 6.0          # every token routes alike: a skewed batch
    want = reference.moe(reference.Matmul("f32"), x[0], bp,
                         m["moe"]["experts_per_token"])
    cfg = harness.model_config(config)
    E, k = m["moe"]["num_experts"], m["moe"]["experts_per_token"]
    import dataclasses
    for factor, agrees in ((1.25, False), (E / k, True)):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
        got, _ = port_moe.apply_moe(bp, c, x)
        assert torch.allclose(got[0], want, atol=1e-4) == agrees, factor


@pytest.mark.parametrize("cell", ["granite-3-2b.mixed-slo",
                                  "dbrx-132b-8of40.mixed-slo"])
def test_a_small_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["requests_compared"]["value"] >= 1
    assert out["metrics"]["tokens_per_s"]["value"] > 0


def test_a_small_run_reports_its_page_pool():
    """The page pool's blocks and the most of them in use in the window,
    which the result line carries beside ``memory_peak_bytes``."""
    out = run_small("granite-3-2b.mixed-slo")
    pool = out["kv_pool"]
    assert pool["blocks"] == 4 * 256 // 16      # max_slots x max_seq_len
    assert 0 <= pool["in_use_end"] <= pool["in_use_peak"] <= pool["blocks"]
    assert pool["in_use_peak"] > 0


def test_the_control_is_not_correct():
    """The control: the reference in float8 in the port's place, judged by
    ``check.judge`` on the same sample of a sound small run, comes out not
    correct, where the port's tokens come out correct."""
    from qlm_bench import check
    spec, config, traffic = small("granite-3-2b.mixed-slo")
    config = copy.deepcopy(config)
    config["model"].update(d_model=128, num_heads=4, d_ff=256)
    params = harness.make_params(config, 5, "cpu")
    with one_thread():
        out = harness.measure(spec, "granite-3-2b.mixed-slo", config,
                              traffic, params, 5, 1.5, False, "cpu")
    window = out["run"].window
    port = check.judge(config, params, out["requests"], 5, window)
    control = check.judge(config, params, out["requests"], 5, window, "fp8")
    assert port["picked"] == control["picked"]
    assert sum(len(r.output_tokens) for r in port["picked"]) > 50
    assert port["correct"], port["checks"]
    assert not control["correct"], control["checks"]


def _done(req_id, at, prompt, out):
    r = types.SimpleNamespace(req_id=req_id, completion_time=at,
                              prompt_len=prompt, output_tokens=[1] * out)
    r.dropped = lambda: False
    return r


def test_the_sample_is_drawn_from_the_window():
    """Only requests that finished inside the window are compared, the
    longest of them always among them."""
    from qlm_bench import check
    reqs = [_done(0, 5.0, 4000, 10),            # before the window
            _done(1, 12.0, 900, 10),            # the window's longest
            _done(2, 15.0, 50, 10), _done(3, 18.0, 60, 10),
            _done(4, 25.0, 3000, 10),           # after it
            _done(5, None, 70, 3)]              # unfinished
    for seed in range(5):
        got = check.sample(reqs, seed, 3, 10_000, (10.0, 20.0))
        assert got[0].req_id == 1
        assert {r.req_id for r in got} == {1, 2, 3}
    assert check.sample(reqs, 0, 3, 10_000, (30.0, 40.0)) == []
