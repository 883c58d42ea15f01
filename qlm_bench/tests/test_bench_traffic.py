"""The traffic drawn from a seed: deterministic, a Poisson process in the
order drawn, and every seed brings the same work with other tokens."""
import numpy as np

from qlm_bench import generator, harness

VOCAB = 49155


def _mix(name, **over):
    mix = harness.load_json("traffic", name)
    mix.update(over)
    return mix


def test_same_seed_same_schedule():
    mix = _mix("mixed-slo", rate=3.0)
    a = generator.schedule(mix, 2**31 + 5, 30.0, VOCAB)
    b = generator.schedule(mix, 2**31 + 5, 30.0, VOCAB)
    assert [(x.due, x.max_new_tokens, x.cls) for x in a] \
        == [(x.due, x.max_new_tokens, x.cls) for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_seeds_bring_the_same_work_with_other_tokens():
    mix = _mix("mixed-slo", rate=3.0)
    a = generator.schedule(mix, 1, 30.0, VOCAB)
    b = generator.schedule(mix, 2**31 + 2, 30.0, VOCAB)
    assert len(a) == len(b) > 0
    assert [(x.due, len(x.prompt), x.max_new_tokens, x.cls) for x in a] \
        == [(x.due, len(x.prompt), x.max_new_tokens, x.cls) for x in b]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b)
                   if len(x.prompt) > 4)


def test_poisson_arrivals_in_the_order_drawn():
    """Exponential gaps at the rate, and classes and mega prompts in their
    shares, drawn per request: nothing spreads the long requests out."""
    mix = _mix("mixed-slo", rate=5.0)
    xs = generator.schedule(mix, 7, 2000.0, VOCAB)
    horizon = mix["lead_in_s"] + 2000.0
    n = len(xs)
    assert abs(n - 5.0 * horizon) < 4 * np.sqrt(5.0 * horizon)
    gaps = np.diff([0.0] + [x.due for x in xs])
    assert abs(gaps.mean() - 0.2) < 0.01
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05   # exponential: cv 1
    for c in mix["classes"]:
        got = sum(x.cls == c["name"] for x in xs) / n
        assert abs(got - c["share"]) < 0.03
    mega = np.array([len(x.prompt) + x.max_new_tokens >= 2990
                     and x.max_new_tokens > 500 for x in xs])
    assert 0.08 < mega.mean() < 0.13
    # some ten arrivals in a row hold two mega prompts or more: the draw
    # is left as drawn
    runs = np.convolve(mega, np.ones(10, int), "valid")
    assert runs.max() >= 2 and runs.min() == 0


def test_mixed_slo_shape():
    mix = _mix("mixed-slo", rate=4.0)
    xs = generator.schedule(mix, 9, 40.0, VOCAB)
    horizon = mix["lead_in_s"] + 40.0
    assert 0 <= xs[0].due and xs[-1].due < horizon
    assert all(a.due <= b.due for a, b in zip(xs, xs[1:]))
    assert {x.cls for x in xs} == {"interactive", "batch1", "batch2"}
    mega = [x for x in xs if 2990 <= len(x.prompt) + x.max_new_tokens <= 4000
            and len(x.prompt) > 1000 and x.max_new_tokens > 500]
    assert mega
    assert all(len(x.prompt) <= 4096 for x in xs)
    assert all(0 <= x.prompt.min() and x.prompt.max() < VOCAB for x in xs)
    limits = {c["name"]: c["ttft_s"] for c in mix["classes"]}
    assert limits == {"interactive": 2.0, "batch1": 6.0, "batch2": 360.0}


def test_the_page_pool_holds_every_request_of_a_run():
    """Each cell's page pool holds every request of its run at once, so
    nothing is preempted, and its worst case is most of the pool."""
    spec = harness.load_spec()
    for cell in spec["workloads"]:
        config = harness.load_json("configs", cell["config"])
        eng = config["engine"]
        xs = generator.schedule(harness.traffic_of(cell), 1,
                                spec["run_seconds"],
                                config["model"]["vocab_size"])
        need = sum(-(-(len(x.prompt) + x.max_new_tokens + 1)
                     // eng["block_size"]) for x in xs)
        assert 0.8 * eng["kv_blocks"] <= need <= eng["kv_blocks"], cell
