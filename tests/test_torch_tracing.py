"""The port's span recorder (``repro_torch/tracing.py``) and what the
program records with it: spans only under a profiler, nested with their
parents, threads and counts, on the clock of the profiler's events; the
engine's round phases and a burst's iterations; the MoE layer's four
parts; and ``Request.admit_time``, stamped once at first admission."""
import dataclasses
import threading

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_arch
from repro_torch.core.request import Request
from repro_torch.models import build_model
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig


@pytest.fixture
def profiled():
    """A CPU ``torch.profiler`` session over the test's block, the
    recorder emptied first; yields the profiler."""
    tracing.clear()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])

    class Session:
        def __enter__(self):
            prof.start()
            return prof

        def __exit__(self, *exc):
            prof.stop()
    return Session()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_nothing_is_recorded_without_a_profiler():
    tracing.clear()
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("a", req=1), tracing.span("b")
    assert a is b                       # one shared no-op context
    with a:
        with tracing.span("inner"):
            pass
    pulled = tracing.spanned("pull", req=lambda r: r)(lambda: 3)
    assert pulled() == 3
    assert tracing.records() == []


def test_spans_nest_with_parents_threads_and_counts(profiled):
    others = []

    @tracing.spanned("sibling", req=lambda r: r)
    def sibling(r):
        return r

    def elsewhere():                    # no profiler on this thread
        with tracing.span("elsewhere"):
            others.append(threading.get_ident())

    with profiled:
        with tracing.span("outer", req=7):
            with tracing.span("mid", rows=3, padded=8):
                with tracing.span("leaf", iters=4):
                    pass
            assert sibling(5) == 5
            assert sibling(None) is None
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive() and others
    recs = _by_name(tracing.records())
    assert sorted(recs) == ["leaf", "mid", "outer", "sibling"]
    outer, mid = recs["outer"][0], recs["mid"][0]
    leaf, (sib, sib_none) = recs["leaf"][0], recs["sibling"]
    assert outer.parent == -1
    assert mid.parent == outer.id == sib.parent == sib_none.parent
    assert leaf.parent == mid.id
    assert {r.tid for rs in recs.values() for r in rs} \
        == {threading.get_ident()}
    assert outer.counts == {"req": 7}
    assert mid.counts == {"rows": 3, "padded": 8}
    # a decorated function's count comes from its result, none from None
    assert leaf.counts == {"iters": 4}
    assert sib.counts == {"req": 5} and sib_none.counts == {}
    for child, parent in ((mid, outer), (leaf, mid), (sib, outer)):
        assert parent.start_ns <= child.start_ns <= child.end_ns \
            <= parent.end_ns
    # children end, and are recorded, before their parents
    order = [r.name for r in tracing.records()]
    assert order.index("leaf") < order.index("mid") < order.index("outer")


def test_the_clock_is_the_profilers(profiled):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profiled as prof:
        with tracing.span("mm"):
            torch.mm(a, b)
    (rec,) = tracing.records()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert rec.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= rec.end_ns


def _tiny_engine(clock=None, **kw):
    cfg = get_arch("granite-3-2b").reduced(num_layers=1, d_model=64,
                                           num_heads=4, num_kv_heads=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    ecfg = EngineConfig(device="cpu", max_slots=4, max_seq_len=96,
                        block_size=8, prefill_chunk_tokens=16, **kw)
    extra = {} if clock is None else {"clock": clock}
    return ContinuousBatchingEngine(model, params, ecfg, model_name="m",
                                    **extra)


def _request(n, seed, new=9):
    prompt = [(seed * 31 + 7 * i) % 200 + 1 for i in range(n)]
    return Request(prompt_tokens=prompt, model="m", slo=1e9,
                   max_new_tokens=new)


def test_an_engine_run_records_its_round_phases(profiled):
    torch.manual_seed(0)
    eng = _tiny_engine(decode_burst=4)
    reqs = [_request(n, i) for i, n in enumerate((20, 35, 9))]
    with profiled:
        for r in reqs:
            assert eng.admit(r)
        while eng.num_active():
            eng.steps()
    recs = _by_name(tracing.records())
    for phase in ("prepare", "launch", "wait", "commit"):
        for kind in ("prefill", "decode"):
            assert f"engine.{kind}.{phase}" in recs, (kind, phase)
    assert sorted(r.counts["req"] for r in recs["engine.admit"]) \
        == sorted(r.req_id for r in reqs)
    # every prompt row advanced once; every round computes 4 x bucket rows
    pre = recs["engine.prefill.launch"]
    assert sum(r.counts["rows"] for r in pre) \
        == sum(r.prompt_len for r in reqs)
    assert all(r.counts["padded"] % 4 == 0
               and r.counts["padded"] >= r.counts["rows"] for r in pre)
    assert len(pre) == eng.stats.prefill_chunks
    # single steps (beside prefill) and bursts: iters sum to the engine's
    # decode iterations, and a burst launches its n at once
    iters = [r.counts["iters"] for r in recs["engine.decode.launch"]]
    assert 1 in iters and max(iters) > 1
    assert sum(iters) == eng.stats.decode_iterations
    # the four phases of a round follow one another, in order
    launch = recs["engine.decode.launch"][0]
    prep = max((r for r in recs["engine.decode.prepare"]
                if r.end_ns <= launch.start_ns), key=lambda r: r.end_ns)
    wait = min((r for r in recs["engine.decode.wait"]
                if r.start_ns >= launch.end_ns), key=lambda r: r.start_ns)
    commit = min((r for r in recs["engine.decode.commit"]
                  if r.start_ns >= wait.end_ns), key=lambda r: r.start_ns)
    assert prep.end_ns <= launch.start_ns <= launch.end_ns \
        <= wait.start_ns <= wait.end_ns <= commit.start_ns


@pytest.mark.parametrize("groups", [0, 2])
def test_the_moe_layer_records_its_four_parts(profiled, groups):
    cfg = get_arch("qwen3-moe-30b-a3b").reduced(num_layers=1, d_model=32,
                                                num_heads=4, num_kv_heads=2)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, experts_per_token=2, d_ff_expert=16,
        dispatch_groups=groups))
    params = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                      torch.device("cpu"))
    x = torch.randn(2, 8, 32)
    out_plain, _ = apply_moe(params, cfg, x)
    with profiled:
        with tracing.span("engine.decode.launch", iters=1):
            out, _ = apply_moe(params, cfg, x)
    assert torch.equal(out, out_plain)
    recs = tracing.records()
    top = [r for r in recs if r.name == "engine.decode.launch"][0]
    assert [r.name for r in recs if r.parent == top.id] \
        == ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


def test_admit_time_is_set_once_at_first_admission():
    now = [10.0]
    eng = _tiny_engine(clock=lambda: now[0])
    req = _request(20, 1)
    waiting = _request(12, 2)
    assert req.admit_time is None
    now[0] = 12.5
    assert eng.admit(req)
    assert req.admit_time == 12.5
    eng.steps()                         # a first chunk round
    now[0] = 14.0
    slot = eng.slots.index(req)
    eng.evict_slot(slot)
    assert req.admit_time == 12.5 and req.snapshot is not None
    now[0] = 15.0
    assert eng.admit(req)               # resumed from its snapshot
    assert eng.stats.resumes == 1 and req.admit_time == 12.5
    while eng.num_active():
        eng.steps()
    req.restart()
    assert req.admit_time == 12.5
    assert waiting.admit_time is None
