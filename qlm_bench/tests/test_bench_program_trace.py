"""The program's spans read beside the device trace (``program_trace.py``)
and the metrics read from them: on hand-built events a kernel goes under
the innermost span open at its launch, an idle gap under the spans open
when it began, and events outside the slice count for nothing; a traced
small CPU run of each cell reports the program-span metrics and the
queue wait, and nothing for the device-only ones; the spans' counts
match the ledger's and the harness's own numbers."""
import types

import pytest
import torch

from qlm_bench import harness, program_trace
from qlm_bench.tests.small import run_small
from repro_torch import tracing
from repro_torch.tracing import Record

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """The part of a kineto event that ``program_trace`` reads."""

    def __init__(self, name, on_card, start, dur, corr):
        self._v = (name, CUDA if on_card else CPU, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


NS0, NS1 = 1000, 2000


def _records():
    r = lambda i, name, a, b, parent=-1, **c: Record(i, name, a, b, parent,
                                                     1, c)
    return [r(0, "engine.decode.prepare", 1000, 1100),
            r(2, "moe.dispatch", 1200, 1300, 1),
            r(3, "moe.experts", 1300, 1400, 1),
            r(1, "engine.decode.launch", 1100, 1500, iters=2),
            r(4, "engine.decode.wait", 1500, 1700),
            r(5, "engine.decode.commit", 1700, 1800),
            r(6, "qlm.tick", 1800, 1900)]


def _events():
    launch = lambda corr, t: Event("cudaLaunchKernel", False, t, 5, corr)
    kernel = lambda corr, a, b: Event(f"kernel{corr}", True, a, b - a, corr)
    return [launch(1, 1210), kernel(1, 1250, 1350),     # in moe.dispatch
            launch(2, 1310), kernel(2, 1400, 1480),     # in moe.experts
            launch(3, 1450), kernel(3, 1480, 1560),     # in the launch
            Event("cudaMemcpyAsync", False, 1600, 5, 4),
            kernel(4, 1600, 1650),                      # in the wait
            launch(5, 500), kernel(5, 900, 950),        # before the slice
            launch(6, 1790), kernel(6, 1950, 2100),     # past its end
            Event("aten::mm", False, 1220, 30, 0)]      # a host op


def test_attribution_on_hand_built_events():
    pt = program_trace.attribute(_records(), _events(), NS0, NS1)
    dev = pt["device_by_chain"]
    launch = ("engine.decode.launch",)
    assert dev == {("moe.dispatch",) + launch: pytest.approx(100e-9),
                   ("moe.experts",) + launch: pytest.approx(80e-9),
                   launch: pytest.approx(80e-9),
                   ("engine.decode.wait",): pytest.approx(50e-9),
                   ("engine.decode.commit",): pytest.approx(50e-9)}
    # the kernel before the slice counts for nothing, the last is clipped
    assert pt["device_s"] == pytest.approx(360e-9)
    # gaps: the lead (from the slice's start, in prepare), one that began
    # inside the launch (in moe.experts), two that began in the wait
    assert pt["idle_by_chain"] == {
        ("engine.decode.prepare",): pytest.approx(250e-9),
        ("moe.experts",) + launch: pytest.approx(50e-9),
        ("engine.decode.wait",): pytest.approx(40e-9 + 300e-9)}
    assert program_trace.under(dev, lambda n: n.startswith("engine.")) \
        == pytest.approx(360e-9)
    assert program_trace.innermost(pt["idle_by_chain"]) == {
        "engine.decode.prepare": pytest.approx(250e-9),
        "moe.experts": pytest.approx(50e-9),
        "engine.decode.wait": pytest.approx(340e-9)}
    assert pt["host_self_s"]["engine.decode.launch"] \
        == pytest.approx(200e-9)
    assert pt["counts"]["engine.decode.launch"] == {"iters": 2}


def test_a_kernel_without_its_launch_is_unjoined():
    events = [Event("kernel", True, 1100, 100, 9),
              Event("cudaLaunchKernel", False, 1050, 5, 1)]
    pt = program_trace.attribute(_records(), events, NS0, NS1)
    assert pt["device_by_chain"] == {None: pytest.approx(100e-9)}
    assert program_trace.innermost(pt["device_by_chain"]) \
        == {"unjoined": pytest.approx(100e-9)}
    # no launch event at all: nothing to join, so nothing is read
    pt = program_trace.attribute(_records(), events[:1], NS0, NS1)
    assert pt["device_by_chain"] is None
    assert pt["idle_by_chain"] is not None


def _metric(name, pt, window_s=1e-6):
    run = types.SimpleNamespace(program_trace=pt,
                                trace={"window_s": window_s})
    read, q = harness.reader(name)
    return read(run, q)


def test_the_readers_on_hand_built_events():
    pt = program_trace.attribute(_records(), _events(), NS0, NS1)
    assert _metric("decode_launch_ms", pt) == pytest.approx(1e3 * 400e-9 / 2)
    assert _metric("decode_device_ms", pt) == pytest.approx(1e3 * 360e-9 / 2)
    assert _metric("device_idle_launch_share", pt) == pytest.approx(5.0)
    assert _metric("moe_dispatch_share", pt) \
        == pytest.approx(100.0 * 100 / 180)
    # one tick, no solver span inside it
    assert _metric("solver_ms_per_tick", pt) == 0.0


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent of this change records no spans and stamps no
    admissions: every new reader returns nothing, and none raises."""
    monkeypatch.setattr(program_trace, "_records", lambda ns0, ns1: [])
    sl = types.SimpleNamespace(ns0=NS0, ns1=NS1, events=_events())
    run = harness.Run({}, 30.0, (100.0, 130.0), [], ({}, {}), 0.1, 10,
                      (0, 0), ledger=harness.Ledger(slice=sl),
                      trace={"window_s": 1.0, "busy_s": 0.5})
    req = types.SimpleNamespace(first_token_time=101.0)
    run.seen.append(harness.Seen(req, 100.5, "interactive", 2.0, 10))
    for name in ("decode_launch_ms", "decode_device_ms",
                 "device_idle_launch_share", "solver_ms_per_tick",
                 "moe_dispatch_share",
                 "interactive_queue_wait_p90_s.granite-3-2b"):
        read, q = harness.reader(name)
        assert read(run, q) is None, name


@pytest.fixture(scope="module", params=["granite-3-2b.mixed-slo",
                                        "dbrx-132b-8of40.mixed-slo"])
def traced(request):
    """A traced small CPU run of the cell, long enough that interactive
    requests are judged (the slice is the whole window there)."""
    torch.manual_seed(0)
    return request.param, run_small(request.param, traced=True,
                                    seconds=3.5)


def test_a_traced_small_run_reports_the_program_metrics(traced):
    cell, out = traced
    config = cell.split(".")[0]
    got = out["metrics"]
    assert out["correct"]
    for name in ("decode_launch_ms", "solver_ms_per_tick",
                 f"interactive_queue_wait_p90_s.{config}"):
        assert name in got, name
    # no card: nothing for what only a device trace can say
    for name in ("decode_device_ms", "device_idle_launch_share",
                 "moe_dispatch_share"):
        assert name not in got, name
    # a request is admitted before its first token
    assert got[f"interactive_queue_wait_p90_s.{config}"]["value"] \
        <= got[f"interactive_ttft_p90_s.{config}"]["value"]
    # the launch is inside the timed decode round
    assert 0 < got["decode_launch_ms"]["value"] \
        <= got["decode_round_ms"]["value"]


def test_the_chunk_rounds_rows_are_the_ledgers(traced):
    _, out = traced
    run = out["run"]
    counts = run.program_trace["counts"]["engine.prefill.launch"]
    assert counts["rows"] == run.ledger.useful_rows > 0
    assert counts["padded"] == run.ledger.computed_rows


def test_the_spans_of_a_request_share_its_id(traced):
    """``req`` on ``agent.pull`` and ``engine.admit``: every request a
    slot took in the window was pulled and admitted under its id."""
    _, out = traced
    run = out["run"]
    ws, we = run.window
    ids = {s.req.req_id for s in run.seen}
    spans = {}
    for r in tracing.records():
        if r.counts.get("req") in ids:
            spans.setdefault(r.name, set()).add(r.counts["req"])
    admitted = {s.req.req_id for s in run.seen
                if s.req.admit_time is not None
                and ws <= s.req.admit_time <= we}
    assert admitted
    assert admitted <= spans["agent.pull"]
    assert admitted <= spans["engine.admit"]


def test_the_controller_spans_fit_in_the_harness_time(traced):
    _, out = traced
    run = out["run"]
    host = run.program_trace["host_s"]
    spans = host["qlm.submit"] + host["qlm.tick"]
    assert 0 < spans <= run.controller_s
    assert run.program_trace["n"]["qlm.tick"] == run.ticks
