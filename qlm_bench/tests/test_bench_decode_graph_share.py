"""The ``decode_graph_share`` reader (``metrics/decode_graph_share.py``)
on hand-built span records, read as ``test_bench_program_trace.py`` reads
the other program-span metrics."""
import pytest

from qlm_bench import program_trace
from qlm_bench.tests.test_bench_program_trace import (NS0, NS1, _events,
                                                      _metric)
from repro_torch.tracing import Record


def test_the_decode_graph_share_on_hand_built_records():
    """Replays over decode iterations: a burst of 4 and a single step
    with 5 replays between them, where a graph's first call ran eagerly;
    nothing without a replay span (a program that replays no step)."""
    r = lambda i, name, a, b, parent=-1, **c: Record(i, name, a, b, parent,
                                                     1, c)
    records = [r(0, "engine.decode.launch", 1000, 1400, iters=4),
               r(1, "model.decode_capture", 1010, 1100, 0)]
    records += [r(2 + k, "model.decode_replay", 1100 + 50 * k,
                  1140 + 50 * k, 0, replays=1) for k in range(3)]
    records += [r(5, "engine.decode.launch", 1500, 1600, iters=1),
                r(6, "model.decode_replay", 1510, 1590, 5, replays=1)]
    events = _events()
    pt = program_trace.attribute(records, events, NS0, NS1)
    assert _metric("decode_graph_share", pt) == pytest.approx(100.0 * 4 / 5)
    pt = program_trace.attribute(records[:2] + records[-2:-1], events,
                                 NS0, NS1)
    assert _metric("decode_graph_share", pt) is None
    pt = program_trace.attribute(records[1:5], events, NS0, NS1)
    assert _metric("decode_graph_share", pt) is None
