"""The metric arithmetic on synthetic timelines: a stall moves the ITL
tail and the TTFT tail, and the deadline rule decides who is judged."""
import types

import pytest

from qlm_bench import harness


def _req(first=None, dropped=False):
    r = types.SimpleNamespace(first_token_time=first)
    r.dropped = lambda: dropped
    return r


def _seen(due, cls, ttft_s, first=None, obs=(), prompt=10, dropped=False):
    return harness.Seen(_req(first, dropped), due, cls, ttft_s, prompt,
                        list(obs))


def _run(seen, window=(100.0, 130.0)):
    stats = ({"decode_time": 0.0, "decode_iterations": 0},
             {"decode_time": 1.5, "decode_iterations": 30})
    return harness.Run({}, window[1] - window[0], window, seen, stats, 0.2,
                       100, (5, 5))


def _metric(name):
    return harness.reader(name)


def _streams(stall=0.0):
    """Ten requests decoding a token every 0.1 s; with ``stall`` the one
    round at t=110 takes that much longer for every one of them."""
    seen = []
    for i in range(10):
        obs, t = [], 101.0
        for n in range(1, 200):
            t += 0.1 + (stall if abs(t - 110.0) < 0.05 else 0.0)
            obs.append((t, n))
        seen.append(_seen(100.0 + i * 0.01, "batch2", 360.0, 101.0, obs))
    return seen


def test_a_stall_moves_itl_p99():
    read, _ = _metric("itl_p99_ms")
    base = read(_run(_streams()), None)
    assert base == pytest.approx(100.0, rel=1e-6)
    # one stalled round a request: 1 gap in ~199, under the 99th
    # percentile; three stalls are over it
    seen = _streams()
    for s in seen:
        s.obs = [(t + (2.0 if t > 110 else 0) + (2.0 if t > 115 else 0)
                  + (2.0 if t > 120 else 0), n) for t, n in s.obs]
    assert read(_run(seen), None) > 1000.0


def test_itl_excludes_the_first_token_and_shares_a_burst():
    read, _ = _metric("itl_p99_ms")
    # first observation brings 2 tokens (prefill token + a decode): no gap;
    # then 4 tokens in 0.2 s: four gaps of 50 ms
    s = _seen(100.0, "batch2", 360.0, 101.0,
              [(101.0, 2), (101.2, 6)])
    assert read(_run([s]), None) == pytest.approx(50.0)


def test_deadline_rule_and_misses():
    read, _ = _metric("slo_attainment")
    we = 130.0
    seen = [
        _seen(110.0, "interactive", 2.0, first=111.0),   # met
        _seen(110.0, "interactive", 2.0, first=113.0),   # late: miss
        _seen(111.0, "batch1", 6.0, first=None, dropped=True),  # refused
        _seen(128.5, "interactive", 2.0, first=None),    # deadline past we
        _seen(125.0, "batch1", 6.0, first=None),         # deadline past we
        _seen(100.0, "batch2", 360.0, first=101.0),      # never judged
        _seen(95.0, "interactive", 2.0, first=96.0),     # due before window
        _seen(120.0, "interactive", 2.0, first=None),    # unserved: miss
    ]
    assert read(_run(seen, (100.0, we)), None) == pytest.approx(100.0 / 4)


def test_interactive_ttft_tail_counts_the_unserved():
    read, _ = _metric("interactive_ttft_p90_s")
    seen = [_seen(100.0 + i, "interactive", 2.0, first=100.0 + i + 0.5)
            for i in range(20)]
    assert read(_run(seen), None) == pytest.approx(0.5)
    # a stall: four of them wait 6 s, two are unserved at the window's end
    for s in seen[:4]:
        s.req.first_token_time = s.due + 6.0
    seen.append(_seen(110.0, "interactive", 2.0, first=None))
    seen.append(_seen(112.0, "interactive", 2.0, first=None))
    assert read(_run(seen), None) > 5.9
    # a qualified name reads the same number through the same file
    read_q, q = _metric("interactive_ttft_p90_s.granite-3-2b")
    assert q == "granite-3-2b" and read_q(_run(seen), q) == read(_run(seen),
                                                                  None)


def test_tokens_per_s_counts_prefill_progress_and_window_tokens():
    read, _ = _metric("tokens_per_s")
    a = _seen(99.0, "batch2", 360.0, 99.5, [(99.5, 1), (100.5, 5)],
              prompt=1000)                 # prompt before the window; 4 in
    a.pre = [(99.0, 600), (99.5, 1000)]
    b = _seen(101.0, "batch2", 360.0, 102.0, [(102.0, 1), (104.0, 3),
                                              (131.0, 9)], prompt=30)
    b.pre = [(102.0, 30)]
    # a long prompt prefilled across the window's start: 512 tokens before
    # it, the rest inside; a cached prefix counts when first seen
    c = _seen(96.0, "batch1", 6.0, 104.0, [(104.0, 1)], prompt=800)
    c.pre = [(97.0, 256), (99.0, 512), (102.0, 768), (104.0, 800)]
    d = _seen(120.0, "batch1", 6.0, None, [], prompt=500)
    d.pre = [(121.0, 128)]                 # still prefilling at the end
    want = 4 + (30 + 3) + (288 + 1) + 128
    assert read(_run([a, b, c, d]), None) == pytest.approx(want / 30.0)


def test_counters_per_window():
    run = _run([_seen(101.0, "batch2", 360.0, 102.0, [(102.0, 1)])])
    assert _metric("decode_round_ms")[0](run, None) == pytest.approx(50.0)
    assert _metric("controller_ms_per_tick")[0](run, None) \
        == pytest.approx(2.0)
    # nothing to read: the reader returns nothing, never 0
    assert _metric("device_idle_share")[0](run, None) is None
    assert _metric("paged_decode_attention_roofline")[0](run, None) is None
