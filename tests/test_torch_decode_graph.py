"""The paged decode step replayed as a CUDA graph (``models/decode_graph.py``).

On the CPU: the step never reaches ``torch.cuda``'s graphs and gives the
eager step's tokens; through a fake capture, the graphs' own buffers carry
an engine's tokens, lengths and block tables through slots that retire,
join and grow their tables, single steps and bursts of 4 and a swap, to
the eager engine's tokens; one capture a key, never one a round; the
registry holds its pools and params trees weakly, an entry dies with
either, and a tree that shares the table but not every leaf captures
anew; engines on eight threads get one graph each, and the launch
counters count each step once while other threads capture; a capture
records its launches on its own thread only; the spans of a capture and
a replay.

On the card (marked ``cuda``; skip without one): the same engine mixes on
small dense and MoE models against the eager engine, tokens exactly; a
replay's logits equal the eager step's on the same inputs, bit for bit;
the kernels' launch counters count a step once a layer; engines on
three threads capture while the others serve, and count the eager
engines' launches; a call inside
someone else's capture runs eagerly; a dropped engine gives back its
graph's memory with its page pool.  These import no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_decode_graph.py
"""
import dataclasses
import gc
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_arch
from repro_torch.core.request import Request
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.models import build_model, decode_graph
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

ARCHS = {"dense": "granite-3-2b", "moe": "dbrx-132b"}
# (prompt length, new tokens, round at which it arrives)
MIX = [(5, 20, 0), (19, 9, 0), (12, 30, 2), (3, 14, 5), (26, 11, 9),
       (9, 17, 14), (40, 6, 15)]


def _model(kind, device, dtype, seed=1, d_model=64):
    model = build_model(get_arch(ARCHS[kind]).reduced(
        num_layers=2, d_model=d_model, num_heads=4, num_kv_heads=2))
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, model.init(gen, dtype, device)


def _eager(model):
    """``model`` with its decode step run op by op on every call."""
    return dataclasses.replace(model,
                               decode_step_paged=model.decode_step_paged.eager)


def _engine(model, params, device, dtype, burst, max_seq_len=96):
    return ContinuousBatchingEngine(model, params, EngineConfig(
        device=device, dtype=dtype, max_slots=4, max_seq_len=max_seq_len,
        prefill_chunk_tokens=16, block_size=8, decode_burst=burst),
        model_name="m")


def _serve(eng, seed=7, mix=MIX):
    """``mix`` on ``eng``: requests arrive at their rounds and wait for a
    free slot, so slots retire and others join mid-decode, and block
    tables grow past block boundaries.  Returns the token streams."""
    rng = np.random.default_rng(seed)
    reqs = [(Request(prompt_tokens=rng.integers(0, 500, p).tolist(),
                     model="m", slo=1e9, max_new_tokens=n), at)
            for p, n, at in mix]
    waiting = list(reqs)
    for rnd in range(400):
        while waiting and waiting[0][1] <= rnd and eng.admit(waiting[0][0]):
            waiting.pop(0)
        eng.steps()
        if not waiting and all(r.finished() for r, _ in reqs):
            break
    assert all(r.finished() for r, _ in reqs)
    return [list(r.output_tokens) for r, _ in reqs]


def _serve_and_swap(model, params, params2, device, dtype, burst):
    """``MIX`` on ``params``, a swap to ``params2``, ``MIX`` again."""
    eng = _engine(model, params, device, dtype, burst)
    first = _serve(eng)
    eng.swap_model(model, params2, "m")
    return first + _serve(eng, seed=8)


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

class _Refused:
    def __init__(self, *a, **k):
        raise AssertionError("a CPU step reached torch.cuda's graphs")


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("burst", [1, 4])
def test_the_cpu_step_never_reaches_cuda_graphs(monkeypatch, kind, burst):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Refused)
    monkeypatch.setattr(torch.cuda, "graph", _Refused)
    monkeypatch.setattr(decode_graph, "_capture", _Refused)
    model, params = _model(kind, "cpu", torch.float32)
    _, params2 = _model(kind, "cpu", torch.float32, seed=2)
    n = decode_graph.captures
    got = _serve_and_swap(model, params, params2, "cpu", torch.float32, burst)
    want = _serve_and_swap(_eager(model), params, params2, "cpu",
                           torch.float32, burst)
    assert got == want
    assert decode_graph.captures == n


class _FakeGraph:
    """A capture on the CPU: ``replay`` runs the step on the graph's own
    input buffers and writes its logits into the graph's output buffer,
    as a replay of the captured kernels would (its launches recorded
    apart, as a replay's run no Python)."""
    replays = 0

    def __init__(self, run, logits):
        self.run, self.logits = run, logits

    def replay(self):
        _FakeGraph.replays += 1
        with pda.recording():
            self.logits.copy_(self.run())


def _fake_capture(run, device):
    """``decode_graph._capture`` on the CPU (this fake holds the pool and
    the params strongly: it keeps every entry it makes alive)."""
    logits = run()
    return _FakeGraph(run, logits), logits


@pytest.fixture
def faked(monkeypatch):
    monkeypatch.setattr(decode_graph, "_replayable", lambda *a: True)
    monkeypatch.setattr(decode_graph, "_capture", _fake_capture)


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("burst", [1, 4])
def test_replays_through_the_graphs_buffers_give_the_eager_tokens(
        faked, kind, burst):
    model, params = _model(kind, "cpu", torch.float32)
    _, params2 = _model(kind, "cpu", torch.float32, seed=2)
    n, r = decode_graph.captures, _FakeGraph.replays
    got = _serve_and_swap(model, params, params2, "cpu", torch.float32, burst)
    want = _serve_and_swap(_eager(model), params, params2, "cpu",
                           torch.float32, burst)
    assert got == want
    # one capture a key: the first pool and params, then the swap's
    assert decode_graph.captures - n == 2
    assert _FakeGraph.replays - r > 50


def _inputs(B, nb, n_blocks=16):
    return (torch.arange(B, dtype=torch.int32),
            torch.full((B,), 3, dtype=torch.int32),
            torch.arange(B * nb, dtype=torch.int32).reshape(B, nb) % n_blocks)


class _Token:
    """A captured graph that holds neither the pool nor the params."""


def test_one_graph_a_key_and_each_dies_with_its_pool_or_params(monkeypatch):
    """Keyed by pool, params and the inputs' shapes and dtypes; the
    registry keeps neither a pool nor a params tree alive; a tree that
    shares the table but not every leaf does not replay the graph of the
    tree it came from, and its graph replaces that one."""
    made = []

    def capture(run, device):
        graph = _Token()
        made.append(weakref.ref(graph))
        return graph, torch.zeros(1)

    def live():
        return sum(ref() is not None for ref in made)

    monkeypatch.setattr(decode_graph, "_replayable", lambda *a: True)
    monkeypatch.setattr(decode_graph, "_capture", capture)
    monkeypatch.setattr(decode_graph.DecodeGraphs, "_replay",
                        staticmethod(lambda g, *a: "replayed"))
    model, params = _model("dense", "cpu", torch.float32)
    _, params2 = _model("dense", "cpu", torch.float32, seed=2)
    graphs = model.decode_step_paged
    pool = model.init_paged_cache(16, 8, torch.float32, "cpu")
    pool2 = model.init_paged_cache(16, 8, torch.float32, "cpu")

    def call(p, c, B=4, nb=3):
        return graphs(p, c, *_inputs(B, nb))[0]

    assert call(params, pool) != "replayed"             # captured
    assert call(params, pool) == "replayed"
    assert call(params, pool) == "replayed"
    assert call(params, pool, nb=5) != "replayed"       # a wider table
    assert call(params, pool, B=2) != "replayed"        # another batch
    assert call(params2, pool) != "replayed"            # other params
    assert call(params, pool2) != "replayed"            # another pool
    assert call(params, pool, nb=5) == "replayed"
    assert call(dict(params), pool) == "replayed"       # the same leaves
    assert len(made) == live() == 5
    # another tree with the same table: captured anew, in the old's place
    rebuilt = {**params, "blocks": params2["blocks"]}
    assert call(rebuilt, pool) != "replayed"
    assert call(rebuilt, pool) == "replayed"
    assert live() == 5 and made[0]() is None
    assert call(params, pool) != "replayed"
    assert len(made) == 7 and live() == 5 and made[5]() is None
    dead_pool = weakref.ref(pool2["k"])
    dead_params = weakref.ref(params2["embed"])
    del pool2, params2, rebuilt
    gc.collect()
    assert dead_pool() is None and dead_params() is None
    assert live() == 3
    del pool
    gc.collect()
    assert live() == 0


class _SlowGraph:
    """A capture on the CPU that takes a while (other threads run and
    replay meanwhile) and whose replays write -1."""

    def __init__(self, logits):
        self.logits = logits

    def replay(self):
        self.logits.fill_(-1.0)


def _slow_capture(run, device):
    logits = run()
    time.sleep(0.002)
    return _SlowGraph(logits), logits


def test_engines_on_threads_get_one_graph_each(monkeypatch):
    """Eight threads, each with a pool of its own, call one registry at
    once with a short switch interval: one capture a pool, none lost; the
    launch counters count every step once, each capture its own thread's
    launches alone, though the other threads launch and replay while it
    records."""
    layers = 3

    def step(params, cache, tokens, lengths, block_table):
        pda.count(layers)           # as the kernel counts: once a layer
        return tokens.float(), cache

    monkeypatch.setattr(decode_graph, "_replayable", lambda *a: True)
    monkeypatch.setattr(decode_graph, "_capture", _slow_capture)
    graphs = decode_graph.DecodeGraphs(step)
    params = {"embed": torch.zeros(2)}
    pools = [{"k": torch.zeros(2)} for _ in range(8)]
    got = [[] for _ in pools]
    n, launches = decode_graph.captures, pda.launches

    def serve(i):
        for _ in range(50):
            got[i].append(float(graphs(params, pools[i],
                                       *_inputs(4, 3))[0][1]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(len(pools))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert decode_graph.captures - n == len(pools)
    assert all(g == [1.0] + [-1.0] * 49 for g in got)     # eager, replays
    assert pda.launches - launches == len(pools) * 50 * layers
    for pool in pools:
        (g,) = graphs._graphs[pool["k"]][params["embed"]].values()
        assert g.launches == (layers, 0)


def test_a_recording_keeps_its_threads_launches_alone():
    """Inside ``recording()`` a thread's launches go to the recording;
    another thread's, meanwhile, to the counters."""
    before = (pda.launches, pda.quant_launches)
    other = threading.Thread(target=lambda: pda.count(5, 1))
    with pda.recording() as counts:
        pda.count(2)
        pda.count(quant=3)
        other.start()
        other.join()
    pda.count(1)
    assert counts == [2, 3]
    assert (pda.launches, pda.quant_launches) == (before[0] + 6,
                                                  before[1] + 1)


def test_a_capture_and_a_replay_record_their_spans(faked):
    model, params = _model("dense", "cpu", torch.float32)
    pool = model.init_paged_cache(16, 8, torch.float32, "cpu")
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            model.decode_step_paged(params, pool, *_inputs(4, 3))
    spans = [r for r in tracing.records() if r.name.startswith("model.")]
    assert [(r.name, r.counts) for r in spans] \
        == [("model.decode_capture", {})] \
        + [("model.decode_replay", {"replays": 1})] * 2


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("burst", [1, 4])
def test_an_engine_replays_the_eager_engines_tokens(dev, kind, burst,
                                                    monkeypatch):
    replays = []
    replay = decode_graph.DecodeGraphs._replay
    monkeypatch.setattr(decode_graph.DecodeGraphs, "_replay", staticmethod(
        lambda *a: replays.append(1) or replay(*a)))
    model, params = _model(kind, dev, torch.bfloat16, d_model=128)
    _, params2 = _model(kind, dev, torch.bfloat16, seed=2, d_model=128)
    n = decode_graph.captures
    pda.launches = 0
    eng = _engine(model, params, dev, torch.bfloat16, burst)
    got = _serve(eng)
    iters = eng.stats.decode_iterations
    assert decode_graph.captures - n == 1
    assert len(replays) == iters - 1
    # each step counted once a layer, the capture not at all
    assert pda.launches == 2 * iters
    eng.swap_model(model, params2, "m")
    got += _serve(eng, seed=8)
    assert decode_graph.captures - n == 2
    want = _serve_and_swap(_eager(model), params, params2, dev,
                           torch.bfloat16, burst)
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_a_replay_gives_the_eager_steps_logits(dev, kind):
    """The first call runs eagerly and captures; a replay on the same
    inputs (the cache rewritten with the same rows) and on new ones gives
    the eager step's logits, bit for bit."""
    model, params = _model(kind, dev, torch.bfloat16, d_model=128)
    pool = model.init_paged_cache(32, 8, torch.bfloat16, dev)
    rng = np.random.default_rng(3)

    def inputs(fill):
        tokens = torch.tensor(rng.integers(0, 500, 4), dtype=torch.int32,
                              device=dev)
        lengths = torch.tensor(fill, dtype=torch.int32, device=dev)
        table = torch.tensor(rng.permutation(32)[:24].reshape(4, 6),
                             dtype=torch.int32, device=dev)
        return tokens, lengths, table

    step = model.decode_step_paged
    args = inputs([0, 7, 30, 41])
    n = decode_graph.captures
    first, _ = step(params, pool, *args)
    assert decode_graph.captures == n + 1
    again, _ = step(params, pool, *args)
    assert torch.equal(first, again)
    for fill in ([1, 8, 31, 42], [47, 0, 12, 5]):
        args = inputs(fill)
        got, _ = step(params, pool, *args)
        want, _ = step.eager(params, pool, *args)
        assert torch.equal(got, want)
        assert got.data_ptr() != first.data_ptr()
    assert torch.equal(first, again)        # earlier results stay
    assert decode_graph.captures == n + 1


@pytest.mark.cuda
def test_a_call_inside_another_capture_runs_eagerly(dev):
    model, params = _model("dense", dev, torch.bfloat16, d_model=128)
    pool = model.init_paged_cache(32, 8, torch.bfloat16, dev)
    args = (torch.arange(4, dtype=torch.int32, device=dev),
            torch.full((4,), 9, dtype=torch.int32, device=dev),
            torch.arange(24, dtype=torch.int32, device=dev).reshape(4, 6))
    want, _ = model.decode_step_paged.eager(params, pool, *args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    n = decode_graph.captures
    with torch.cuda.graph(graph, stream=side):
        got, _ = model.decode_step_paged(params, pool, *args)
    graph.replay()
    torch.cuda.synchronize()
    assert decode_graph.captures == n
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_engines_on_threads_capture_while_the_others_serve(dev):
    """Three engines on one card, each on its own thread as in the
    threaded cluster: each captures its step while the others' rounds end
    in their timed-region synchronise, at a table wide enough (512 keys)
    for the split-KV kernel's arrival counters; each gives the eager
    engine's tokens, and together they count three times its launches,
    though the others launch and replay while one captures."""
    model, params = _model("dense", dev, torch.bfloat16, d_model=128)
    launches = pda.launches
    want = _serve(_engine(_eager(model), params, dev, torch.bfloat16, 4,
                          max_seq_len=512))
    eager_launches = pda.launches - launches
    launches = pda.launches
    engines = [_engine(model, params, dev, torch.bfloat16, 4,
                       max_seq_len=512) for _ in range(3)]
    got, errors = [None] * len(engines), []

    def serve(i):
        try:
            got[i] = _serve(engines[i])
        except Exception as exc:            # reported below, on the test
            errors.append(exc)

    n = decode_graph.captures
    threads = [threading.Thread(target=serve, args=(i,))
               for i in range(len(engines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert decode_graph.captures - n == len(engines)
    assert got == [want] * len(engines)
    assert pda.launches - launches == len(engines) * eager_launches > 0


@pytest.mark.cuda
def test_a_dropped_engine_gives_back_its_graph_and_pool(dev, monkeypatch):
    graphs = []
    capture = decode_graph._capture

    def kept(run, device):
        graph, logits = capture(run, device)
        graphs.append(weakref.ref(graph))
        return graph, logits

    monkeypatch.setattr(decode_graph, "_capture", kept)
    model, params = _model("dense", dev, torch.bfloat16, d_model=128)
    # the first engine allocates what stays for the process: the kernels'
    # arrival counters, cuBLAS's workspaces of the two streams
    _serve(_engine(model, params, dev, torch.bfloat16, 4))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = _engine(model, params, dev, torch.bfloat16, 4)
    pool = sum(t.numel() * t.element_size() for t in eng.cache.values())
    before_capture = torch.cuda.memory_allocated()
    _serve(eng)
    graph_bytes = torch.cuda.memory_allocated() - before_capture
    assert len(graphs) == 2 and graphs[0]() is None and graphs[1]()
    del eng
    gc.collect()
    torch.cuda.synchronize()
    assert graphs[1]() is None
    left = torch.cuda.memory_allocated() - base
    assert left <= max(graph_bytes, 0) and left < pool
