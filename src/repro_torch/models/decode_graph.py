"""The paged decode step replayed as a CUDA graph.

``DecodeGraphs(step)`` is what ``Model.decode_step_paged`` holds for a
transformer, where ``step(params, cache, tokens, lengths, block_table)`` is
the eager step (``transformer.decode_step_paged``).  Eagerly, a step of a
40-layer model is some 4,000 PyTorch calls issued one by one from Python,
and on a card the host takes several times as long to issue them as the
card takes to run them.  A replay issues the same kernels, with the same
launch plans, as one graph launch.

On CUDA tensors that are not DTensors, outside another capture, the first
call of a key runs the step eagerly and returns its logits (which
allocates what a capture may not: the split-KV decode kernels' arrival
counters), and then captures the same step into a CUDA graph on a stream
of the device's own.  Every later call of that key copies ``tokens``,
``lengths`` and ``block_table`` into the graph's own buffers
(device-to-device, on the current stream, no host sync), replays the graph
and returns a copy of its logits, so no later call overwrites a tensor an
earlier call returned.  The replay updates the cache in place as the eager
step does.  Everything else runs the eager step as it is: CPU and meta
tensors, a mesh, and a call inside someone else's capture (which then
holds the step's kernels itself).

Key and lifetime.  A graph reads the addresses it was captured with: the
page pool's, every params leaf's and its own buffers'.  So there is one
graph per (page pool, params tree, shapes and dtypes of the three inputs),
the device being the pool's.  The pool is held weakly, by its ``"k"``
pages, and the tree weakly, by its ``"embed"`` table and a weak reference
to each of its leaves: an entry dies with its pool or its table, and its
graph and the graph's memory pool with it, so a dropped engine
(``launch/serve.py::calibrate_registry``'s) leaves nothing behind; a call
whose tree is not, leaf for leaf, the one captured (another tree sharing
the table, a leaf replaced) captures anew.  New values written into a
leaf in place are read by every replay.

Counts: ``captures``, in this process.  The paged decode kernels' launch
counters (``kernels/paged_decode_attention.py``) count the first call's
eager launches; a capture records its own launches on its thread, apart
from the counters, and each replay adds them, so the counters read as if
every step ran eagerly, whatever other threads launch meanwhile.  Spans
(``repro_torch/tracing.py``): ``model.decode_capture`` around a capture,
``model.decode_replay`` with ``replays=1`` around a replay.

Threads: one capture at a time in the process (PyTorch's rule for graph
captures), in ``thread_local`` mode, so the other threads' engines run on
meanwhile on the device's stream (their timed regions end in a
synchronise of that stream: a device-wide one is refused during a
capture); every eager call and replay runs on the caller's stream, so the
kernels' arrival counters are never used from two streams at once; the
registry takes a lock.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tracing
from repro_torch.kernels import paged_decode_attention as pda

captures = 0

_capture_lock = threading.Lock()
_streams: Dict[torch.device, torch.cuda.Stream] = {}   # capture stream


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    tokens: torch.Tensor
    lengths: torch.Tensor
    block_table: torch.Tensor
    logits: torch.Tensor
    launches: Tuple[int, int]   # the float and int8 paged decode launches
    leaves: Tuple[weakref.ref, ...]   # the params tree's, as captured


def _leaves(tree, out: list) -> list:
    """The tensors of a params tree of dicts, lists and tuples, in order,
    appended to ``out``."""
    for v in tree.values() if type(tree) is dict else tree:
        if type(v) in (dict, list, tuple):
            _leaves(v, out)
        else:
            out.append(v)
    return out


def _same_tree(refs: Tuple[weakref.ref, ...], params) -> bool:
    """Whether ``params`` holds, leaf for leaf, the tensors of ``refs``."""
    leaves = _leaves(params, [])
    return len(leaves) == len(refs) \
        and all(r() is t for r, t in zip(refs, leaves))


def _replayable(params, cache, tokens, lengths, block_table) -> bool:
    """Whether the call runs as a graph (see the module's docstring)."""
    ts = (cache["k"], params["embed"], tokens, lengths, block_table)
    return (tokens.is_cuda
            and not any(isinstance(t, DTensor) for t in ts)
            and all(t.device == tokens.device for t in ts)
            and not torch.cuda.is_current_stream_capturing())


def _capture(run: Callable[[], torch.Tensor], device: torch.device):
    """``run`` captured into a CUDA graph on the device's capture stream;
    returns the graph and the tensor ``run`` returned, which every replay
    rewrites."""
    side = _streams.get(device)
    if side is None:
        side = _streams[device] = torch.cuda.Stream(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        out = run()
    return graph, out


class DecodeGraphs:
    """``step`` with its CUDA-tensor calls replayed from graphs captured on
    first use, one per key (see the module's docstring)."""

    def __init__(self, step: Callable):
        self.eager = step
        self._lock = threading.Lock()
        # pool "k" pages -> params "embed" table -> key -> _Graph
        self._graphs: WeakIdKeyDictionary = WeakIdKeyDictionary()

    def __call__(self, params, cache, tokens: torch.Tensor,
                 lengths: torch.Tensor, block_table: torch.Tensor):
        if not _replayable(params, cache, tokens, lengths, block_table):
            return self.eager(params, cache, tokens, lengths, block_table)
        key = tuple((tuple(t.shape), t.dtype)
                    for t in (tokens, lengths, block_table))
        with self._lock:
            by_params = self._graphs.get(cache["k"])
            g = None if by_params is None \
                else by_params.get(params["embed"], {}).get(key)
        if g is None or not _same_tree(g.leaves, params):
            out, g = self._first(params, cache, tokens, lengths, block_table)
            with self._lock:
                self._graphs.setdefault(cache["k"], WeakIdKeyDictionary()) \
                    .setdefault(params["embed"], {})[key] = g
            return out
        return self._replay(g, tokens, lengths, block_table), cache

    def _first(self, params, cache, tokens, lengths, block_table):
        """The first call of a key: the eager step on the caller's stream
        (it allocates what a capture may not: the kernels' arrival
        counters), then its capture on the graph's own buffers.  Returns
        (the eager step's result, the graph)."""
        global captures
        out = self.eager(params, cache, tokens, lengths, block_table)
        bufs = (tokens.clone(), lengths.clone(), block_table.clone())
        with _capture_lock, tracing.span("model.decode_capture"), \
                pda.recording() as launches:
            graph, logits = _capture(
                lambda: self.eager(params, cache, *bufs)[0], tokens.device)
            captures += 1
        leaves = tuple(map(weakref.ref, _leaves(params, [])))
        return out, _Graph(graph, *bufs, logits, tuple(launches), leaves)

    @staticmethod
    def _replay(g: _Graph, tokens, lengths, block_table) -> torch.Tensor:
        with tracing.span("model.decode_replay", replays=1):
            g.tokens.copy_(tokens)
            g.lengths.copy_(lengths)
            g.block_table.copy_(block_table)
            g.graph.replay()
            logits = g.logits.clone()
        pda.count(*g.launches)
        return logits
