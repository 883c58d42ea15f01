"""Host spans inside the port, on the profiler's clock.

``span(name, **counts)`` is a context manager that records only while a
``torch.profiler`` session is active in the calling thread
(``torch.autograd._profiler_enabled()``, the test ``record_function``
makes); otherwise it returns one shared no-op context, and that one
check is all it costs.  ``spanned(name)`` runs a function inside such a
span: the modules the port keeps equal to the reference's take their
spans as one decorator line each.  So every profile taken of the
program carries its spans, with nothing to switch on.

A record holds the span's name, its start and end in ``time.time_ns()``
(the clock of kineto's event timestamps, so a device event's launch can
be placed inside a span), the id of the span open around it on the same
thread (-1 for none), the thread's id and small integer counts: ``req``
(a request's id, shared by the spans of one request), ``rows`` and
``padded`` (the rows a chunk round advances and the rows it computes),
``iters`` (the decode iterations of one launch), ``replays`` (a decode
step replayed from its CUDA graph, ``models/decode_graph.py``).  Records go into a
bounded buffer in memory, the oldest dropped first, and ``records()``
returns them.  A span touches no tensor and never waits for the device.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

CAPACITY = 1 << 18          # records kept; the oldest go first

_profiler_enabled = torch.autograd._profiler_enabled


class Record(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int             # the enclosing span's id on this thread, or -1
    tid: int
    counts: Dict[str, int]


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "start")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self) -> "_Span":
        stack = _open()
        self.id = next(_ids)
        self.parent = stack[-1] if stack else -1
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        _local.stack.pop()
        _buffer.append(Record(self.id, self.name, self.start, end,
                              self.parent, threading.get_ident(),
                              self.counts))
        return None


_NOOP = contextlib.nullcontext()
_ids = itertools.count()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_local = threading.local()


def _open() -> List[int]:
    """The ids of the spans open on this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **counts: int):
    """A span named ``name`` with ``counts``, recorded while a profiler
    runs in this thread."""
    if not _profiler_enabled():
        return _NOOP
    return _Span(name, counts)


def spanned(name: str, **from_result: Callable[..., Optional[int]]):
    """Decorate a function to run inside ``span(name)``; each keyword
    names a count taken from the function's result (left out where it
    gives None), as ``req`` from a pulled request."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _Span(name, {}) as sp:
                out = fn(*args, **kwargs)
                for key, count in from_result.items():
                    v = count(out)
                    if v is not None:
                        sp.counts[key] = v
                return out
        return inner
    return wrap


def records() -> List[Record]:
    """The recorded spans, in the order they ended."""
    return list(_buffer)


def clear() -> None:
    _buffer.clear()
