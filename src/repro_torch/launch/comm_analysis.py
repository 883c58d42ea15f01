"""Collective-traffic and flop counts of a DTensor program, per device
(the port's counterpart of ``src/repro/launch/hlo_analysis.py``).

The reference parses the optimized HLO and sums the result-shape bytes of
every collective.  A DTensor program has no HLO text: DTensor lowers each
op on sharded tensors to ops on this rank's local shards plus the
functional collectives (``torch.ops._c10d_functional``) its redistribution
needs.  ``DeviceCounter`` is a ``TorchDispatchMode`` that lets DTensor
desugar first (it returns ``NotImplemented`` for DTensor ops, as torch's
``CommDebugMode`` does) and then sees the local ops and collectives one
device runs:

* each collective's result bytes, under the reference's names
  (``all_gather_into_tensor`` -> ``"all-gather"``, ``all_reduce`` ->
  ``"all-reduce"``, ``reduce_scatter_tensor`` -> ``"reduce-scatter"``,
  ``all_to_all_single`` -> ``"all-to-all"``).  Result bytes are the
  reference's lower bound: the whole gathered tensor for an all-gather,
  the reduced tensor for an all-reduce (ring traffic is about twice
  that); DTensor issues no collective-permute of its own;
* the flops of every local matmul, attention and convolution op, from
  torch's flop formulas (``torch.utils.flop_counter``): the per-device
  count, as the reference's ``cost_analysis()`` gives it.  (torch's
  ``FlopCounterMode`` entered above DTensor counts each global op, the
  work of the whole mesh.)
* the bytes every other local op accesses (``op_bytes``): its tensor
  operands read plus its tensor results written, an in-place op's
  destination once as read and once as written; a view or metadata op
  (``func.is_view``, an op whose every result aliases an input's storage
  without a write, an ``empty`` allocation) counts zero, and a
  collective's bytes stay in its own count.  This is an unfused count,
  one term per aten op: where XLA's ``bytes accessed`` is taken after
  fusion (an elementwise chain reads its input once), here each op of
  the chain reads and writes its whole operands, so the count is an
  upper estimate beside the reference's.

``ReplicateFallback`` is the other half of running a model on DTensors:
where DTensor has no sharding strategy for an op on the placements it
got, or none that keeps an in-place op's placement, or (for an op that
writes no input) where the local op it planned fails, it redistributes
every DTensor argument of that op, at that call only, to ``Replicate()``
and runs the op again, as GSPMD's implicit all-gather would; the
redistribution's collectives are counted like any other.  It records
which ops fell back, and how often, and, given the ``DeviceCounter`` below
it, the collective bytes each op's fallbacks issued
(``collective_bytes``), so a record can say what share of its
collectives the fallbacks carry, and where in the port each one was
called (``sites``: the innermost frame of the ``repro_torch`` package
outside this module; a backward op's is the call that ran the backward,
as autograd's engine calls it from C++).
"""
from __future__ import annotations

import dataclasses
import os
import sys
from collections import Counter, defaultdict
from typing import Callable, Dict, Optional

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_C10D = torch.ops._c10d_functional
_COLLECTIVES = {
    _C10D.all_gather_into_tensor: "all-gather",
    _C10D.all_reduce: "all-reduce",
    _C10D.reduce_scatter_tensor: "reduce-scatter",
    _C10D.all_to_all_single: "all-to-all",
}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def to_dict(self) -> Dict:
        return {"bytes_by_op": dict(self.bytes_by_op),
                "count_by_op": dict(self.count_by_op),
                "total_bytes": self.total_bytes,
                "total_count": self.total_count}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


_ATEN = torch.ops.aten
# allocations that write nothing
_NO_WRITE = {_ATEN.empty, _ATEN.empty_like, _ATEN.empty_strided,
             _ATEN.new_empty, _ATEN.new_empty_strided}


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one local op accesses: its tensor operands read plus its
    tensor results written (``out=`` arguments as written only); zero for
    a view or metadata op (see the module docstring)."""
    if func.is_view or func._overloadpacket in _NO_WRITE:
        return 0
    out_args = {a.name for a in func._schema.arguments if a.is_out}
    outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
    ins = [t for t in _leaves([*args, *(v for k, v in kwargs.items()
                                        if k not in out_args)])
           if isinstance(t, torch.Tensor)]
    if not func._schema.is_mutable and outs:
        storages = {t.untyped_storage()._cdata for t in ins}
        if all(t.untyped_storage()._cdata in storages for t in outs):
            return 0        # _unsafe_view and its kind: a view in effect
    return _nbytes(ins) + _nbytes(outs)


class DeviceCounter(TorchDispatchMode):
    """Collective bytes and counts, flops and bytes accessed, of the ops
    one device runs inside the ``with`` block."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes_by_op: Dict[str, int] = defaultdict(int)
        self.count_by_op: Dict[str, int] = defaultdict(int)
        self.flops = 0
        self.bytes_accessed = 0
        self._fake_mode = None

    def __enter__(self):
        self._fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented       # let DTensor desugar to local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode:
            # DTensor's sharding propagation runs the global op on fake
            # tensors to learn its output's shape: no device runs that
            return out
        packet = func._overloadpacket
        name = _COLLECTIVES.get(packet)
        if name is not None:
            self.bytes_by_op[name] += _nbytes(out)
            self.count_by_op[name] += 1
            return out
        self.bytes_accessed += op_bytes(func, args, kwargs, out)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        return out

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes_by_op), dict(self.count_by_op))


def collective_stats(fn: Callable, *args, **kwargs) -> CollectiveStats:
    """The collectives one device issues while ``fn(*args, **kwargs)``
    runs."""
    with DeviceCounter() as counter:
        fn(*args, **kwargs)
    return counter.collectives()


def _replicate(x):
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim)
    if isinstance(x, (list, tuple)):
        return type(x)(_replicate(v) for v in x)
    return x


class ReplicateFallback(TorchDispatchMode):
    """Where DTensor cannot shard an op on the placements it got, run it on
    replicated arguments (see the module docstring); ``fallbacks`` counts
    those ops by name, and ``collective_bytes`` the bytes of the
    collectives their redistributions issued, read off ``counter`` (none
    without one).  Enter it after (above) ``DeviceCounter``."""

    def __init__(self, counter: Optional[DeviceCounter] = None) -> None:
        super().__init__()
        self.fallbacks: Counter = Counter()
        self.collective_bytes: Counter = Counter()
        self.sites: Dict[str, Counter] = defaultdict(Counter)
        self._counter = counter

    def _collected(self) -> int:
        if self._counter is None:
            return 0
        return sum(self._counter.bytes_by_op.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(t is DTensor for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as err:
            # an op that writes its input falls back only where DTensor
            # refused it; one that writes nothing also where the local op
            # DTensor planned failed (a view across a strided shard)
            if func._schema.is_mutable and not _no_strategy(err):
                raise
        name = str(func)
        self.fallbacks[name] += 1
        self.sites[name][_site()] += 1
        before = self._collected()
        try:
            return self._replicated(func, args, kwargs)
        finally:
            self.collective_bytes[name] += self._collected() - before

    @staticmethod
    def _replicated(func, args, kwargs):
        args = _replicate(list(args))
        kwargs = {k: _replicate(v) for k, v in kwargs.items()}
        try:
            return func(*args, **kwargs)
        except NotImplementedError as err:
            if not _no_strategy(err):
                raise
        # no strategy at all: the op runs whole on every device
        mesh = next(a for a in _leaves(args) if isinstance(a, DTensor)) \
            .device_mesh
        out = func(*_to_local(args), **_to_local(kwargs))
        return _from_local(out, mesh)


def _site() -> str:
    """``path:line (function)`` of the innermost frame of the
    ``repro_torch`` package outside this module, the path from the
    package's directory."""
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename
        if _PACKAGE in path and not path.endswith(_THIS):
            rel = path[path.rindex(_PACKAGE) + len(_PACKAGE):]
            return f"{rel}:{frame.f_lineno} ({frame.f_code.co_name})"
        frame = frame.f_back
    return "outside the package"


_PACKAGE = f"repro_torch{os.sep}"
_THIS = f"launch{os.sep}comm_analysis.py"


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _to_local(x):
    if isinstance(x, DTensor):
        return x.to_local()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_local(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_local(v) for k, v in x.items()}
    return x


def _from_local(x, mesh):
    if isinstance(x, torch.Tensor):
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    if isinstance(x, (list, tuple)):
        return type(x)(_from_local(v, mesh) for v in x)
    return x


def _no_strategy(err: BaseException) -> bool:
    """Whether ``err`` is DTensor's refusal to shard an op: no strategy,
    or none that keeps an in-place op's placement."""
    text = str(err)
    return any(s in text for s in (
        "Sharding propagation failed", "sharding strategy",
        "in-place operations that require placement changes"))
