"""The program's own spans (``repro_torch.tracing``) over a traced slice,
joined with the slice's device events on one clock (``time.time_ns``).

  * Each device event (kernel, copy, memset) is joined by its
    ``correlation_id`` to the CUDA API call that launched it; the call's
    host start places the event under the innermost program span open
    at that moment and under that span's ancestors.
  * Each idle gap on the card, the slice's edges included, is put down
    to the program spans open when it began, as ``trace._label_gaps``
    puts it down to the harness's spans.

Device and idle times are grouped by chain: the names of the spans
open, innermost first (``()`` where none is).  A span's self time is
that of the chains it heads; its time under it, that of the chains that
hold it.  Host times go by span name (whole and self) and by each
span's own chain (its whole duration).

``read(run)`` returns None where the program records no spans in the
slice (a tree without ``repro_torch.tracing``, or no ``--trace 1``); its
device fields are None where the trace holds no device event or no
launch to join one to.  The result is kept on the run
(``run.program_trace``), so the readers share one pass and a caller of
``harness.run_cell`` can print it after the slice is gone
(``program_breakdown.py``).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

Chain = Tuple[str, ...]


def read(run) -> Optional[dict]:
    if "program_trace" in vars(run):
        return run.program_trace
    out = None
    sl = run.ledger.slice if run.ledger is not None else None
    if sl is not None and sl.ns1:
        out = attribute(_records(sl.ns0, sl.ns1), sl.events, sl.ns0, sl.ns1)
    run.program_trace = out
    return out


def _records(ns0: int, ns1: int) -> list:
    """The program's spans that began inside [ns0, ns1)."""
    try:
        from repro_torch import tracing
    except ImportError:         # a tree that records no spans
        return []
    return [r for r in tracing.records() if ns0 <= r.start_ns < ns1]


class _Spans:
    """The innermost span open at a time, over the threads' span trees."""

    def __init__(self, records: list):
        self.by_id = {r.id: r for r in records}
        self.threads: Dict[int, tuple] = {}
        per: Dict[int, list] = defaultdict(list)
        for r in records:
            per[r.tid].append(r)
        for tid, rs in per.items():
            rs.sort(key=lambda r: (r.start_ns, r.id))
            self.threads[tid] = ([r.start_ns for r in rs], rs)
        self._chains: Dict[int, Chain] = {}

    def chain(self, r) -> Chain:
        """The names of ``r`` and its ancestors, innermost first."""
        got = self._chains.get(r.id)
        if got is None:
            parent = self.by_id.get(r.parent)
            got = (r.name,) + (self.chain(parent) if parent else ())
            self._chains[r.id] = got
        return got

    def at(self, t: int) -> Chain:
        """The chain of the innermost span open at ``t`` on any thread
        (the latest-starting one where threads overlap)."""
        best = None
        for starts, rs in self.threads.values():
            i = bisect.bisect_right(starts, t) - 1
            if i < 0:
                continue
            # spans on one thread nest: the one that began last before t
            # is inside every span open at t, so they are its ancestors
            r = rs[i]
            while r is not None and r.end_ns < t:
                r = self.by_id.get(r.parent)
            if r is not None and (best is None or r.start_ns > best.start_ns):
                best = r
        return self.chain(best) if best is not None else ()


def attribute(records: list, events: list, ns0: int, ns1: int
              ) -> Optional[dict]:
    """Host seconds and counts by span name; device and idle seconds by
    chain (see the module's docstring)."""
    if not records:
        return None
    spans = _Spans(records)
    host_s: Dict[str, float] = defaultdict(float)
    self_s: Dict[str, float] = defaultdict(float)
    host_by_chain: Dict[Chain, float] = defaultdict(float)
    n: Dict[str, int] = defaultdict(int)
    counts: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for r in records:
        d = (r.end_ns - r.start_ns) * 1e-9
        host_s[r.name] += d
        self_s[r.name] += d
        host_by_chain[spans.chain(r)] += d
        n[r.name] += 1
        for k, v in r.counts.items():
            if k != "req":              # an identifier, not a quantity
                counts[r.name][k] += v
        parent = spans.by_id.get(r.parent)
        if parent is not None:
            self_s[parent.name] -= d
    out = {"host_s": dict(host_s),
           "host_self_s": dict(self_s), "n": dict(n),
           "host_by_chain": dict(host_by_chain),
           "counts": {k: dict(v) for k, v in counts.items()},
           "device_by_chain": None, "idle_by_chain": None,
           "device_s": 0.0, "launches": 0}

    launch_at: Dict[int, int] = {}
    device: List[Tuple[int, int, int]] = []
    for e in events:
        if _on_host(e):
            if _is_launch(e):
                launch_at[e.correlation_id()] = e.start_ns()
            continue
        start = max(e.start_ns(), ns0)
        end = min(e.start_ns() + e.duration_ns(), ns1)
        if end > start:
            device.append((start, end, e.correlation_id()))
    out["launches"] = len(launch_at)
    if not device:
        return out
    device.sort()
    out["device_s"] = sum(e - s for s, e, _ in device) * 1e-9
    if launch_at:
        by_chain: Dict[Optional[Chain], float] = defaultdict(float)
        for s, e, corr in device:
            t = launch_at.get(corr)
            by_chain[None if t is None else spans.at(t)] += (e - s) * 1e-9
        out["device_by_chain"] = dict(by_chain)
    idle: Dict[Chain, float] = defaultdict(float)
    for a, b in _gaps(device, ns0, ns1):
        idle[spans.at(a)] += (b - a) * 1e-9
    out["idle_by_chain"] = dict(idle)
    return out


def _on_host(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CPU


def _is_launch(e) -> bool:
    """A CUDA API call (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
    ``cuLaunchKernelEx``, ...)."""
    return e.name().startswith("cu") and e.correlation_id() > 0


def _gaps(device: List[tuple], ns0: int, ns1: int) -> List[Tuple[int, int]]:
    """The slice's idle intervals around the union of ``device``
    (sorted), its two edges included."""
    out, cur = [], ns0
    for s, e, _ in device:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if ns1 > cur:
        out.append((cur, ns1))
    return out


def under(by_chain: Optional[Dict[Optional[Chain], float]],
          test: Callable[[str], bool]) -> Optional[float]:
    """Seconds of the chains that hold a span whose name passes
    ``test``: the time under those spans, each interval counted once."""
    if by_chain is None:
        return None
    return sum(t for chain, t in by_chain.items()
               if chain and any(test(name) for name in chain))


def innermost(by_chain: Optional[Dict[Optional[Chain], float]]
              ) -> Optional[Dict[str, float]]:
    """Self time by span name: each chain's seconds under its innermost
    span (``host`` where no span was open, ``unjoined`` for device events
    whose launch the trace does not hold)."""
    if by_chain is None:
        return None
    out: Dict[str, float] = defaultdict(float)
    for chain, t in by_chain.items():
        out["unjoined" if chain is None else chain[0] if chain
            else "host"] += t
    return dict(out)

