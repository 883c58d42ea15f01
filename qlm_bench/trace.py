"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUDA
activity only, so the host's own work is not slowed by the tracing of
every operator) over a slice of the window, read from its raw events.

Device activity is every event on the card (kernels, copies, memsets);
the busy time is the union of their intervals, clipped to the slice.
Host spans are the harness's own, timed with ``time.time_ns`` (the clock
of the trace's timestamps) around its calls into the program; an idle
gap is labelled with the innermost span open on the host when the gap
began.  The profiler's first start in a process sets up CUPTI, which
takes seconds: ``warm`` pays that in set-up.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


def _activities():
    if torch.cuda.is_available():
        return [torch.profiler.ProfilerActivity.CUDA]
    return [torch.profiler.ProfilerActivity.CPU]


def span(sl: Optional["Slice"], name: str):
    """A host span around a call into the program, recorded while ``sl``
    traces."""
    if sl is None or not sl.active:
        return contextlib.nullcontext()
    return sl.record(name)


class Slice:
    """The profiler over one slice of the window."""

    def __init__(self):
        self.prof: Optional[torch.profiler.profile] = None
        self.t0 = self.t1 = 0.0                 # time.monotonic
        self.ns0 = self.ns1 = 0                 # time.time_ns
        self.spans: List[Tuple[int, int, str]] = []
        self.events: list = []

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so the slice's start is quick."""
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        if torch.cuda.is_available():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.stop()

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.start()
        self.t0, self.ns0 = time.monotonic(), time.time_ns()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1, self.ns1 = time.monotonic(), time.time_ns()
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.t1

    @contextlib.contextmanager
    def record(self, name: str):
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((a, time.time_ns(), name))

    def read(self) -> dict:
        """busy seconds, kernel seconds and launches by name, idle gaps by
        host span, and the slice's length."""
        cpu = torch.autograd.DeviceType.CPU
        device = []
        for e in self.events:
            if e.device_type() == cpu:
                continue
            start = max(e.start_ns(), self.ns0)
            end = min(e.start_ns() + e.duration_ns(), self.ns1)
            if end > start:
                device.append((start, end, e.name()))
        device.sort()
        by_name: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        busy_ns, gaps = 0, []
        cur_s = cur_e = None
        for s, e, name in device:
            by_name[name] += (e - s) * 1e-9
            counts[name] += 1
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy_ns += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy_ns += cur_e - cur_s
        return {"busy_s": busy_ns * 1e-9, "window_s": self.t1 - self.t0,
                "kernel_s": dict(by_name), "kernel_n": dict(counts),
                "device_events": len(device), "host_spans": len(self.spans),
                "lead_s": (device[0][0] - self.ns0) * 1e-9 if device else 0.0,
                "tail_s": (self.ns1 - device[-1][1]) * 1e-9 if device else 0.0,
                "idle_by_span": _label_gaps(gaps, list(self.spans))}


def _label_gaps(gaps: List[Tuple[int, int]],
                spans: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds by the innermost host span open at each gap's start
    (``host`` where none is)."""
    spans.sort()
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        label = "host"
        # the innermost open span: the latest-starting one that still
        # covers a (spans nest, so a short look back finds it)
        for j in range(i - 1, max(-1, i - 64), -1):
            s, e, name = spans[j]
            if e >= a:
                label = name
                break
        out[label] += (b - a) * 1e-9
    return dict(out)


def kernel_seconds(kernel_s: Dict[str, float], marker: str) -> float:
    return sum(t for name, t in kernel_s.items() if marker in name)


def summary(read: dict, ledger) -> str:
    """One line on what the slice holds, for standard error."""
    n = read["kernel_n"]
    dec = sum(v for k, v in n.items() if "decode_mma_kernel" in k)
    pre = sum(v for k, v in n.items() if "prefill_mma_kernel" in k)
    return (f"trace: {read['device_events']} device events, first "
            f"{read['lead_s']:.4f} s after the slice's start, last "
            f"{read['tail_s']:.4f} s before its end; {read['host_spans']} "
            f"host spans; a {read['window_s']:.3f} s slice, busy "
            f"{read['busy_s']:.3f} s; "
            f"decode kernels {dec} (launched {ledger.decode_launches}), "
            f"prefill kernels {pre} (launched {ledger.prefill_launches})")


def breakdown(read: dict) -> dict:
    top = sorted(read["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(read["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in gaps]}
