"""Virtual queues (paper §4, Def. 4.2).

A virtual queue is an ordered sequence of request-group references with a
one-to-one mapping to an LLM serving instance.  Requests themselves stay in
the global queue (single replica — fault-tolerance §4); the VQ holds
*pointers*, so it can be rebuilt or reassigned without touching request
data (fault isolation / consistency argument of the paper).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.request import Request
from repro_torch.core.request_group import RequestGroup


@dataclasses.dataclass
class VirtualQueue:
    instance_id: int
    groups: List[RequestGroup] = dataclasses.field(default_factory=list)

    def head_group(self) -> Optional[RequestGroup]:
        while self.groups and self.groups[0].done():
            self.groups.pop(0)  # dequeue completed groups (§4)
        return self.groups[0] if self.groups else None

    def set_order(self, groups: List[RequestGroup]) -> None:
        self.groups = [g for g in groups if not g.done()]

    def next_request(self, model: Optional[str] = None,
                     now: Optional[float] = None) -> Optional[Request]:
        """§5 Request Pulling: FCFS within the head group; when every head
        request is already in flight, pulling continues into subsequent
        groups (continuous batching keeps the device fed) — but stops at the
        first group whose model differs from the loaded one (``model``),
        since serving it requires a swap decision by the global scheduler.

        ``now`` gates redelivered requests still in exponential backoff
        (``Request.not_before``): they are skipped, not dropped, so the
        pull continues past them and the slot goes to servable work.
        """
        self.head_group()  # drop completed head groups
        for g in self.groups:
            if g.done():
                continue
            if model is not None and g.model != model:
                return None  # swap boundary
            r = g.next_pending(now=now)  # arrival-ordered (FCFS inside group)
            if r is not None:
                return r
        return None

    def pending_requests(self) -> int:
        return sum(g.num_pending() for g in self.groups)

    def models_in_order(self) -> List[str]:
        return [g.model for g in self.groups if not g.done()]

    def __len__(self) -> int:
        return len([g for g in self.groups if not g.done()])
