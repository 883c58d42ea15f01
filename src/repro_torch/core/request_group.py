"""Request groups (paper §4, Algorithm 1).

Groups are formed by (i) partitioning on model type (Def. 4.1 — groups are
homogeneous in model so swap decisions are group-level), (ii) k-means
clustering on the numeric features (SLO value, prompt length, expected
output length), then (iii) splitting any group larger than
``avg_batch_size × δ`` in half (Algorithm 1).  Requests inside a group are
FCFS (§4).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.rwt_estimator import WorkloadProfile

_group_counter = itertools.count()


@dataclasses.dataclass
class RequestGroup:
    model: str
    slo: float                       # min SLO across members (conservative)
    requests: List[Request] = dataclasses.field(default_factory=list)
    group_id: int = dataclasses.field(default_factory=lambda: next(_group_counter))

    def add(self, req: Request) -> None:
        req.group_id = self.group_id
        self.requests.append(req)
        self.slo = min(self.slo, req.slo)
        self._wl_cache = None

    def size(self) -> int:
        return len(self.requests)

    # FCFS cursor: requests before ``_cursor`` are all finished.  Keeps
    # done()/next_pending() amortized O(running-batch) instead of O(group).
    def _advance(self) -> int:
        c = getattr(self, "_cursor", 0)
        reqs = self.requests
        while c < len(reqs) and reqs[c].finished():
            c += 1
        self._cursor = c
        return c

    def pending(self) -> List[Request]:
        c = self._advance()
        return [r for r in self.requests[c:] if not r.finished()]

    def num_pending(self) -> int:
        c = self._advance()
        n = 0
        for r in self.requests[c:]:
            if not r.finished():
                n += 1
        return n

    def next_pending(self, *, skip_in_flight: bool = True,
                     now: Optional[float] = None) -> Optional[Request]:
        """FCFS head of the group's waiting requests.  ``now`` enables the
        redelivery backoff gate: a request returned to the queue by an
        engine failure carries ``not_before`` and is skipped (not popped —
        FCFS order is preserved) until its backoff expires."""
        c = self._advance()
        for r in self.requests[c:]:
            if r.finished():
                continue
            if skip_in_flight and getattr(r, "_in_flight", False):
                continue
            if now is not None and getattr(r, "not_before", 0.0) > now:
                continue
            return r
        return None

    def done(self) -> bool:
        return self._advance() >= len(self.requests)

    def earliest_deadline(self) -> float:
        pend = self.pending()
        if not pend:
            return math.inf
        return min(r.deadline for r in pend)

    def workload_profile(self, expected_output: Optional[float] = None) -> WorkloadProfile:
        if expected_output is None and getattr(self, "_wl_cache", None) is not None:
            return self._wl_cache
        ins = [r.prompt_len for r in self.requests] or [1.0]
        outs = [r.max_new_tokens for r in self.requests] or [1.0]
        if expected_output is not None:
            outs = [expected_output] * len(self.requests)
        wl = WorkloadProfile.fit(ins, outs)
        if expected_output is None:
            self._wl_cache = wl
        return wl

    def total_expected_output_tokens(self, mu_output: Optional[float] = None) -> float:
        pend = self.pending()
        if mu_output is None:
            return float(sum(r.max_new_tokens - r.generated for r in pend))
        return mu_output * len(pend)


def _kmeans(features: np.ndarray, k: int, iters: int = 20,
            seed: int = 0) -> np.ndarray:
    """Tiny Lloyd's k-means (numpy only). Returns labels (n,)."""
    n = len(features)
    k = max(1, min(k, n))
    rng = np.random.default_rng(seed)
    # k-means++ style init: spread starting centers
    centers = features[rng.choice(n, size=1)]
    while len(centers) < k:
        d2 = np.min(((features[:, None, :] - centers[None]) ** 2).sum(-1), axis=1)
        probs = d2 / max(d2.sum(), 1e-12)
        centers = np.vstack([centers, features[rng.choice(n, p=probs)]])
    labels = np.zeros(n, int)
    for _ in range(iters):
        d2 = ((features[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = d2.argmin(1)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for j in range(k):
            m = labels == j
            if m.any():
                centers[j] = features[m].mean(0)
    return labels


def create_request_groups(requests: Sequence[Request], *,
                          avg_batch_size: float = 32.0,
                          delta: float = 4.0,
                          clusters_per_model: Optional[int] = None,
                          seed: int = 0) -> List[RequestGroup]:
    """Algorithm 1: cluster, then split oversized groups."""
    max_group = max(1, int(avg_batch_size * delta))
    by_model: Dict[str, List[Request]] = defaultdict(list)
    for r in requests:
        by_model[r.model].append(r)

    groups: List[RequestGroup] = []
    for model, reqs in by_model.items():
        feats = np.array([[math.log(r.slo), r.prompt_len, r.max_new_tokens]
                          for r in reqs], float)
        # normalize features
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-9)
        k = clusters_per_model
        if k is None:
            n_slo = len({r.slo_class or r.slo for r in reqs})
            k = max(n_slo, int(math.ceil(len(reqs) / max_group)))
        labels = _kmeans(feats, k, seed=seed)
        for j in sorted(set(labels)):
            members = [reqs[i] for i in np.flatnonzero(labels == j)]
            members.sort(key=lambda r: r.arrival_time)  # FCFS inside group
            g = RequestGroup(model=model, slo=min(r.slo for r in members))
            for r in members:
                g.add(r)
            groups.append(g)

    # Algorithm 1 lines 2–7: split while size > avg_batch_size × δ
    out: List[RequestGroup] = []
    work = list(groups)
    while work:
        g = work.pop()
        if g.size() > max_group:
            half = g.size() // 2
            g1 = RequestGroup(model=g.model, slo=g.slo)
            g2 = RequestGroup(model=g.model, slo=g.slo)
            for r in g.requests[:half]:
                g1.add(r)
            for r in g.requests[half:]:
                g2.add(r)
            work.extend([g1, g2])
        else:
            out.append(g)
    out.sort(key=lambda g: g.earliest_deadline())
    return out


def classify_into_groups(req: Request, groups: List[RequestGroup], *,
                         max_group: int,
                         slo_band: float = 2.0) -> Optional[RequestGroup]:
    """§4 "Handling New Incoming Requests": attach to the nearest existing
    compatible group with capacity, else signal that a new group is needed.

    Only groups that still have WAITING members are attach targets: when the
    system is underloaded every group is fully in-flight, so new arrivals
    form fresh groups and get least-loaded placement (QLM == FCFS at queue
    size 0, Fig. 17's left edge); amortization via large groups only kicks
    in when a real queue exists.

    ``slo_band`` bounds the SLO ratio between the request and the group it
    may join (Algorithm 1 clusters ON the SLO feature; the incremental
    attach path must respect the same partition).  A group's SLO is the min
    over members, so without the band one interactive arrival attached to a
    batch group re-deadlines the WHOLE group as interactive: the RWT walk
    then sees hours of batch decode behind an interactive deadline
    (violation storms), and any SLO-class queue policy — e.g. the front
    end's interactive-first ordering — can no longer separate the classes.
    """
    candidates = [g for g in groups
                  if g.model == req.model and g.size() < max_group
                  and max(g.slo, req.slo) <= slo_band * min(g.slo, req.slo)
                  and not g.done() and g.next_pending() is not None]
    if not candidates:
        return None
    def dist(g: RequestGroup) -> float:
        wl = g.workload_profile()
        return (abs(math.log(max(g.slo, 1e-9)) - math.log(max(req.slo, 1e-9)))
                + abs(wl.mu_input - req.prompt_len) / max(wl.mu_input, 1.0))
    best = min(candidates, key=dist)
    best.add(req)
    return best
