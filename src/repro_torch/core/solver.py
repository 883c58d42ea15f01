"""Global-scheduler optimization (paper §7, Table 2, Eqs. 6–13).

The paper formulates an ILP over binary x_{g,i,j} (group i → virtual queue
g, position j) with big-M linearized model-switch indicators t_{g,j}
(Eq. 9), cumulative waiting times wt_{g,j} that accumulate predecessor
completion times and swap times (Eq. 10), penalties p = wt − slo (Eq. 11),
the feasibility constraint p ≤ 0 (Eq. 12), and objective min Σ p (Eq. 13).

No external MILP solver is available offline, so this module implements the
same formulation directly over the *assignment representation* (each
feasible x is exactly a partition of groups into ordered queues — Eq. 6's
double stochasticity):

  * ``evaluate``          — the Eq. 10/11/13 objective for an assignment;
  * ``branch_and_bound``  — exact for small instances (prunes on the
                            monotone violation lower bound);
  * ``local_search``      — EDF-seeded greedy + move/swap hill-climbing,
                            scales to paper-sized queues (Fig. 20);
  * ``solve``             — picks B&B when the instance is small enough.

When Eq. 12 is infeasible (demand > capacity), the paper falls back to
scale-up / EDF (§9); we return the minimum-violation assignment and flag
``feasible=False`` so the caller can trigger those actions.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Solver view of one request group."""
    group_id: int
    model: str
    slo: float                    # seconds from NOW (deadline slack)
    drain_time: Dict[int, float]  # instance -> C (Eq. 5, RWT group bound)
    size: float = 1.0             # pending requests (for the count objective)


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    instance_id: int
    current_model: Optional[str]
    swap_time: Dict[str, float]   # model -> S on this instance


@dataclasses.dataclass
class Solution:
    assignment: List[List[int]]   # per instance: ordered group indices
    violation: float              # Σ max(0, p)
    total_penalty: float          # Σ p  (Eq. 13)
    feasible: bool                # Eq. 12 satisfied
    nodes_explored: int = 0

    def order_for(self, instance_idx: int) -> List[int]:
        return self.assignment[instance_idx]


def evaluate(assignment: Sequence[Sequence[int]], groups: Sequence[GroupSpec],
             instances: Sequence[InstanceSpec],
             objective: str = "penalty") -> Tuple[float, float]:
    """Returns (primary, tiebreak).

    objective="penalty" (paper Eq. 13): primary = Σ max(0,p), tiebreak Σ p.
    objective="count" (beyond-paper): primary = Σ size·1[p>0] — attainment-
    aligned; an LP can't express it but the search-based solvers can.
    """
    violation = 0.0
    total = 0.0
    count = 0.0
    for qi, order in enumerate(assignment):
        inst = instances[qi]
        t = 0.0
        cur = inst.current_model
        for gi in order:
            g = groups[gi]
            if g.model != cur:
                t += inst.swap_time.get(g.model, 0.0)  # Eq. 9/10 swap term
                cur = g.model
            t += g.drain_time[inst.instance_id]        # Eq. 10 completion term
            p = t - g.slo                               # Eq. 11
            total += p
            if p > 0:
                violation += p
                count += getattr(g, "size", 1.0) or 1.0
    if objective == "count":
        return count, violation
    return violation, total


def per_instance_makespan(assignment: Sequence[Sequence[int]],
                          groups: Sequence[GroupSpec],
                          instances: Sequence[InstanceSpec]) -> List[float]:
    """Estimated finish time of each instance's queue under an assignment
    (the Eq. 10 walk without the penalty fold).  Load-balance metric for
    the routing comparison (``core/routing.py`` computes the same vector
    for live virtual queues): the spread between the max and min entries
    is the wall-clock an idle instance spends waiting on a loaded one."""
    out: List[float] = []
    for qi, order in enumerate(assignment):
        inst = instances[qi]
        t = 0.0
        cur = inst.current_model
        for gi in order:
            g = groups[gi]
            if g.model != cur:
                t += inst.swap_time.get(g.model, 0.0)
                cur = g.model
            t += g.drain_time[inst.instance_id]
        out.append(t)
    return out


def _objective(assignment, groups, instances,
               objective: str = "penalty") -> Tuple[float, float]:
    return evaluate(assignment, groups, instances, objective)


# ---------------------------------------------------------------------------
# exact: branch and bound
# ---------------------------------------------------------------------------

def branch_and_bound(groups: Sequence[GroupSpec],
                     instances: Sequence[InstanceSpec],
                     node_limit: int = 500_000,
                     incumbent: Optional[Solution] = None) -> Solution:
    """Exact insertion-based DFS.

    Groups are placed one at a time (EDF consideration order for good early
    incumbents); each step tries every (queue, position) INSERTION, so all
    per-queue permutations are reachable — unlike append-only search, which
    can miss swap-saving reorderings.  Pruning uses the fact that adding a
    group never decreases any already-placed group's waiting time, so the
    partial violation Σ max(0,p) is a valid lower bound.
    """
    order = sorted(range(len(groups)), key=lambda i: groups[i].slo)
    G = len(instances)
    best: Optional[Tuple[float, float, List[List[int]]]] = None
    if incumbent is not None:
        best = (incumbent.violation, incumbent.total_penalty,
                [list(q) for q in incumbent.assignment])
    nodes = 0
    limit_hit = False

    def dfs(idx: int, assignment: List[List[int]]):
        nonlocal best, nodes, limit_hit
        nodes += 1
        if nodes > node_limit:
            limit_hit = True
            return
        viol, pen = evaluate(assignment, groups, instances)
        if best is not None and viol > best[0] + 1e-12:
            return  # lower bound prune
        if idx == len(order):
            key = (viol, pen)
            if best is None or key < (best[0], best[1]):
                best = (viol, pen, [list(q) for q in assignment])
            return
        gi = order[idx]
        for qi in range(G):
            for pos in range(len(assignment[qi]) + 1):
                assignment[qi].insert(pos, gi)
                dfs(idx + 1, assignment)
                assignment[qi].pop(pos)

    dfs(0, [[] for _ in range(G)])
    assert best is not None
    viol, pen, assign = best
    return Solution(assignment=assign, violation=viol, total_penalty=pen,
                    feasible=(viol <= 1e-9),
                    nodes_explored=nodes)


# ---------------------------------------------------------------------------
# scalable: EDF-seeded greedy + local search
# ---------------------------------------------------------------------------

def _greedy_seed(groups, instances) -> List[List[int]]:
    """EDF over groups; each group goes to the queue where it finishes
    earliest — with the model-affinity bonus the Oracle policy of Insight #3
    exploits (placing same-model groups together avoids the swap)."""
    order = sorted(range(len(groups)), key=lambda i: groups[i].slo)
    assignment: List[List[int]] = [[] for _ in instances]
    tails = [(0.0, inst.current_model) for inst in instances]
    for gi in order:
        g = groups[gi]
        best_qi, best_finish = 0, math.inf
        for qi, inst in enumerate(instances):
            t, cur = tails[qi]
            dt = inst.swap_time.get(g.model, 0.0) if g.model != cur else 0.0
            finish = t + dt + g.drain_time[inst.instance_id]
            if finish < best_finish:
                best_qi, best_finish = qi, finish
        assignment[best_qi].append(gi)
        inst = instances[best_qi]
        t, cur = tails[best_qi]
        dt = inst.swap_time.get(g.model, 0.0) if g.model != cur else 0.0
        tails[best_qi] = (t + dt + g.drain_time[inst.instance_id], g.model)
    return assignment


def local_search(groups: Sequence[GroupSpec], instances: Sequence[InstanceSpec],
                 max_iters: int = 2000, seed: int = 0,
                 init: Optional[List[List[int]]] = None,
                 objective: str = "penalty") -> Solution:
    rng = random.Random(seed)
    assignment = init if init is not None else _greedy_seed(groups, instances)
    assignment = [list(q) for q in assignment]
    best_v, best_p = _objective(assignment, groups, instances, objective)

    n = len(groups)
    G = len(instances)
    patience = max(200, 5 * n)
    iters_without_improvement = 0
    it = 0
    while it < max_iters and iters_without_improvement < patience and n > 0:
        it += 1
        move_kind = rng.random()
        snapshot = [list(q) for q in assignment]
        if move_kind < 0.5 and n >= 2:
            # swap two groups (possibly across queues)
            q1 = rng.randrange(G)
            q2 = rng.randrange(G)
            if not assignment[q1] or not assignment[q2]:
                continue
            i1 = rng.randrange(len(assignment[q1]))
            i2 = rng.randrange(len(assignment[q2]))
            if q1 == q2 and i1 == i2:
                continue
            assignment[q1][i1], assignment[q2][i2] = assignment[q2][i2], assignment[q1][i1]
        else:
            # move one group to a random (queue, position)
            q1 = rng.randrange(G)
            if not assignment[q1]:
                continue
            i1 = rng.randrange(len(assignment[q1]))
            gi = assignment[q1].pop(i1)
            q2 = rng.randrange(G)
            i2 = rng.randrange(len(assignment[q2]) + 1)
            assignment[q2].insert(i2, gi)
        v, p = _objective(assignment, groups, instances, objective)
        if (v, p) < (best_v, best_p):
            best_v, best_p = v, p
            iters_without_improvement = 0
        else:
            assignment = snapshot
            iters_without_improvement += 1

    if objective != "penalty":
        best_v, best_p = evaluate(assignment, groups, instances)
    return Solution(assignment=assignment, violation=best_v,
                    total_penalty=best_p, feasible=(best_v <= 1e-9),
                    nodes_explored=it)


def brute_force(groups: Sequence[GroupSpec],
                instances: Sequence[InstanceSpec]) -> Solution:
    """Exhaustive (test oracle, ≤ ~6 groups)."""
    n, G = len(groups), len(instances)
    best = None
    for queue_of in itertools.product(range(G), repeat=n):
        per_queue: List[List[int]] = [[] for _ in range(G)]
        for gi, qi in enumerate(queue_of):
            per_queue[qi].append(gi)
        for perms in itertools.product(*[itertools.permutations(q) for q in per_queue]):
            assignment = [list(p) for p in perms]
            key = _objective(assignment, groups, instances)
            if best is None or key < best[0]:
                best = (key, [list(q) for q in assignment])
    (v, p), assign = best
    return Solution(assignment=assign, violation=v, total_penalty=p,
                    feasible=(v <= 1e-9))


def solve(groups: Sequence[GroupSpec], instances: Sequence[InstanceSpec],
          *, exact_threshold: int = 0, seed: int = 0,
          node_limit: int = 100_000, objective: str = "penalty") -> Solution:
    """Paper's global scheduler entry point.

    Default is the scalable local search (the paper's production budget is
    ~5 ms per request group, Fig. 20); ``exact_threshold`` > 0 enables the
    exact B&B for small instances (tests / small clusters), seeded with the
    local-search incumbent so pruning bites immediately.
    """
    if not groups:
        return Solution([[] for _ in instances], 0.0, 0.0, True)
    # search budget scales with the decision space (Fig. 19: smaller δ =>
    # more groups => more solver work for the same decision quality)
    iters = max(2000, 40 * len(groups))
    ls = local_search(groups, instances, seed=seed, objective=objective,
                      max_iters=iters)
    if len(groups) <= min(exact_threshold, 7) and len(instances) <= 4:
        bb = branch_and_bound(groups, instances, node_limit=node_limit,
                              incumbent=ls)
        if (bb.violation, bb.total_penalty) < (ls.violation, ls.total_penalty):
            return bb
    return ls
