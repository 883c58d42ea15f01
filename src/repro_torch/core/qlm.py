"""QLM controller: global queue + group formation + violation-triggered
global scheduling (paper §3 lifecycle).

Works against either the real engine cluster (``repro.serving`` +
``core.lso.QLMAgent``) or the discrete-event simulator (``repro.sim``);
both expose instances as ``core.global_scheduler.InstanceInfo``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Callable, List, Optional, Sequence

from repro_torch import tracing
from repro_torch.core import routing
from repro_torch.core.global_scheduler import GlobalScheduler, InstanceInfo
from repro_torch.core.request import Request
from repro_torch.core.request_group import (RequestGroup, classify_into_groups,
                                      create_request_groups)
from repro_torch.core.rwt_estimator import RWTEstimator


@dataclasses.dataclass
class QLMConfig:
    avg_batch_size: float = 32.0
    delta: float = 4.0            # request-group size multiple (§8.3: δ=4)
    z_conservative: float = 1.0   # RWT tail factor
    # Placement policy: "solver" = per-group MILP/local-search placement
    # (core/solver.py via GlobalScheduler), "slice" = slice-level
    # load balancing (core/routing.py): groups re-partitioned into
    # slices of <= slice_size requests, each placed by estimated
    # earliest finish.  slice_size None means one engine batch quantum
    # (avg_batch_size).
    routing: str = "solver"
    slice_size: Optional[int] = None
    reschedule_on_arrival: bool = True
    # min sim-seconds between solver invocations: the paper runs the global
    # scheduler OFF the critical path ("overheads can be hidden", §8.3), so
    # back-to-back arrivals share one reordering.
    reschedule_cooldown: float = 2.0
    # Run repro.analysis.invariants.check_queue_layer at every tick()
    # (group placement/ownership, SLO-min, model homogeneity).  Also
    # forced on by QLINT_INVARIANTS=1.  Debug aid.
    debug_invariants: bool = False
    # -- fault tolerance (§4: the global queue survives engine death) -----
    # Redelivery attempts per request after its serving engine dies; the
    # (budget+1)-th death quarantines the request as FAILED — the poison
    # policy: a request that kills retry_budget+1 engines stops being
    # retried instead of crash-looping the cluster.
    retry_budget: int = 2
    # Exponential backoff for redelivered requests:
    # min(cap, base * 2**(n-1)) seconds after the nth redelivery.
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    # Missed-heartbeat supervision: None disables (sparse-tick callers,
    # e.g. unit tests driving tick() manually, must not read as silence).
    # An instance is DEGRADED after missing `degraded_after_missed`
    # windows and DEAD after `dead_after_missed`.
    heartbeat_timeout_s: Optional[float] = None
    degraded_after_missed: int = 1
    dead_after_missed: int = 3
    # Consecutive transient (non-fatal) engine errors before the
    # supervisor gives up on the instance; any successful heartbeat
    # resets the strike counter.
    transient_strikes: int = 3
    # -- round watchdog (hang detection) ------------------------------
    # Success-only heartbeats cannot see a hung engine: a wedged round
    # returns cleanly having done nothing, so the agent keeps
    # heartbeating forever.  The watchdog instead tracks PROGRESS: an
    # instance that has work (resident slots or pending VQ entries) but
    # whose engine counters stay flat past its per-round deadline is
    # DEGRADED, and past `hang_dead_factor` deadlines is mark_dead like
    # a crash.  The deadline derives from the calibrated
    # HardwareProfile: worst-case healthy round = prefill_time +
    # decode_burst * decode_per_token + swap_time, times
    # `hang_grace_rounds`.  None disables (sparse-tick callers, e.g.
    # unit tests driving tick() manually).
    hang_grace_rounds: Optional[float] = None
    hang_dead_factor: float = 3.0


# Instance health states (supervision state machine — see
# docs/fault_tolerance.md).  DEAD and DRAINED are terminal for the
# INSTANCE (a crashed engine's pool is gone; a drained one was
# decommissioned on purpose) but not for the cluster:
# replace_instance() attaches a fresh engine in the departed slot.
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"   # decommissioning: residents finish, pulls stop
DRAINED = "drained"     # decommissioned cleanly (pool empty, not lost)
DEAD = "dead"


def _locked(method):
    """Serialize a controller entry point on ``self.lock``.

    The lock is an RLock, so locked entry points freely call each other
    (``mark_dead`` -> ``reschedule`` -> ``gc_groups``).  Lock ORDER with
    the per-engine locks: an agent thread acquires its ``engine.lock``
    FIRST and the controller lock second (``engine.pull_source`` fires
    mid-round); the controller thread therefore only ever takes engine
    locks NON-blocking / bounded (``_engine_guard``) while holding this
    one, so the cross order cannot deadlock — worst case is a bounded
    stall, after which the controller proceeds best-effort."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self.lock:
            return method(self, *args, **kwargs)
    return wrapper


@contextlib.contextmanager
def _engine_guard(engine, timeout: float = 0.0):
    """Bounded acquire of an engine's round lock from the CONTROLLER side
    (never block indefinitely: the agent thread holding it may itself be
    waiting on the controller lock — the one cross-order that could
    deadlock).  Tri-state yield:

      * ``True``  — lock taken; engine state may be mutated safely.
      * ``None``  — the engine has no lock (single-threaded drivers,
        lockless sim engines): proceed unguarded, nothing races.
      * ``False`` — CONTENDED MISS: an agent thread is mid-round
        (typically blocked on the controller lock inside ``_pull``).
        The caller must NOT touch engine slots/pools — mutating them
        under a live round corrupts it.  Defer the work and retry from
        ``tick`` once the round finishes.
    """
    lock = getattr(engine, "lock", None)
    if lock is None:
        yield None
        return
    got = lock.acquire(timeout=timeout) if timeout > 0 \
        else lock.acquire(blocking=False)
    try:
        yield got
    finally:
        if got:
            lock.release()


@dataclasses.dataclass
class InstanceHealth:
    state: str = HEALTHY
    last_heartbeat: Optional[float] = None
    strikes: int = 0              # consecutive transient errors
    missed: int = 0               # consecutive missed heartbeat windows
    died_at: Optional[float] = None
    cause: Optional[str] = None
    # round-watchdog progress tracking: the engine-counter fingerprint
    # last seen and when it last moved (None = never sampled)
    progress_marker: Optional[tuple] = None
    last_progress: Optional[float] = None


class QLMController:
    def __init__(self, instances: Sequence[InstanceInfo],
                 cfg: Optional[QLMConfig] = None, seed: int = 0):
        self.cfg = cfg or QLMConfig()
        if self.cfg.routing not in routing.ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {self.cfg.routing!r}; "
                f"expected one of {routing.ROUTING_POLICIES}")
        # Guards the whole queue layer (global_queue, groups, VQ group
        # lists, health, scheduler state) against concurrent agent
        # threads: every public entry point is @_locked, and threaded
        # agents take this lock around ``_pull``/``sync`` (see
        # ``QLMAgent.queue_lock``), so FCFS pops and ``not_before``
        # redelivery gates stay race-free.  Reentrant: entry points
        # compose.  Single-threaded drivers pay one uncontended acquire.
        self.lock = threading.RLock()
        self.instances = list(instances)
        self.estimator = RWTEstimator(self.cfg.z_conservative)
        self.scheduler = GlobalScheduler(self.estimator, seed=seed)
        # the global queue: single-replica request store (RabbitMQ stand-in,
        # §4 Fault Tolerance) — virtual queues only hold group pointers.
        self.global_queue: List[Request] = []
        self.groups: List[RequestGroup] = []
        self.finished: List[Request] = []
        # requests 429'd before entering the global queue (admission control
        # / backpressure): never scheduled, but they COUNT as SLO misses —
        # attainment over admitted requests only would reward rejecting
        # everything hard to serve
        self.rejected: List[Request] = []
        # requests quarantined after exhausting their redelivery budget or
        # losing every instance that could serve their model (poison
        # policy).  Observability list only: the requests themselves stay
        # in global_queue/finished (stamped terminal), so attainment
        # iterates them exactly once via all_requests().
        self.failed: List[Request] = []
        # supervision: per-instance health, index-aligned with
        # self.instances (the simulator rebuilds InstanceInfo views but
        # keeps the order)
        self.health: List[InstanceHealth] = [InstanceHealth()
                                             for _ in self.instances]
        self.redeliveries = 0        # total redelivery events (stats)
        self.routing_invocations = 0  # slice_schedule runs (routing="slice")
        # engine-touching LSOs deferred on a contended engine guard
        # (threaded agents mid-round); retried from tick()
        self._pending_salvage: List = []      # [(idx, engine), ...]
        self._pending_evicts: dict = {}       # idx -> (engine, evict)
        # lifecycle stats (self-healing cluster: see docs/fault_tolerance.md)
        self.hangs = 0               # watchdog-detected hangs (mark_dead'd)
        self.drains = 0              # drain_instance invocations
        self.replacements = 0        # replace_instance invocations
        self.migrations = 0          # snapshots made portable cross-engine
        # optional engine handles, index-aligned with instances: lets
        # mark_dead() reclaim a dead engine's resident requests and lets
        # the terminal-state invariant cross-check engine residency
        self._engines: Optional[List] = None
        self._last_reschedule = -math.inf

    # -- supervision -------------------------------------------------------
    @_locked
    def attach_engines(self, engines: Sequence) -> None:
        """Register the engine behind each instance (order-aligned with
        ``instances``).  Optional: without it, mark_dead() can only sweep
        queue-visible state (``_served_by`` / snapshots)."""
        assert len(engines) == len(self.instances), \
            (len(engines), len(self.instances))
        self._engines = list(engines)

    def is_alive(self, idx: int) -> bool:
        """Alive = the engine process exists and may hold resident work.
        DRAINING counts (its residents are finishing); DEAD and DRAINED
        do not (the instance departed)."""
        return self.health[idx].state not in (DEAD, DRAINED)

    def is_schedulable(self, idx: int) -> bool:
        """Schedulable = NEW work may be placed on it.  Stricter than
        alive: a DRAINING instance finishes its residents but its VQ
        stays empty — it is departing capacity."""
        return self.health[idx].state in (HEALTHY, DEGRADED)

    def alive_instances(self) -> List[InstanceInfo]:
        return [inst for i, inst in enumerate(self.instances)
                if self.is_alive(i)]

    def schedulable_instances(self) -> List[InstanceInfo]:
        return [inst for i, inst in enumerate(self.instances)
                if self.is_schedulable(i)]

    def alive_fraction(self) -> float:
        if not self.instances:
            return 0.0
        return len(self.alive_instances()) / len(self.instances)

    def serving_fraction(self) -> float:
        """Fraction of attached instances new work can land on (excludes
        dead, drained, AND draining — the front end scales its admission
        limits by this, so departing capacity sheds load 503-style
        instead of stranding it).  0.0 with zero attached instances."""
        if not self.instances:
            return 0.0
        return len(self.schedulable_instances()) / len(self.instances)

    def can_serve(self, model: str) -> bool:
        """Does any SCHEDULABLE instance serve ``model``?  (A model whose
        only server is draining is already unservable for new work.)"""
        return any(model in i.hw_by_model
                   for i in self.schedulable_instances())

    @_locked
    def heartbeat(self, idx: int, now: float) -> None:
        """A successful agent iteration: reset the strike/missed counters
        and recover a DEGRADED instance (DEAD/DRAINED stay departed — the
        instance is gone; recovery means attaching a new one.  DRAINING
        stays draining: heartbeats prove liveness, not capacity)."""
        h = self.health[idx]
        if not self.is_alive(idx):
            return
        h.last_heartbeat = now
        h.strikes = 0
        h.missed = 0
        if h.state == DEGRADED:
            h.state = HEALTHY

    @_locked
    def check_heartbeats(self, now: float) -> None:
        """Tick-side liveness: an instance whose agent has not heartbeated
        for ``heartbeat_timeout_s`` misses windows; enough misses degrade
        then kill it (a wedged engine strands its whole virtual queue)."""
        timeout = self.cfg.heartbeat_timeout_s
        if timeout is None:
            return
        for idx, h in enumerate(self.health):
            if not self.is_alive(idx):
                continue
            if h.last_heartbeat is None:
                h.last_heartbeat = now   # start the window at first sight
                continue
            h.missed = int((now - h.last_heartbeat) // timeout)
            if h.missed >= self.cfg.dead_after_missed:
                self.mark_dead(idx, now, cause=(
                    f"missed {h.missed} heartbeat window(s) of {timeout}s"))
            elif h.missed >= self.cfg.degraded_after_missed \
                    and h.state == HEALTHY:
                h.state = DEGRADED

    # -- round watchdog (hang detection) -------------------------------
    def round_deadline(self, idx: int) -> Optional[float]:
        """Worst-case seconds a HEALTHY round on instance ``idx`` may
        take, derived from its calibrated HardwareProfile(s): one full
        prefill admission + a fused decode burst + a model swap.  None
        when the instance carries no profile (nothing to calibrate
        against)."""
        hws = list(self.instances[idx].hw_by_model.values())
        if not hws:
            return None
        return max(hw.prefill_time
                   + hw.decode_per_token * max(1, getattr(hw, "decode_burst",
                                                          1))
                   + hw.swap_time for hw in hws)

    @staticmethod
    def _progress_marker(engine) -> Optional[tuple]:
        """Monotone fingerprint of engine work: any dispatched round that
        did something moves at least one component.  ``lengths`` covers
        mid-prefill chunk progress (no counter bumps until the first
        token lands)."""
        stats = getattr(engine, "stats", None)
        if stats is None:
            return None
        marker = tuple(int(getattr(stats, f, 0)) for f in (
            "tokens_generated", "prefills", "prefill_chunks", "evictions",
            "resumes", "model_swaps", "cancellations"))
        lengths = getattr(engine, "lengths", None)
        if lengths is not None:
            marker += (int(sum(int(x) for x in lengths)),)
        return marker

    def _instance_busy(self, idx: int, engine) -> bool:
        num_active = getattr(engine, "num_active", None)
        if num_active is not None and num_active() > 0:
            return True
        vq = self.instances[idx].virtual_queue
        return vq.pending_requests() > 0

    @_locked
    def check_watchdog(self, now: float) -> None:
        """Per-round-deadline hang detection.  Heartbeats only fire on
        success, and a hung engine's rounds SUCCEED (they just do
        nothing) — so liveness here is defined as progress: an instance
        with work whose engine counters stay flat for more than
        ``hang_grace_rounds`` round deadlines is DEGRADED; past
        ``hang_dead_factor`` times that it is mark_dead exactly like a
        crash (abandon + redeliver + re-solve)."""
        grace = self.cfg.hang_grace_rounds
        if grace is None or self._engines is None:
            return
        for idx, h in enumerate(self.health):
            if not self.is_alive(idx):
                continue
            engine = self._engines[idx]
            if engine is None:
                continue
            marker = self._progress_marker(engine)
            if marker is None:
                continue
            if marker != h.progress_marker or h.last_progress is None \
                    or not self._instance_busy(idx, engine):
                h.progress_marker = marker
                h.last_progress = now
                continue
            deadline = self.round_deadline(idx)
            if deadline is None:
                continue
            stalled = now - h.last_progress
            budget = grace * deadline
            if stalled > budget * self.cfg.hang_dead_factor:
                self.hangs += 1
                self.mark_dead(idx, now, cause=(
                    f"hang: busy but no progress for {stalled:.3f}s "
                    f"(> {self.cfg.hang_dead_factor:g} x {budget:.3f}s "
                    f"round-watchdog budget)"))
            elif stalled > budget and h.state == HEALTHY:
                h.state = DEGRADED

    @_locked
    def report_engine_failure(self, idx: int, exc: BaseException, now: float,
                              engine=None) -> str:
        """Agent-exception supervision: fatal failures (``EngineCrashed`` /
        ``EngineDead`` — ``exc.fatal``) kill the instance immediately;
        transient errors strike it (DEGRADED) until
        ``cfg.transient_strikes`` consecutive strikes give up on it.
        Returns the resulting health state."""
        h = self.health[idx]
        if not self.is_alive(idx):
            return h.state
        if engine is not None and self._engines is not None:
            self._engines[idx] = engine
        if getattr(exc, "fatal", False):
            self.mark_dead(idx, now, cause=repr(exc), engine=engine)
            return DEAD
        h.strikes += 1
        if h.strikes >= self.cfg.transient_strikes:
            self.mark_dead(idx, now, cause=(
                f"{h.strikes} consecutive transient errors "
                f"(last: {exc!r})"), engine=engine)
            return DEAD
        h.state = DEGRADED
        return DEGRADED

    def backoff(self, n: int) -> float:
        """Redelivery backoff after the nth delivery failure (n >= 1):
        exponential, capped."""
        return min(self.cfg.backoff_cap_s,
                   self.cfg.backoff_base_s * (2.0 ** (n - 1)))

    @_locked
    def mark_dead(self, idx: int, now: float, cause: str = "killed",
                  engine=None) -> None:
        """Quarantine instance ``idx`` and recover its work (§4 fault
        tolerance: requests live in the global queue, virtual queues hold
        pointers — so losing an engine loses no request):

          1. the dead VQ is emptied (groups are pointers; the requests
             are still in the global queue);
          2. the engine's resident requests (slots + pushback limbo) are
             abandoned — KV accounting freed host-side, nothing stamped
             terminal — and redelivered with backoff;
          3. snapshots pinned in the dead pool are discarded (pins
             released so the dead BlockManager's accounting stays
             conserved) and their requests restart cleanly;
          4. requests whose model no longer has an alive instance are
             quarantined as recorded misses;
          5. surviving groups are re-placed on alive instances and the
             scheduler re-solves without the dead one.
        """
        h = self.health[idx]
        if h.state in (DEAD, DRAINED):
            return
        h.state = DEAD
        h.died_at = now
        h.cause = cause
        if engine is None and self._engines is not None:
            engine = self._engines[idx]
        dead_inst = self.instances[idx]
        dead_inst.virtual_queue.groups.clear()
        # 2.-5. need the engine quiescent: a contended miss means the
        # agent thread is MID-ROUND (usually blocked on our lock inside
        # ``_pull``) — abandoning slots or redelivering its residents now
        # would corrupt the live round / double-serve its requests.  The
        # instance is already DEAD, so the agent parks after this round
        # and the deferred salvage succeeds on the next tick.
        with _engine_guard(engine, timeout=1.0) as got:
            if got is False:
                self._pending_salvage.append((idx, engine))
                return
            self._salvage_dead(idx, engine, now)
        self._check_invariants()

    def _salvage_dead(self, idx: int, engine, now: float) -> None:
        """Steps 2.-5. of ``mark_dead`` (caller holds the engine guard —
        or the engine is lockless / known parked)."""
        dead_pool = getattr(engine, "block_mgr", None)
        # 2. reclaim engine-resident requests (crash salvage): KV
        # accounting freed host-side, nothing stamped terminal
        if engine is not None and hasattr(engine, "abandon"):
            for r in engine.abandon():
                if not r.finished():
                    self._redeliver(r, now)
        # 3./4. sweep the global queue: dead-pool snapshots, stragglers
        # still tagged as served by the dead instance, unservable models
        for r in list(self.global_queue):
            if r.finished():
                continue
            snap = r.snapshot
            if snap is not None and isinstance(snap, dict) \
                    and snap.get("pin_owner") is not None \
                    and snap.get("pin_owner") is dead_pool:
                # pinned in the dead pool: the pinned pages died with the
                # engine — release the pins (conserves the dead pool's
                # accounting) and restart from the prompt
                if snap.get("pinned"):
                    snap["pin_owner"].release_pins(snap["pinned"],
                                                   snap.get("pin_epoch"))
                r.restart()
            if getattr(r, "_served_by", None) == idx \
                    and getattr(r, "_in_flight", False):
                self._redeliver(r, now)
            if not r.finished() and not self.can_serve(r.model):
                self._quarantine(r, now, f"model {r.model} unservable "
                                         f"after instance {idx} died")
        # 5. re-place orphaned groups, then re-solve over the survivors
        self.gc_groups()
        for g in self.groups:
            if not g.done() and not self._placed(g):
                self._place_new_group(g, now)
        if self.schedulable_instances():
            self.reschedule(now)
            # cross-engine migration: re-placed requests whose eviction
            # snapshots are pinned in some OTHER alive pool must become
            # portable, or their new server refuses them forever
            self.migration_sweep(now)

    def _redeliver(self, r: Request, now: float) -> None:
        """Return an in-flight request to the (still-placed) global queue
        with retry budget + exponential backoff."""
        r._in_flight = False
        r._served_by = None
        r.redeliveries += 1
        if r.redeliveries > self.cfg.retry_budget:
            self._quarantine(r, now, f"retry budget exhausted after "
                                     f"{r.redeliveries} deliveries")
            return
        self.redeliveries += 1
        not_before = now + self.backoff(r.redeliveries)
        if r.first_token_time is None and not_before > r.deadline:
            # the backoff window already overshoots the TTFT deadline:
            # quarantine as a miss NOW instead of leaving the request
            # sitting unpullable in the queue until it expires (same
            # score, immediate terminal state — no zombie queue entries)
            self._quarantine(r, now, (
                f"redelivery backoff to t={not_before:.3f} overshoots "
                f"deadline t={r.deadline:.3f}"))
            return
        r.not_before = not_before
        if r.snapshot is None and (r.generated > 0 or r._prefill_done > 0):
            # generation state died with the engine and no snapshot
            # survived: restart cleanly (first_token_time kept — never
            # double-counted in attainment; see Request.restart)
            r.restart()

    def _quarantine(self, r: Request, now: float, cause: str) -> None:
        """Poison/unservable terminal state: a recorded SLO miss.  The
        request is stamped finished so group cursors skip it and gc moves
        it to ``finished``; ``failed`` makes attainment score it a miss
        even if a pre-crash first token landed in time."""
        r.failed = True
        r.fail_cause = cause
        r._in_flight = False
        r._served_by = None
        snap = r.snapshot
        if snap is not None and isinstance(snap, dict) and snap.get("pinned") \
                and snap.get("pin_owner") is not None:
            snap["pin_owner"].release_pins(snap["pinned"],
                                           snap.get("pin_epoch"))
        r.snapshot = None
        if r.completion_time is None:
            r.completion_time = now
        self.failed.append(r)

    # -- graceful drain + replacement (self-healing lifecycle) ----------
    @_locked
    def drain_instance(self, idx: int, now: float, *, evict: bool = False,
                       cause: str = "drain") -> None:
        """Graceful-decommission LSO: stop pulling new work onto instance
        ``idx``, hand its queued work to the survivors, and let the
        resident decodes finish (``evict=True`` evicts them instead —
        snapshots migrate and resume elsewhere).  The instance stays
        DRAINING (alive, residents finishing, no pulls) until ``tick``
        observes an empty engine and decommissions it to DRAINED."""
        h = self.health[idx]
        if h.state not in (HEALTHY, DEGRADED):
            return
        h.state = DRAINING
        h.cause = cause
        self.drains += 1
        inst = self.instances[idx]
        inst.virtual_queue.groups.clear()
        engine = self._engines[idx] if self._engines is not None else None
        if engine is not None:
            # bounded engine-lock wait: the draining engine's agent
            # thread is still running rounds (residents finish in place).
            # A contended miss means the agent is mid-round — evicting
            # its slots now would corrupt the round, so the evict defers
            # to the next tick (the round finishes, the lock frees).
            with _engine_guard(engine, timeout=1.0) as got:
                if got is False:
                    self._pending_evicts[idx] = (engine, evict)
                else:
                    self._drain_evict(engine, evict)
        # queued work that just lost its last schedulable server is a
        # recorded miss (residents still finish on the draining engine)
        for r in list(self.global_queue):
            if not r.finished() and not getattr(r, "_in_flight", False) \
                    and not self.can_serve(r.model):
                self._quarantine(r, now, f"model {r.model} unservable "
                                         f"while instance {idx} drains")
        self.gc_groups()
        for g in self.groups:
            if g.done() or self._placed(g):
                continue
            if self.can_serve(g.model):
                self._place_new_group(g, now)
            else:
                # residents-only remnant (members in flight on the
                # draining engine): keep it reachable here — nothing in
                # it is pullable, and _finish_drains reconciles the rest
                inst.virtual_queue.groups.append(g)
        if self.schedulable_instances():
            self.reschedule(now)
            self.migration_sweep(now)
        self._check_invariants()

    def _drain_evict(self, engine, evict: bool) -> None:
        """Engine-touching half of ``drain_instance`` (caller holds the
        engine guard — or the engine is lockless)."""
        if evict and hasattr(engine, "evict_slot"):
            for slot in list(engine.active_slots()):
                r = engine.evict_slot(slot)
                r._in_flight = False
                r._served_by = None
            pushed = engine.take_pushback()
            if pushed is not None:
                pushed._in_flight = False
                pushed._served_by = None
        # departing capacity must not hold anyone's prefix pages:
        # promote every snapshot pinned in this pool to portable form
        # now, so the requests resume on OTHER engines (cross-engine
        # migration) instead of waiting out the drain
        pinned_here = [r for r in getattr(engine, "_pinned_snapshots", ())
                       if r.snapshot is not None
                       and r.snapshot.get("pinned")]
        if pinned_here:
            engine._materialize_pinned_snapshots()
            self.migrations += len(pinned_here)

    @_locked
    def _retry_deferred(self, now: float) -> None:
        """Tick-side retry of engine-touching LSOs that hit a contended
        engine guard (the agent was mid-round when ``mark_dead`` /
        ``drain_instance`` ran).  Dead/draining agents park or finish
        their round quickly, so these drain within a tick or two."""
        if self._pending_salvage:
            still = []
            for idx, engine in self._pending_salvage:
                with _engine_guard(engine) as got:
                    if got is False:
                        still.append((idx, engine))
                        continue
                    self._salvage_dead(idx, engine, now)
            self._pending_salvage = still
        for idx in list(self._pending_evicts):
            engine, evict = self._pending_evicts[idx]
            if self.health[idx].state != DRAINING:
                # the drain resolved some other way (e.g. the instance
                # died outright and was salvaged)
                del self._pending_evicts[idx]
                continue
            with _engine_guard(engine) as got:
                if got is False:
                    continue
                self._drain_evict(engine, evict)
            del self._pending_evicts[idx]
            # evicted members are pullable again, but their groups may be
            # parked on the (non-schedulable) draining VQ as residents-
            # only remnants: re-place them on the survivors
            self.instances[idx].virtual_queue.groups.clear()
            self.gc_groups()
            for g in self.groups:
                if g.done() or self._placed(g):
                    continue
                if self.can_serve(g.model):
                    self._place_new_group(g, now)
                else:
                    for r in g.requests:
                        if not r.finished():
                            self._quarantine(r, now, (
                                f"model {r.model} unservable after "
                                f"deferred evict on instance {idx}"))
            if self.schedulable_instances():
                self.reschedule(now)
                self.migration_sweep(now)

    @_locked
    def _finish_drains(self, now: float) -> None:
        """Decommission DRAINING instances whose engines emptied out:
        state -> DRAINED, VQ cleared, any member a late pushback left
        queued here re-placed (or quarantined if its model lost its last
        server)."""
        for idx, h in enumerate(self.health):
            if h.state != DRAINING:
                continue
            engine = self._engines[idx] if self._engines is not None \
                else None
            if engine is not None:
                if getattr(engine, "num_active", lambda: 0)() > 0:
                    continue
                if getattr(engine, "_pushback", None) is not None:
                    continue
            h.state = DRAINED
            h.died_at = now
            self.instances[idx].virtual_queue.groups.clear()
            self.gc_groups()
            for g in self.groups:
                if g.done() or self._placed(g):
                    continue
                if self.can_serve(g.model):
                    self._place_new_group(g, now)
                else:
                    for r in g.requests:
                        if not r.finished():
                            self._quarantine(r, now, (
                                f"model {r.model} unservable after "
                                f"instance {idx} drained"))
            self._check_invariants()

    @_locked
    def replace_instance(self, idx: int, engine, now: float,
                         hw_by_model=None, model_name=None) -> None:
        """Attach a fresh engine in a departed slot: DEAD/DRAINED stops
        being terminal for the CLUSTER, only for the instance that died.
        The virtual queue is reused (it holds pointers, and it was
        emptied when the predecessor departed), health resets to
        HEALTHY, and a re-solve spreads queued + redelivered work onto
        the recovered capacity."""
        h = self.health[idx]
        if h.state not in (DEAD, DRAINED):
            raise ValueError(
                f"instance {idx} is {h.state}: only departed "
                f"(dead/drained) instances can be replaced")
        # flush any salvage still deferred for this slot BEFORE the new
        # engine takes it: the retry keys requests on ``_served_by ==
        # idx``, which would resolve to the REPLACEMENT after this point.
        # The departed agent is parked, so the bounded wait succeeds; on
        # a pathological miss salvage proceeds unguarded — the old
        # engine is being discarded either way.
        for i, old_engine in [p for p in self._pending_salvage
                              if p[0] == idx]:
            with _engine_guard(old_engine, timeout=1.0):
                self._salvage_dead(i, old_engine, now)
        self._pending_salvage = [p for p in self._pending_salvage
                                 if p[0] != idx]
        self._pending_evicts.pop(idx, None)
        inst = self.instances[idx]
        inst.virtual_queue.groups.clear()
        if hw_by_model is not None:
            inst.hw_by_model = dict(hw_by_model)
        inst.current_model = model_name if model_name is not None \
            else getattr(engine, "model_name", inst.current_model)
        if self._engines is None:
            self._engines = [None] * len(self.instances)
        self._engines[idx] = engine
        self.health[idx] = InstanceHealth(last_heartbeat=now)
        self.replacements += 1
        self.reschedule(now)
        self.migration_sweep(now)
        self._check_invariants()

    # -- cross-engine snapshot migration --------------------------------
    def _pool_owner(self, pool) -> Optional[int]:
        """Index of the ALIVE attached engine whose current pool is
        ``pool`` (None: the pool died, was swapped out, or is foreign)."""
        if pool is None or self._engines is None:
            return None
        for idx, eng in enumerate(self._engines):
            if eng is not None and self.is_alive(idx) \
                    and getattr(eng, "block_mgr", None) is pool:
                return idx
        return None

    @_locked
    def migration_sweep(self, now: float) -> int:
        """Make stranded-by-pinning snapshots portable (the recovery half
        of the eviction LSO).  A request whose snapshot pins shared-
        prefix pages in pool A can only resume on A's engine; when the
        scheduler placed it elsewhere (death, drain, or rebalance), ask
        the OWNING engine to materialize the snapshot — pinned page
        contents copied into it, pins released — after which any alive
        engine of the same KV layout resumes it token-identically.
        Pins whose owner departed or reset its pool are released (the
        pages are gone) and the request restarts from its prompt.
        Returns the number of snapshots migrated."""
        if self._engines is None:
            return 0
        placed = {}
        for idx, inst in enumerate(self.instances):
            for g in inst.virtual_queue.groups:
                placed[g.group_id] = idx
        migrated = 0
        for r in self.global_queue:
            if r.finished() or getattr(r, "_in_flight", False):
                continue
            snap = r.snapshot
            if not isinstance(snap, dict) or not snap.get("pinned"):
                continue
            pool = snap.get("pin_owner")
            owner = self._pool_owner(pool)
            if owner is None \
                    or snap.get("pin_epoch") != getattr(pool, "epoch", None):
                # the pinned pages no longer exist: release (stale-epoch
                # release is a no-op) and recompute from the prompt
                pool.release_pins(snap["pinned"], snap.get("pin_epoch"))
                r.restart()
                continue
            home = placed.get(r.group_id)
            if home == owner and self.is_schedulable(owner):
                continue   # its own engine will resume it: pins transfer
            engine = self._engines[owner]
            if not hasattr(engine, "materialize_snapshot"):
                continue
            # non-blocking: the owner's agent may be mid-round — skip
            # this snapshot and retry on the next tick's sweep rather
            # than stall the controller (``got`` is False only when a
            # REAL lock was busy; lockless engines proceed unguarded)
            with _engine_guard(engine) as got:
                if got is False:
                    # real lock busy (agent mid-round): skip this sweep
                    # rather than stall the controller; lockless engines
                    # yield None and proceed unguarded
                    continue
                if engine.materialize_snapshot(r):
                    migrated += 1
                    self.migrations += 1
        return migrated

    @property
    def max_group(self) -> int:
        return max(1, int(self.cfg.avg_batch_size * self.cfg.delta))

    # ------------------------------------------------------------------
    @_locked
    @tracing.spanned("qlm.submit")
    def submit(self, req: Request, now: float) -> bool:
        """API-gateway entry: enqueue, classify into a group, reschedule if
        the RWT estimator predicts a violation.

        When NO alive instance can serve ``req.model`` the request is
        recorded as a 400-style rejection (an attainment miss) and
        ``False`` is returned — once, here, instead of raising out of the
        serve path (one bad request must not kill the loop) or letting
        ``predict_violation`` report an unfixable violation every
        cooldown tick (solver thrash)."""
        if not self.can_serve(req.model):
            self.record_rejection(req, now)
            return False
        self.global_queue.append(req)
        g = classify_into_groups(req, self.groups, max_group=self.max_group)
        if g is None:
            g = RequestGroup(model=req.model, slo=req.slo)
            g.add(req)
            self.groups.append(g)
            self._place_new_group(g, now)
        elif not self._placed(g):
            # liveness: the group existed but is reachable from no instance
            # (an infeasible-solve set_order/_edf_fallback dropped it, or a
            # VQ popped it while momentarily done) — without re-placement
            # the new request would strand in the global queue until an
            # unrelated violation triggers a full reschedule
            self._place_new_group(g, now)
        if self.cfg.reschedule_on_arrival and \
                now - self._last_reschedule >= self.cfg.reschedule_cooldown and \
                self.scheduler.predict_violation(self.schedulable_instances(),
                                                 now):
            self.reschedule(now)
        return True

    @_locked
    def submit_batch(self, requests: Sequence[Request], now: float) -> None:
        """Bulk arrival: form groups with Algorithm 1 k-means, then solve."""
        self.global_queue.extend(requests)
        new_groups = create_request_groups(
            requests, avg_batch_size=self.cfg.avg_batch_size,
            delta=self.cfg.delta)
        self.groups.extend(new_groups)
        self.reschedule(now)

    def _placed(self, g: RequestGroup) -> bool:
        """Is ``g`` reachable from at least one instance's virtual queue?"""
        return any(g is q for inst in self.instances
                   for q in inst.virtual_queue.groups)

    @_locked
    def record_rejection(self, req: Request, now: float) -> None:
        """Admission-control / backpressure rejection (§9 option (c)):
        the request never enters the global queue, but attainment
        accounting must still see it as a miss."""
        req.rejected = True
        if req.completion_time is None:
            req.completion_time = now
        self.rejected.append(req)

    def _place_new_group(self, g: RequestGroup, now: float) -> None:
        """Cheap placement for a singleton group (full solve happens on
        violation): minimize the RWT-estimated drain of (queue + group) —
        heterogeneity-aware (Design Principle #3: an A10 absorbs
        proportionally less work than an A100), unlike a raw request count.
        """
        candidates = [i for i in self.schedulable_instances()
                      if g.model in i.hw_by_model]
        if not candidates:
            # submit() rejects unservable models and mark_dead() /
            # drain_instance() quarantine orphans before re-placing, so
            # this is a controller bug, not load
            raise ValueError(f"no alive instance can serve model {g.model}")
        wl = g.workload_profile()

        def drain(i):
            theta = i.hw(g.model).throughput(wl)
            backlog = i.virtual_queue.pending_requests() + len(g.pending())
            swap = 0.0 if i.current_model in (None, g.model) \
                else i.hw(g.model).swap_time
            return backlog * wl.mu_output / theta + swap

        inst = min(candidates, key=drain)
        inst.virtual_queue.groups.append(g)

    # ------------------------------------------------------------------
    @_locked
    @tracing.spanned("qlm.reschedule")
    def reschedule(self, now: float):
        """Re-solve over the SCHEDULABLE instances only: dead/drained VQs
        were emptied when the instance departed and must stay empty, and
        a draining instance is departing capacity the solver must not
        count on."""
        self.gc_groups()
        self._last_reschedule = now
        if self.cfg.routing == "slice":
            self.routing_invocations += 1
            return routing.slice_schedule(self, now)
        return self.scheduler.schedule(self.groups,
                                       self.schedulable_instances(), now)

    @_locked
    @tracing.spanned("qlm.tick")
    def tick(self, now: float) -> bool:
        """Periodic violation check (returns True if it rescheduled).

        Respects ``reschedule_cooldown`` like the submit path: under
        sustained overload ``predict_violation`` stays true on every tick,
        and re-solving each time churns the VQ orders (each re-solve moves
        group heads, firing the agents' head-change eviction LSO) without
        any new information to act on.
        """
        self.check_watchdog(now)
        self.check_heartbeats(now)
        self._retry_deferred(now)
        self._finish_drains(now)
        self.migration_sweep(now)
        if now - self._last_reschedule < self.cfg.reschedule_cooldown:
            self._check_invariants()
            return False
        rescheduled = False
        if self.scheduler.predict_violation(self.schedulable_instances(),
                                            now):
            self.reschedule(now)
            rescheduled = True
        self._check_invariants()
        return rescheduled

    _inv_sampler = None

    @tracing.spanned("qlm.check_invariants")
    def _check_invariants(self) -> None:
        """Tick-boundary hook: queue-layer state (group placement, member
        ownership) is only quiescent between scheduler actions.

        Thread-awareness: ``check_queue_layer`` touches only
        controller-lock-guarded state, so it always runs.  The
        engine-residency cross-checks (``check_terminal_states`` /
        ``check_migration``) read every engine's slots and pushback,
        which are only consistent at round boundaries — so they run
        only when every engine's round lock try-acquires (i.e. every
        engine is between rounds).  A busy engine defers them to the
        next tick; single-threaded drivers always acquire."""
        if not self.cfg.debug_invariants:
            from repro_torch.analysis.invariants import invariants_enabled
            if not invariants_enabled():
                return
        if self._inv_sampler is None:
            from repro_torch.analysis.invariants import InvariantSampler
            self._inv_sampler = InvariantSampler()
        if not self._inv_sampler.due():
            return
        from repro_torch.analysis.invariants import (check_migration,
                                               check_queue_layer,
                                               check_terminal_states)
        if self._pending_salvage or self._pending_evicts:
            # deferred salvage/evict means the queue layer is knowingly
            # mid-transition (a dead VQ is cleared but its groups are not
            # re-placed until the retry lands, and some engine's
            # residency state is stale): skip ALL checks until then
            return
        check_queue_layer(self, where="controller.tick")
        with contextlib.ExitStack() as stack:
            quiescent = True
            for eng in (self._engines or ()):
                guard = stack.enter_context(_engine_guard(eng))
                if guard is False:
                    quiescent = False
                    break
            if quiescent:
                check_terminal_states(self, engines=self._engines,
                                      where="controller.tick")
                check_migration(self, engines=self._engines,
                                where="controller.tick")

    @_locked
    def gc_groups(self) -> None:
        self.groups = [g for g in self.groups if not g.done()]
        still = []
        for r in self.global_queue:
            (self.finished if r.finished() else still).append(r)
        self.global_queue = still

    # ------------------------------------------------------------------
    def all_requests(self) -> List[Request]:
        return self.finished + self.global_queue

    @_locked
    def slo_attainment(self, now: Optional[float] = None) -> float:
        """Fraction of SCORED requests that met their TTFT SLO.

        Scored = served requests (TTFT recorded) + definite misses that
        never got a first token: admission rejections, shed/expired
        requests, and — when ``now`` is given — requests still queued past
        their deadline (stranded).  Counting only TTFT-recorded requests
        silently inflates attainment exactly when the system is dropping
        or stranding traffic.  Client cancellations without a first token
        are excluded (the client walked away; the system didn't fail it)
        unless the deadline had already passed.
        """
        scored = hits = 0
        for r in self.all_requests() + self.rejected:
            # failed-quarantined is checked FIRST: a poison request may
            # have produced an in-SLO first token before killing its
            # engines — it still failed the client (unconditional miss)
            if r.failed:
                scored += 1
                continue
            met = r.slo_met()
            if met is not None:
                scored += 1
                hits += int(met)
                continue
            # no first token ever recorded
            if r.rejected or r.expired or r.shed:
                scored += 1          # dropped without service: miss
            elif now is not None and now > r.deadline:
                scored += 1          # past deadline and still unstarted: miss
        if scored == 0:
            return 1.0
        return hits / scored
