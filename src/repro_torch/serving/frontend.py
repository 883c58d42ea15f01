"""Async continuous-batching front end: the millions-of-users surface.

``launch/serve.py`` drives the QLM stack as a synchronous polling loop —
no backpressure, no cancellation, no way to shed batch traffic when
interactive SLOs are at risk; exactly the failure mode a queue manager
exists to prevent.  ``AsyncServer`` puts a real queue manager in front of
the engines (blueprint: the Redis LLM-queue architecture — a bounded
request queue decoupling producers from LLM workers, with depth
visibility and backpressure to the ingest layer):

  * **bounded request queue** — queue depth is the number of admitted
    requests that have not yet produced a first token; ``submit()``
    rejects 429-style at hard capacity (``FrontendConfig.queue_depth``),
    and a high/low **watermark** pair gives hysteresis backpressure: once
    depth crosses ``high_watermark`` the server sheds batch-class
    arrivals at the door until depth falls back under ``low_watermark``
    (interactive traffic keeps flowing until the hard cap);
  * **admission control** — optional ``core.autoscale.AdmissionController``
    gate: reject when the RWT-estimated queue drain already exceeds the
    request's own TTFT SLO (``admission="slo"``) or a fixed bound
    (``admission=<seconds>``) — §9 option (c), rate limiting so admitted
    requests can still meet SLOs;
  * **per-request deadlines** — a request whose deadline passes before
    any dispatch is EXPIRED: it never reaches an engine, its group cursor
    skips it, and attainment accounting counts it as a miss (not a
    silent omission);
  * **cancellation** — ``RequestStream.cancel()`` propagates into the
    engine mid-decode/mid-prefill via ``engine.cancel_request``: the slot
    is freed and its KV pages are back on the free list at the next sweep
    (contract documented in ``serving/engine.py``);
  * **token streaming** — ``submit()`` returns a ``RequestStream`` async
    iterator; tokens are pumped from the engine's per-request output
    after every iteration, so a client consumes them while the request
    is still decoding;
  * **graceful shedding** — when ``GlobalScheduler.violations`` predicts
    an *interactive* deadline violation (``slo_ceiling`` filter), the
    server defers batch-class groups behind interactive ones in the hot
    instance's virtual queue and evicts (``shed_policy="defer"``) or
    cancels (``"drop"``) the running batch-class slots, freeing capacity
    for the traffic that is actually at risk.

The event loop owns the engines: one cooperative task interleaves
sweeping (cancellation + deadline expiry), arrival pumping, shedding, one
``QLMAgent.run_iteration()`` per instance, and token pumping, yielding to
client coroutines between iterations.  JAX dispatch is synchronous on
CPU, so an iteration blocks the loop for its compute — the awaits between
iterations are where submissions, cancellations and stream consumption
interleave.

Multi-turn sessions (``data.workload.Session``) ride this surface: a
follow-up request re-enters the queue carrying the previous turns' tokens
as a prompt prefix, so the prefix index and ``fork_slot`` serve real
session traffic (drive them with ``run_session``).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

from repro_torch.core.autoscale import AdmissionController
from repro_torch.core.qlm import DEAD, QLMController
from repro_torch.core.request import SLO_INTERACTIVE, Request
from repro_torch.core.rwt_estimator import WorkloadProfile
from repro_torch.serving.faults import EngineFailure

if TYPE_CHECKING:  # lso imports serving.engine — avoid the import cycle
    from repro_torch.core.lso import QLMAgent

_DONE = object()          # stream sentinel: normal termination
SHED_POLICIES = ("off", "defer", "drop")


@dataclasses.dataclass
class FrontendConfig:
    # Hard bound on queued-unstarted requests: submissions past this are
    # rejected 429-style regardless of class.
    queue_depth: int = 64
    # Backpressure hysteresis (absolute request counts; None derives 3/4
    # and 1/2 of queue_depth).  Engaged at >= high, released at <= low;
    # while engaged, batch-class arrivals are rejected at the door.
    high_watermark: Optional[int] = None
    low_watermark: Optional[int] = None
    # Overload shedding when an INTERACTIVE violation is predicted:
    # "defer" evicts running batch-class slots (resumable) and pushes
    # batch groups behind interactive ones; "drop" cancels them outright;
    # "off" disables.
    shed_policy: str = "defer"
    shed_cooldown_s: float = 0.25
    # Groups with slo <= this are "interactive" for shedding/backpressure
    # class decisions (the paper's 20 s class by default).
    interactive_slo_ceiling: float = SLO_INTERACTIVE
    # RWT admission gate: None = off; "slo" bounds estimated drain by each
    # request's own TTFT SLO; a float is a fixed drain bound in seconds.
    admission: Optional[object] = None
    # Event-loop pacing: sleep this long when no engine has active slots
    # (0 -> bare yield).
    idle_sleep_s: float = 0.002
    # Periodic controller.tick() interval (violation-triggered reschedule
    # off the submit path).
    tick_interval_s: float = 0.25

    def resolved_watermarks(self) -> Tuple[int, int]:
        high = self.high_watermark
        low = self.low_watermark
        if high is None:
            high = max(1, (3 * self.queue_depth) // 4)
        if low is None:
            low = max(0, self.queue_depth // 2)
        return high, min(low, high)


@dataclasses.dataclass
class FrontendStats:
    submitted: int = 0
    accepted: int = 0
    rejected_full: int = 0           # hard queue_depth cap
    rejected_backpressure: int = 0   # watermark shed of batch arrivals
    rejected_admission: int = 0      # RWT drain gate
    rejected_deadline: int = 0       # dead on arrival (deadline already past)
    rejected_unservable: int = 0     # 400-style: no alive instance serves it
    rejected_capacity: int = 0       # 503-style: capacity-scaled queue bound
    engine_failures: int = 0         # agent iterations that raised
    expired: int = 0                 # deadline passed while queued
    cancelled: int = 0               # client cancellations executed
    shed_deferred: int = 0           # running slots evicted by the shedder
    shed_dropped: int = 0            # running slots cancelled by the shedder
    deferred_groups: int = 0         # batch groups pushed behind interactive
    tokens_streamed: int = 0
    backpressure_engagements: int = 0
    max_queue_depth: int = 0
    iterations: int = 0

    @property
    def rejected(self) -> int:
        return (self.rejected_full + self.rejected_backpressure
                + self.rejected_admission + self.rejected_deadline
                + self.rejected_unservable + self.rejected_capacity)

    # Every rate below guards its denominator: a zero-request run (or a
    # run where everything was rejected) must report clean numbers, not
    # raise ZeroDivisionError mid-shutdown or leak NaN into JSON stats.
    @property
    def acceptance_rate(self) -> float:
        """accepted / submitted; vacuously 1.0 when nothing arrived."""
        return self.accepted / self.submitted if self.submitted else 1.0

    @property
    def rejection_rate(self) -> float:
        return self.rejected / self.submitted if self.submitted else 0.0

    @property
    def expiry_rate(self) -> float:
        """Queue-expired fraction of what was actually accepted."""
        return self.expired / self.accepted if self.accepted else 0.0

    @property
    def mean_tokens_per_accepted(self) -> float:
        return (self.tokens_streamed / self.accepted
                if self.accepted else 0.0)


class RequestStream:
    """Per-request async token iterator — the client's handle.

    ``async for tok in stream`` yields tokens as the engine produces them
    and terminates when the request finishes, is cancelled, expires, or
    was rejected.  ``status`` distinguishes the outcomes.
    """

    def __init__(self, req: Request, server: "AsyncServer"):
        self.request = req
        self._server = server
        self._queue: asyncio.Queue = asyncio.Queue()
        self._delivered = 0
        self._finished = False
        self._exc: Optional[BaseException] = None

    def __aiter__(self) -> "RequestStream":
        return self

    async def __anext__(self) -> int:
        if self._finished and self._queue.empty():
            if self._exc is not None:
                raise self._exc
            raise StopAsyncIteration
        tok = await self._queue.get()
        if tok is _DONE:
            self._finished = True
            if self._exc is not None:
                raise self._exc
            raise StopAsyncIteration
        return tok

    def cancel(self) -> None:
        """Request cancellation: the server sweep executes it before the
        next engine iteration (slot + KV pages freed mid-decode)."""
        self.request.cancel_requested = True

    async def drain(self) -> List[int]:
        """Consume the remainder of the stream and return all its tokens."""
        async for _ in self:
            pass
        return list(self.request.output_tokens)

    @property
    def status(self) -> str:
        r = self.request
        if r.rejected:
            return "rejected"
        if r.failed:
            return "failed"       # quarantined after engine death(s)
        if r.expired:
            return "expired"
        if r.shed:
            return "shed"
        if r.cancelled:
            return "cancelled"
        if r.finished():
            return "completed"
        return "queued" if r.first_token_time is None else "running"

    # server-side plumbing -------------------------------------------------
    def _push(self, tok: int) -> None:
        self._queue.put_nowait(tok)

    def _abort(self, exc: BaseException) -> None:
        """Serve-loop crash: fail this stream's consumers with the crash
        instead of leaving them awaiting tokens that will never come."""
        self._exc = exc
        self._queue.put_nowait(_DONE)

    def _close(self) -> None:
        self._queue.put_nowait(_DONE)


class AsyncServer:
    """Event-loop front end over a ``QLMController`` + one ``QLMAgent``
    per instance (``controller.instances`` order must match ``agents``)."""

    def __init__(self, controller: QLMController, agents: List[QLMAgent],
                 cfg: Optional[FrontendConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        if cfg is not None and cfg.shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {cfg.shed_policy!r}")
        assert len(agents) == len(controller.instances), \
            (len(agents), len(controller.instances))
        self.controller = controller
        self.agents = list(agents)
        self.cfg = cfg or FrontendConfig()
        self.clock = clock
        self.stats = FrontendStats()
        self._live: Dict[int, RequestStream] = {}   # req_id -> stream
        self._backpressure = False
        self._stopping = False
        self._task: Optional[asyncio.Task] = None
        self._last_shed = -1e18
        self._last_tick = -1e18
        self._admission: Dict[tuple, AdmissionController] = {}
        # supervision: the controller reclaims a dead engine's resident
        # requests (mark_dead -> abandon) and the terminal-state invariant
        # cross-checks engine residency
        controller.attach_engines(self.engines)

    # -- context manager ---------------------------------------------------
    async def __aenter__(self) -> "AsyncServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def engines(self):
        return [a.engine for a in self.agents]

    # -- ingress -----------------------------------------------------------
    def queue_depth(self) -> int:
        """Admitted requests with no first token yet (the bounded queue)."""
        return sum(1 for s in self._live.values()
                   if s.request.first_token_time is None
                   and not s.request.finished())

    def _is_interactive(self, req: Request) -> bool:
        return req.slo <= self.cfg.interactive_slo_ceiling

    def _scaled_limits(self) -> Tuple[int, int, int]:
        """(hard cap, high, low) scaled by the serving-capacity fraction:
        when engines die OR drain (departing capacity counts as gone for
        NEW work), the queue the survivors can absorb in the same time
        shrinks proportionally, so the watermarks tighten and excess
        arrivals shed 503-style instead of stranding past their SLOs.
        Zero serving capacity (all dead/draining, or no instances
        attached at all) pins the cap to 0: everything rejects
        503-style, nothing throws."""
        high, low = self.cfg.resolved_watermarks()
        frac = getattr(self.controller, "serving_fraction",
                       self.controller.alive_fraction)()
        if frac >= 1.0:
            return self.cfg.queue_depth, high, low
        if frac <= 0.0:
            return 0, 0, 0
        cap = max(1, int(self.cfg.queue_depth * frac))
        return cap, max(1, int(high * frac)), int(low * frac)

    def _update_backpressure(self, depth: int) -> None:
        _, high, low = self._scaled_limits()
        if not self._backpressure and depth >= high:
            self._backpressure = True
            self.stats.backpressure_engagements += 1
        elif self._backpressure and depth <= low:
            self._backpressure = False

    def _admission_gate(self, req: Request, depth: int) -> bool:
        """True = admit.  Lazily builds one AdmissionController per
        (model, bound, serving-set) — the §9(c) drain check against the
        best CALIBRATED profile among the SCHEDULABLE instances that can
        serve this model, with the cluster-wide queue depth split across
        them.  Keying on the serving-set identity rebuilds the gate when
        instances die, drain, or get replaced (a cached controller built
        from a dead instance's profile would mis-bound forever)."""
        if self.cfg.admission is None:
            return True
        bound = req.slo if self.cfg.admission == "slo" \
            else float(self.cfg.admission)  # type: ignore[arg-type]
        serving = tuple(
            i.instance_id
            for idx, i in enumerate(self.controller.instances)
            if self.controller.is_schedulable(idx)
            and req.model in i.hw_by_model)
        if not serving:
            # can_serve() gated above; a race that empties the set
            # between the two checks falls through to the queue bound
            return True
        # replacements reuse the slot id but may carry a new profile:
        # the counter in the key forces a rebuild after every replace
        key = (req.model, bound, serving,
               getattr(self.controller, "replacements", 0))
        ac = self._admission.get(key)
        if ac is None:
            by_id = {i.instance_id: i for i in self.controller.instances}
            hws = [by_id[sid].hw(req.model) for sid in serving]
            hw = max(hws, key=lambda h: h.throughput(
                WorkloadProfile(req.prompt_len, 1.0,
                                float(req.max_new_tokens), 1.0)))
            ac = AdmissionController(self.controller.estimator, hw, bound,
                                     n_instances=len(serving))
            self._admission[key] = ac
        return ac.admit(req, depth)

    def _reject(self, req: Request, now: float, counter: str) -> RequestStream:
        self.controller.record_rejection(req, now)
        setattr(self.stats, counter, getattr(self.stats, counter) + 1)
        stream = RequestStream(req, self)
        stream._close()
        return stream

    async def submit(self, req: Request) -> RequestStream:
        """Gateway entry.  Always returns a stream; a rejected request's
        stream terminates immediately with ``status == "rejected"``
        (429-style — the paper's admission-control option, not an
        exception, so callers can account it)."""
        now = self.clock()
        self.stats.submitted += 1
        if self._task is not None and self._task.done():
            # fail fast instead of queueing onto a dead loop
            self._task.result()  # re-raises the serve loop's crash
        if self._stopping:
            return self._reject(req, now, "rejected_full")
        # 400-style: a model no ALIVE instance serves gets a recorded
        # rejection (an attainment miss), not an exception — one bad
        # request or a dead engine pool must not kill the serve loop
        if not self.controller.can_serve(req.model):
            return self._reject(req, now, "rejected_unservable")
        if now > req.deadline:
            req.expired = True
            return self._reject(req, now, "rejected_deadline")
        depth = self.queue_depth()
        self.stats.max_queue_depth = max(self.stats.max_queue_depth, depth)
        cap, _, _ = self._scaled_limits()
        self._update_backpressure(depth)
        if depth >= cap:
            # 503-style when the bound shrank with lost capacity,
            # 429-style at the configured hard cap
            return self._reject(req, now, "rejected_capacity"
                                if cap < self.cfg.queue_depth
                                else "rejected_full")
        if self._backpressure and not self._is_interactive(req):
            return self._reject(req, now, "rejected_backpressure")
        if not self._admission_gate(req, depth):
            return self._reject(req, now, "rejected_admission")
        self.controller.submit(req, now)
        self.stats.accepted += 1
        stream = RequestStream(req, self)
        self._live[req.req_id] = stream
        return stream

    # -- lifecycle sweeps (run on the loop task, never mid-dispatch) -------
    def _terminate(self, req: Request, now: float) -> None:
        """Free any engine-side state (slot / snapshot) for a request that
        will never run again, then stamp it finished so group cursors
        skip it.  Dead engines are skipped: their state was reclaimed by
        ``mark_dead`` and there is nothing left to cancel."""
        for idx, eng in enumerate(self.engines):
            if self.controller.is_alive(idx) and eng.cancel_request(req):
                break
        req._in_flight = False
        req._served_by = None
        if req.completion_time is None:
            req.completion_time = now

    def _sweep(self, now: float) -> None:
        for stream in list(self._live.values()):
            req = stream.request
            if req.finished():
                continue
            if req.cancel_requested:
                self._terminate(req, now)
                req.cancelled = True
                self.stats.cancelled += 1
            elif req.first_token_time is None and now > req.deadline:
                # deadline-expired while queued: never dispatch it — the
                # capacity goes to requests that can still meet their SLO
                self._terminate(req, now)
                req.expired = True
                self.stats.expired += 1

    def _maybe_shed(self, now: float) -> None:
        cfg = self.cfg
        if cfg.shed_policy == "off" \
                or now - self._last_shed < cfg.shed_cooldown_s:
            return
        # the cooldown paces the CHECK, not just the shed: the violations
        # walk is O(groups) of estimator math, far too hot for every
        # engine iteration
        self._last_shed = now
        # alive (instance, agent) pairs: a dead engine has no slots to
        # shed, and misaligning infos with agents would read the wrong
        # engine's inflight drain
        pairs = [(inst, agent) for idx, (inst, agent)
                 in enumerate(zip(self.controller.instances, self.agents))
                 if self.controller.is_alive(idx)]
        infos = [inst for inst, _ in pairs]
        hot = self.controller.scheduler.violations(
            infos, now, slo_ceiling=cfg.interactive_slo_ceiling,
            inflight=self._inflight_drain(pairs))
        ceiling = cfg.interactive_slo_ceiling
        for inst in infos:
            vq = inst.virtual_queue
            inter = [g for g in vq.groups
                     if not g.done() and g.slo <= ceiling]
            if not inter:
                continue
            batch = [g for g in vq.groups
                     if not g.done() and g.slo > ceiling]
            # defer: interactive groups drain first, batch groups keep
            # their relative order behind them.  Ordering alone waits for
            # no violation — reacting only once a deadline is PREDICTED
            # to blow leaves every queued interactive request one queue
            # drain short of its SLO (new arrivals land at the VQ tail,
            # behind previously deferred batch work)
            if batch and self._batch_ahead(vq.groups, ceiling):
                vq.set_order(inter + batch)
                self.stats.deferred_groups += len(batch)
            # eviction is the expensive lever: only when this instance's
            # walk actually predicts an interactive violation
            if inst not in hot:
                continue
            eng = self._engine_for(inst)
            if eng is None:
                continue
            drop = cfg.shed_policy == "drop"
            shed = eng.shed_slots(
                lambda r: r.slo > ceiling, drop=drop)
            if drop:
                self.stats.shed_dropped += len(shed)
            else:
                self.stats.shed_deferred += len(shed)

    @staticmethod
    def _batch_ahead(groups, ceiling: float) -> bool:
        """True if some undone batch group precedes an undone interactive
        group (i.e. the defer reorder would change anything)."""
        seen_batch = False
        for g in groups:
            if g.done():
                continue
            if g.slo > ceiling:
                seen_batch = True
            elif seen_batch:
                return True
        return False

    def _inflight_drain(self, pairs) -> List[float]:
        """Seconds until each instance's engine can free a slot — the VQ
        walk's seed.  0 when a slot is already free; otherwise the fastest
        running request's remaining decode (a queued request cannot start
        sooner than that).  Takes (instance, agent) PAIRS so a filtered
        alive subset stays aligned with its engines."""
        out = []
        for inst, agent in pairs:
            eng = agent.engine
            running = eng.running_requests()
            hw = inst.hw_by_model.get(eng.model_name)
            if hw is None or len(running) < eng.cfg.max_slots:
                out.append(0.0)
                continue
            steps = min(max(0, r.max_new_tokens - len(r.output_tokens))
                        for r in running)
            out.append(steps * hw.decode_per_token * hw.inefficiency)
        return out

    def _engine_for(self, inst):
        for i, agent in zip(self.controller.instances, self.agents):
            if i is inst:
                return agent.engine
        return None

    def _pump_tokens(self) -> None:
        for req_id, stream in list(self._live.items()):
            req = stream.request
            toks = req.output_tokens
            while stream._delivered < len(toks):
                stream._push(int(toks[stream._delivered]))
                stream._delivered += 1
                self.stats.tokens_streamed += 1
            if req.finished():
                stream._close()
                del self._live[req_id]

    # -- the event loop ----------------------------------------------------
    async def start(self) -> None:
        assert self._task is None, "server already started"
        self._stopping = False
        self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        # A serve-loop crash (engine error, invariant violation, bug) must
        # FAIL every waiting client promptly: the task dying silently
        # would leave each `await stream.drain()` / `server.drain()`
        # hanging on tokens that will never arrive.
        try:
            await self._run_inner()
        except BaseException as e:
            for stream in list(self._live.values()):
                stream._abort(e)
            raise

    async def _run_inner(self) -> None:
        cfg = self.cfg
        while True:
            now = self.clock()
            self._sweep(now)
            self._maybe_shed(now)
            if now - self._last_tick >= cfg.tick_interval_s:
                self._last_tick = now
                self.controller.tick(now)
            busy = False
            for idx, (inst, agent) in enumerate(
                    zip(self.controller.instances, self.agents)):
                if not self.controller.is_alive(idx):
                    continue
                inst.current_model = agent.engine.model_name
                try:
                    # qlint: disable=blocking-in-async -- the loop owns the engines: cancel/evict/shed paths run between awaits and must never overlap an engine round, so the round runs inline (single host thread; offloading would race them)
                    agent.run_iteration()
                except EngineFailure as e:
                    # supervision: crashes kill the instance (its requests
                    # are redelivered from the global queue), transient
                    # errors strike it.  Anything else — a real bug, an
                    # InvariantViolation — still propagates and aborts
                    # every stream (fail loudly, not around).
                    self.stats.engine_failures += 1
                    if self.controller.report_engine_failure(
                            idx, e, now, engine=agent.engine) == DEAD:
                        agent.reset()
                    continue
                self.controller.heartbeat(idx, now)
                busy |= agent.engine.num_active() > 0
            self._pump_tokens()
            self.stats.iterations += 1
            if self._stopping and not self._live:
                break
            # an un-finished live stream means queued or running work; an
            # O(groups×requests) VQ walk here would rival the decode step
            busy |= bool(self._live)
            # the await is the scheduling point: submissions, cancellations
            # and stream consumers interleave here
            await asyncio.sleep(0.0 if busy else cfg.idle_sleep_s)

    async def drain(self) -> None:
        """Wait until every accepted request reached a terminal state."""
        while self._live:
            if self._task is not None and self._task.done():
                self._task.result()  # re-raises the serve loop's crash
                raise RuntimeError(
                    f"serve loop exited with {len(self._live)} live "
                    f"request(s)")
            await asyncio.sleep(0.001)

    async def stop(self, cancel_outstanding: bool = False) -> None:
        """Graceful shutdown: stop accepting, optionally cancel what's
        still in flight (otherwise wait for it to drain), stop the loop.
        Either way no KV block stays allocated to a dead request: cancel
        frees slots/snapshots, drain lets them finish."""
        self._stopping = True
        if cancel_outstanding:
            for stream in list(self._live.values()):
                stream.cancel()
        if self._task is not None:
            await self._task
            self._task = None


async def run_session(server: AsyncServer, session, *,
                      clock: Callable[[], float] = time.monotonic) -> list:
    """Drive a multi-turn ``data.workload.Session``: submit each turn,
    stream it to completion, fold prompt+output into the session history
    (the next turn's prompt prefix — the prefix index serves it from
    cache), think, repeat.  Returns the session's request list."""
    while True:
        req = session.next_request(clock())
        if req is None:
            return session.requests
        stream = await server.submit(req)
        await stream.drain()
        if stream.status != "completed":
            return session.requests  # rejected / expired / cancelled turn
        session.complete_turn(req)
        if session.think_time_s > 0:
            await asyncio.sleep(session.think_time_s)
