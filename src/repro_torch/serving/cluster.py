"""True-concurrency cluster serve loop: one thread per QLM agent/engine.

The round-robin drivers (``launch/chaos.py``, ``launch/serve.py``) share
one virtual clock and interleave engine rounds on a single thread, so no
cross-engine overlap is ever real.  ``ThreadedCluster`` runs each
``QLMAgent`` on its own thread against REAL wall-clock rounds — three
heterogeneous engines decode simultaneously, a model swap on one
instance overlaps its siblings' decodes — with the controller's tick
loop (watchdog, heartbeats, drain completion, migration sweep,
violation reschedule) on a dedicated supervisor thread.

Locking discipline (see also ``core/qlm.py`` and ``core/lso.py``):

  * ``QLMController.lock`` (RLock) serializes the whole queue layer —
    every controller entry point takes it, and each agent's
    ``queue_lock`` is bound to it here so VQ pulls / head sync
    serialize against ticks, submits, and recovery.
  * ``engine.lock`` (RLock, per engine) covers one engine's internals.
    The agent thread holds it for the full round quantum
    (``QLMAgent.run_iteration``); the controller side only ever
    try-locks / bounded-locks it (``qlm._engine_guard``), so the
    engine->controller acquisition order of agent threads cannot
    deadlock against the controller's controller->engine touches.
  * Agent-thread-only calls: ``engine.step/steps``, ``agent.sync``,
    ``agent._pull``.  Controller-thread calls reach engines only
    through the guarded LSO sites (migration materialize, drain
    eviction, dead-engine salvage).

Failure handling matches the round-robin driver: an ``EngineFailure``
raised by a round is reported to the controller (supervision decides
dead vs degraded), the agent resets, and the thread parks while its
instance is departed — ``replace(idx, engine, agent)`` installs fresh
capacity in the slot and the parked thread resumes on it.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from repro_torch.serving.faults import EngineFailure


class ThreadedCluster:
    """Thread-per-engine serve loop over a ``QLMController``.

    Drivers submit through ``controller.submit`` (thread-safe) while the
    cluster runs; ``wait`` blocks until a predicate holds or a wall
    timeout expires; ``stop`` joins every thread.  Engines keep their
    injected lifecycle clock (wall by default) — rounds themselves are
    real wall-clock either way.
    """

    def __init__(self, controller, agents: List, engines: List, *,
                 clock: Callable[[], float] = time.monotonic,
                 tick_interval: float = 0.02,
                 idle_sleep: float = 0.002):
        self.controller = controller
        self.agents = list(agents)
        self.engines = list(engines)
        self.clock = clock
        self.tick_interval = tick_interval
        self.idle_sleep = idle_sleep
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._tick_thread: Optional[threading.Thread] = None
        self.rounds = [0] * len(self.agents)
        self.failures = [0] * len(self.agents)
        self.ticks = 0
        # crash-isolation: an exception that is NOT an EngineFailure is a
        # bug in the stack, not an injected fault — it must surface to
        # the driver, not die silently with the thread
        self.errors: List[BaseException] = []
        # optional per-round callback ``hook(idx)`` invoked from agent
        # idx's OWN thread between rounds (engine lock free there).
        # Drivers use it for round-granular lifecycle triggers — e.g.
        # chaos drains an instance at the exact round its target holds
        # co-resident sharers, which a polling loop would miss.
        self.round_hook: Optional[Callable[[int], None]] = None
        for agent in self.agents:
            agent.queue_lock = controller.lock

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ThreadedCluster":
        if self._threads:
            raise RuntimeError("cluster already started")
        self._stop.clear()
        for idx in range(len(self.agents)):
            t = threading.Thread(target=self._agent_loop, args=(idx,),
                                 name=f"qlm-agent-{idx}", daemon=True)
            self._threads.append(t)
            t.start()
        self._tick_thread = threading.Thread(target=self._tick_loop,
                                             name="qlm-controller",
                                             daemon=True)
        self._tick_thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        deadline = time.monotonic() + timeout
        for t in self._threads + ([self._tick_thread]
                                  if self._tick_thread else []):
            t.join(max(0.0, deadline - time.monotonic()))
        alive = [t.name for t in self._threads if t.is_alive()]
        self._threads = []
        self._tick_thread = None
        if alive:
            raise RuntimeError(f"cluster threads failed to join: {alive}")
        if self.errors:
            raise self.errors[0]

    def wait(self, predicate: Callable[[], bool],
             timeout: float = 60.0, poll: float = 0.01) -> bool:
        """Block until ``predicate()`` (called under the controller lock)
        holds, the cluster errors out, or ``timeout`` wall-seconds pass.
        Returns whether the predicate held."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.errors:
                return False
            with self.controller.lock:
                if predicate():
                    return True
            time.sleep(poll)
        return False

    def replace(self, idx: int, engine, agent, now: Optional[float] = None,
                hw_by_model=None, model_name=None) -> None:
        """Install fresh capacity in a departed slot: controller-side
        ``replace_instance`` plus swapping the runtime's agent/engine so
        the parked thread picks the new pair up on its next check."""
        now = self.clock() if now is None else now
        agent.queue_lock = self.controller.lock
        with self.controller.lock:
            self.controller.replace_instance(idx, engine, now,
                                             hw_by_model=hw_by_model,
                                             model_name=model_name)
            self.engines[idx] = engine
            self.agents[idx] = agent

    # -- thread bodies -----------------------------------------------------
    def _agent_loop(self, idx: int) -> None:
        ctl = self.controller
        while not self._stop.is_set():
            if not ctl.is_alive(idx):
                # departed slot: park cheaply until replaced or stopped
                self._stop.wait(self.idle_sleep * 10)
                continue
            agent = self.agents[idx]
            try:
                agent.run_iteration()
            except EngineFailure as e:
                self.failures[idx] += 1
                ctl.report_engine_failure(idx, e, self.clock(),
                                          engine=agent.engine)
                agent.reset()
                continue
            except BaseException as e:  # noqa: BLE001 — surfaced via stop()
                self.errors.append(e)
                return
            with ctl.lock:
                # swap/drain estimates read instances[].current_model; the
                # round-robin drivers refresh it every round, threaded
                # agents must too (a live swap lands mid-traffic here)
                ctl.instances[idx].current_model = agent.engine.model_name
                ctl.heartbeat(idx, self.clock())
            self.rounds[idx] += 1
            hook = self.round_hook
            if hook is not None:
                try:
                    hook(idx)
                except BaseException as e:  # noqa: BLE001 — surfaced via stop()
                    self.errors.append(e)
                    return
            if self._idle(idx, agent):
                time.sleep(self.idle_sleep)

    def _idle(self, idx: int, agent) -> bool:
        """No residents and nothing pullable: back off instead of
        spinning.  The VQ read takes the controller lock (group lists
        mutate under it); the engine check is agent-thread-local."""
        try:
            if agent.engine.num_active() > 0:
                return False
        except EngineFailure:
            return True
        with self.controller.lock:
            return agent.vq.pending_requests() == 0

    def _tick_loop(self) -> None:
        ctl = self.controller
        while not self._stop.is_set():
            try:
                ctl.tick(self.clock())
            except BaseException as e:  # noqa: BLE001 — surfaced via stop()
                self.errors.append(e)
                return
            self.ticks += 1
            self._stop.wait(self.tick_interval)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "rounds": list(self.rounds),
            "failures": list(self.failures),
            "ticks": self.ticks,
            "errors": [repr(e) for e in self.errors],
        }
