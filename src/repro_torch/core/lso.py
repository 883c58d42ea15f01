"""QLM agent: translates virtual-queue order into LSO actions (paper §5).

One agent per LLM serving instance.  The agent is a pure actuator — all
intelligence lives in the global scheduler's VQ ordering:

  * Request pulling  — engine.pull_source bound to the VQ head group (FCFS
    within the group);
  * Request eviction — when the head group changes, running requests from
    other groups are evicted (KV snapshotted to host) to un-block HOL;
  * Model swapping   — when the head group's model differs from the loaded
    one, flush + swap;
  * Load balancing   — implicit: each instance only pulls from its own VQ.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

from repro_torch import tracing
from repro_torch.core.request import Request
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.serving.engine import ContinuousBatchingEngine


class QLMAgent:
    def __init__(self, engine: ContinuousBatchingEngine, vq: VirtualQueue,
                 model_registry: Dict[str, Tuple[object, object]],
                 *, enable_eviction: bool = True, enable_swap: bool = True):
        """model_registry: name -> (Model, params)."""
        self.engine = engine
        self.vq = vq
        self.registry = model_registry
        self.enable_eviction = enable_eviction
        self.enable_swap = enable_swap
        self._last_head = None  # eviction fires on head-group CHANGE (§5)
        # Queue-layer guard for threaded serving: the cluster runtime
        # binds this to ``QLMController.lock`` so ``_pull`` (fired
        # mid-round via ``engine.pull_source``) and ``sync`` serialize
        # against ticks / submits / mark_dead.  Lock order is
        # engine.lock -> queue_lock (run_iteration holds the engine lock
        # around the whole quantum); the controller side never blocks on
        # engine locks, so the cross order cannot deadlock.  Default is
        # a no-op for single-threaded drivers.
        self.queue_lock: contextlib.AbstractContextManager = \
            contextlib.nullcontext()
        engine.pull_source = self._pull

    # -- request pulling LSO ------------------------------------------------
    @tracing.spanned("agent.pull",
                     req=lambda r: None if r is None else r.req_id)
    def _pull(self) -> Optional[Request]:
        with self.queue_lock:
            pushed = self.engine.take_pushback()
            if pushed is not None:
                pushed._in_flight = False
                pushed._served_by = None
            # clock-gated: redelivered requests in exponential backoff
            # (not_before) are skipped until their window opens
            req = self.vq.next_request(self.engine.model_name,
                                       now=self.engine.clock())
            if req is None:
                return None
            req._in_flight = True
            # tag the serving instance: on engine death the supervisor
            # sweeps the global queue for _served_by == this VQ's instance
            req._served_by = self.vq.instance_id
            return req

    # -- eviction + swap LSOs -------------------------------------------------
    @tracing.spanned("agent.sync")
    def sync(self) -> None:
        """Reconcile engine state with the (possibly re-ordered) VQ."""
        with self.queue_lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        head = self.vq.head_group()
        if head is None:
            return
        # model swapping: head group's model must be resident
        if self.enable_swap and head.model != self.engine.model_name:
            model, params = self.registry[head.model]
            evicted = self.engine.swap_model(model, params, head.model)
            for r in evicted:
                r._in_flight = False
                r._served_by = None
            # the swap rebuilt engine state: forget the cached head so the
            # head-change eviction LSO re-evaluates on the next sync
            self._last_head = None
        # request eviction: fires when the global scheduler moved a NEW
        # group to the head (§5) and its requests are blocked by other
        # groups' running requests (HOL un-blocking)
        head_changed = head.group_id != self._last_head
        self._last_head = head.group_id
        if self.enable_eviction and head_changed:
            head_pending = [r for r in head.pending()
                            if not getattr(r, "_in_flight", False)]
            if head_pending and not any(
                    self.engine.can_admit(r) for r in head_pending):
                for slot in list(self.engine.active_slots()):
                    running = self.engine.slots[slot]
                    if running is not None and running.group_id != head.group_id:
                        r = self.engine.evict_slot(slot)
                        r._in_flight = False
                        r._served_by = None
                        if self.engine.can_admit(head_pending[0]):
                            break

    def reset(self) -> None:
        """Failure-path reset (engine crash / recovery / external engine
        reset): forget the cached VQ head — the first post-recovery
        ``sync()`` must re-evaluate the head-change eviction LSO instead
        of assuming continuity with pre-failure state — and drain any
        pushback limbo so no request strands with ``_in_flight=True``."""
        self._last_head = None
        with self.queue_lock:
            pushed = self.engine.take_pushback()
            if pushed is not None:
                pushed._in_flight = False
                pushed._served_by = None

    def run_iteration(self):
        """sync + one engine iteration (the serve loop quantum).  Engines
        configured with ``decode_burst > 1`` fuse up to that many decode
        iterations into the dispatch (``steps()`` falls back to ``step()``
        at burst 1, and to single-step whenever a slot is mid-prefill)).

        The whole quantum runs under the engine's round lock: the
        controller's cross-thread LSO touches (migration materialize,
        drain eviction, dead-engine salvage) are excluded from the
        middle of a dispatch, and because those sites only try-lock,
        holding it for the full quantum is deadlock-free."""
        lock = getattr(self.engine, "lock", None)
        with lock if lock is not None else contextlib.nullcontext():
            self.sync()
            return self.engine.steps()
