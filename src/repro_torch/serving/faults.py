"""Seeded, deterministic fault injection for the serving stack (QLM §4:
the global queue is the durable request store that makes engine failure
survivable — this module is the harness that tests the claim).

``FaultPlan`` is a replayable schedule of faults.  Determinism comes from
counting, not clocks: every fault site keys on a per-(engine, site)
**occurrence counter** (the Nth decode round of engine 1, the 2nd model
swap of engine 0, ...), and probabilistic specs draw from a per-spec
``random.Random`` seeded from the plan seed — so the same seed against
the same request schedule produces the identical fault timeline, and a
chaos failure reproduces from its seed alone.

``FaultyEngine`` wraps a ``ContinuousBatchingEngine`` by composition
(attribute access delegates both ways, so ``QLMAgent`` binding
``engine.pull_source`` through the wrapper reaches the real engine).  It
interposes on the fault sites:

  * ``decode`` / ``prefill`` — fired at a ``step()``/``steps()`` round
    boundary while decode-ready / mid-prefill slots are resident, i.e.
    the crash lands with live KV allocations and in-flight requests;
  * ``swap`` — fired on ``swap_model`` entry;
  * ``materialize`` — fired when the engine promotes pinned snapshots
    (``_materialize_pinned_snapshots``), the gated pool-reset path;
  * ``round`` — any round boundary; used for delay injection (slow-node
    emulation) independent of slot state.

Fault kinds: ``crash`` marks the engine dead and raises
``EngineCrashed`` — every later call raises ``EngineDead`` (a crashed
host does not come back); ``error`` raises ``TransientEngineError``
without killing the engine (the supervision layer's strike counter
decides); ``delay`` stalls this engine's rounds for ``delay_s`` on the
engine's injected clock (degraded, not failed — no ``time.sleep``, so a
virtual-clock driver keeps advancing and sibling engines keep serving);
``hang``
wedges the engine WITHOUT raising — every later round consumes its
quantum and makes zero progress (no tokens, no completions, no
exception), which is invisible to success-only heartbeats and exactly
what the controller's round watchdog
(``QLMConfig.hang_grace_rounds``) exists to catch.

The supervision consumer is ``QLMController.report_engine_failure`` +
``mark_dead`` (``core/qlm.py``); the chaos driver is
``launch/chaos.py``.  See ``docs/fault_tolerance.md``.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, Dict, List, Optional, Tuple

FAULT_SITES = ("decode", "prefill", "swap", "materialize", "round")
FAULT_KINDS = ("crash", "error", "delay", "hang")


class EngineFailure(RuntimeError):
    """Base of every injected / detected engine failure.  ``fatal`` tells
    the supervision layer whether the engine is gone (crash) or merely
    misbehaving (transient error -> strike counter)."""
    fatal = False


class EngineCrashed(EngineFailure):
    """The engine died mid-operation: resident slots, KV pool, and any
    host snapshots pinned in its pool are lost with it."""
    fatal = True


class EngineDead(EngineFailure):
    """An operation reached an engine that already crashed (the caller
    missed or ignored the death notice)."""
    fatal = True


class TransientEngineError(EngineFailure):
    """A recoverable per-round failure (spurious device error, timeout):
    the round produced nothing, but the engine state is intact."""
    fatal = False


@dataclasses.dataclass
class FaultSpec:
    """One fault rule.  ``at_count`` schedules it at the Nth occurrence
    (1-based) of ``site`` on ``engine`` (``None`` = any engine);
    ``prob`` makes it probabilistic per occurrence instead.  A spec fires
    at most ``max_fires`` times."""
    site: str
    kind: str = "crash"
    engine: Optional[int] = None
    at_count: Optional[int] = None
    prob: float = 0.0
    delay_s: float = 0.0
    max_fires: int = 1

    def __post_init__(self) -> None:
        if self.site not in FAULT_SITES:
            raise ValueError(f"site must be one of {FAULT_SITES}, "
                             f"got {self.site!r}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if self.at_count is None and self.prob <= 0.0:
            raise ValueError("spec needs at_count or prob > 0")


class FaultPlan:
    """A replayable fault schedule: ask ``fire(engine_id, site)`` at every
    fault site; it returns the matching ``FaultSpec`` (or ``None``) and
    records the decision in ``events`` — the fault timeline."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._counts: Dict[Tuple[int, str], int] = {}
        self._fires: Dict[int, int] = {}
        # one RNG per spec: firing (or not) of one probabilistic spec must
        # not shift another spec's draw sequence
        self._rngs = [random.Random((seed << 8) ^ i)
                      for i in range(len(self.specs))]
        self.events: List[Dict[str, Any]] = []

    def fresh(self) -> "FaultPlan":
        """A reset copy (same specs, same seed) for replaying the run."""
        return FaultPlan(list(self.specs), self.seed)

    def occurrences(self, engine_id: int, site: str) -> int:
        return self._counts.get((engine_id, site), 0)

    def fire(self, engine_id: int, site: str) -> Optional[FaultSpec]:
        n = self._counts.get((engine_id, site), 0) + 1
        self._counts[(engine_id, site)] = n
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if spec.engine is not None and spec.engine != engine_id:
                continue
            if self._fires.get(i, 0) >= spec.max_fires:
                continue
            hit = (n == spec.at_count) if spec.at_count is not None \
                else (self._rngs[i].random() < spec.prob)
            if not hit:
                continue
            self._fires[i] = self._fires.get(i, 0) + 1
            self.events.append({
                "seq": len(self.events), "engine": engine_id, "site": site,
                "kind": spec.kind, "occurrence": n, "spec": i,
            })
            return spec
        return None

    def timeline(self) -> List[Dict[str, Any]]:
        return list(self.events)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "specs": [dataclasses.asdict(s) for s in self.specs],
            "events": self.events,
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """Rebuild a FRESH plan (counters zeroed) from a ``to_json``
        artifact, so a CI chaos timeline replays locally verbatim.  The
        recorded ``events`` are intentionally dropped: determinism means
        re-running the specs from the seed regenerates them."""
        data = json.loads(text)
        spec_fields = {f.name for f in dataclasses.fields(FaultSpec)}
        specs = [FaultSpec(**{k: v for k, v in s.items() if k in spec_fields})
                 for s in data.get("specs", [])]
        return cls(specs, seed=int(data.get("seed", 0)))


# Fields the wrapper keeps for itself; everything else delegates to the
# wrapped engine (both get and set — the agent assigns
# ``engine.pull_source`` through the wrapper).
_OWN_FIELDS = ("_engine", "_plan", "engine_id", "dead", "hung",
               "stalled_until", "_inner_materialize")


class FaultyEngine:
    """Fault-injecting proxy around a ``ContinuousBatchingEngine``.

    Pure composition — no engine methods are inherited, so the static
    lint's hot-path anchors stay on the real engine class and the
    invariant hooks (which patch ``ContinuousBatchingEngine`` methods)
    keep firing on the delegated calls.
    """

    def __init__(self, engine: Any, plan: FaultPlan, engine_id: int):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_plan", plan)
        object.__setattr__(self, "engine_id", engine_id)
        object.__setattr__(self, "dead", False)
        object.__setattr__(self, "hung", False)
        # delay faults stall rounds until this point on the ENGINE's
        # injected clock — never a raw time.sleep, which under the chaos
        # soak's shared virtual clock would block the whole round-robin
        # loop (every engine) without ever advancing the simulated
        # schedule.  Clock-gated, only this engine's rounds go empty;
        # under a threaded wall-clock loop only this agent thread idles.
        object.__setattr__(self, "stalled_until", 0.0)
        # the materialize site lives INSIDE engine paths (swap_model, the
        # admit pool-pressure valve), so it is hooked on the instance
        object.__setattr__(self, "_inner_materialize",
                           engine._materialize_pinned_snapshots)
        engine._materialize_pinned_snapshots = self._materialize_hook

    # -- delegation --------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_engine"), name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name in _OWN_FIELDS:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_engine"), name, value)

    # -- fault application -------------------------------------------------
    def _apply(self, spec: FaultSpec, site: str) -> None:
        n = self._plan.occurrences(self.engine_id, site)
        if spec.kind == "delay":
            # degraded, not failed: rounds return empty until the
            # engine's own clock passes the stall deadline (see
            # ``stalled_until`` in __init__ for why not time.sleep)
            now = self._engine.clock()
            until = max(self.stalled_until, now) + spec.delay_s
            self.stalled_until = until
            return
        if spec.kind == "hang":
            # the wedge: no exception, no progress — rounds from here on
            # consume their quantum and return nothing, so success-only
            # heartbeats keep firing while the engine strands its work
            self.hung = True
            return
        if spec.kind == "crash":
            self.dead = True
            raise EngineCrashed(
                f"engine {self.engine_id} crashed at {site} "
                f"(occurrence {n})")
        raise TransientEngineError(
            f"engine {self.engine_id} transient error at {site} "
            f"(occurrence {n})")

    def _check(self, site: str) -> None:
        spec = self._plan.fire(self.engine_id, site)
        if spec is not None:
            self._apply(spec, site)

    def _pre_round(self) -> bool:
        """Fault-site gate at a round boundary.  Returns True when the
        round must stall (hung engine): the caller returns an empty
        round instead of dispatching.  Once hung, occurrence counters
        freeze too — a wedged engine stops reaching its fault sites,
        which keeps the timeline replayable."""
        if self.dead:
            raise EngineDead(f"engine {self.engine_id} is dead")
        if self.hung:
            return True
        if self.stalled_until and self._engine.clock() < self.stalled_until:
            # mid-delay: this engine's round goes empty; counters freeze
            # (like hang) so the fault timeline stays clock-independent
            return True
        self._check("round")
        eng = self._engine
        if eng.prefilling_slots():
            self._check("prefill")
        elif eng.decode_slots():
            self._check("decode")
        return self.hung

    def _materialize_hook(self) -> None:
        if self.dead:
            raise EngineDead(f"engine {self.engine_id} is dead")
        self._check("materialize")
        self._inner_materialize()

    # -- interposed engine surface ----------------------------------------
    def step(self):
        if self._pre_round():
            return []
        return self._engine.step()

    def steps(self, k: Optional[int] = None):
        if self._pre_round():
            return []
        return self._engine.steps(k)

    def swap_model(self, model, params, model_name: str):
        if self.dead:
            raise EngineDead(f"engine {self.engine_id} is dead")
        if self.hung:
            return []   # a wedged engine executes nothing, swaps included
        self._check("swap")
        return self._engine.swap_model(model, params, model_name)

    def cancel_request(self, req) -> bool:
        # a dead engine holds nothing cancellable: its state died with it
        # (the supervision layer's abandon() reclaimed the accounting)
        if self.dead:
            return False
        return self._engine.cancel_request(req)
