"""Runtime invariant checker for the serving stack.

The static pass (``repro.analysis.lint``) enforces *conventions* the hot
path depends on; this module checks the *state machines* those
conventions protect, at the only moments they are supposed to be
consistent: engine round boundaries (``step()`` / ``steps()`` return) and
controller ticks.  Every check raises ``InvariantViolation`` with an
actionable message naming the block / sequence / group involved.

Checked invariants
------------------
``check_block_manager`` (BlockManager, after any allocation-state-machine
transition):

  * **conservation** — every physical block is in exactly one of
    {free list, freed-but-cached, live (refcount >= 1)}, and the three
    partitions sum to ``num_blocks``;
  * **refcount accounting** — ``ref[b] ==`` (number of sequence block
    tables containing ``b``) + snapshot pins on ``b``;
  * **no-freed-while-referenced** — free/cached blocks have refcount 0
    and appear in no block table and hold no pins;
  * **prefix-index <-> block bijection** — ``_index`` and ``_block_key``
    are exact inverses, indexed chains are rooted (parent indexed or
    ``-1``), and indexed blocks are live or cached;
  * **pin lifecycle** — pins are positive and never exceed the block's
    refcount (each pin is one unit of refcount);
  * **allocation arithmetic** — ``len(block_table) ==
    blocks_needed(num_tokens)`` for every live sequence, no duplicate
    blocks within a table;
  * **incremental slot table** — every bound row mirrors its sequence's
    block table exactly (sentinel-padded), unbound rows are all-sentinel,
    no two sequences share a row.

``check_engine`` (engine, at round boundaries only — mid-round the
per-slot counters are legitimately in motion):

  * block-manager checks above, plus:
  * every active slot's request has a live allocation bound to that slot
    row; no request occupies two slots;
  * empty slots have zero length / prefill position;
  * decode-ready slots hold exactly ``lengths + 1`` KV tokens (the next
    decode step's write slot is always reserved — the contract
    ``_plan_burst`` and ``append_token`` maintain);
  * mid-prefill slots have ``lengths == prefill_pos`` and an allocation
    covering at least the prefilled run;
  * the incremental slot table equals a from-scratch
    ``_block_table_array()`` rebuild.

``check_queue_layer`` (QLMController, at ticks):

  * **no stranded groups** — every not-done group is reachable from
    exactly one virtual queue, and every not-done group sitting in a VQ
    is known to the controller;
  * **single ownership** — every non-terminal queued request belongs to
    exactly one group;
  * **group homogeneity** — members match the group's model, carry its
    ``group_id``, and the group SLO is the member minimum (the
    conservative deadline the RWT walk schedules against);
  * **dead instances hold nothing** — a DEAD instance's virtual queue is
    empty (``mark_dead`` empties it; the scheduler must never re-place
    onto it).

``check_terminal_states`` (QLMController, at ticks — the fault-tolerance
conservation law):

  * every tracked request is in exactly one of {queued-in-placed-group,
    engine-resident, finished, rejected, failed-quarantined};
  * a waiting (non-terminal, not in-flight) request belongs to a group
    reachable from an alive virtual queue — engine death redelivers or
    quarantines, it never silently strands work;
  * with engine handles attached, an in-flight request is resident in an
    ALIVE engine (slot or pushback) — no ``_in_flight=True`` limbo.

Enabling
--------
``QLINT_INVARIANTS=1`` (env) or ``EngineConfig.debug_invariants=True`` /
``QLMConfig.debug_invariants=True``.  ``QLINT_INVARIANTS_SAMPLE=N``
checks every Nth round instead of all of them (cheap sampled mode for
benches; default 1 = every round).  ``tests/conftest.py`` honors the env
var by wrapping the engine round loop and every BlockManager transition,
so the whole tier-1 suite doubles as an invariant suite.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np


class InvariantViolation(AssertionError):
    """A serving-stack invariant does not hold.  The message names the
    block / sequence / slot / group involved and the check that failed."""


def invariants_enabled() -> bool:
    return os.environ.get("QLINT_INVARIANTS", "").strip().lower() \
        not in ("", "0", "false", "off", "no")


def sample_every() -> int:
    """Check every Nth round (QLINT_INVARIANTS_SAMPLE, default 1)."""
    try:
        return max(1, int(os.environ.get("QLINT_INVARIANTS_SAMPLE", "1")))
    except ValueError:
        return 1


class InvariantSampler:
    """Counter-based sampling: ``due()`` is True every Nth call.

    Thread-safe: one sampler is shared by every hooked BlockManager
    mutator and engine round across the threaded cluster's agent
    threads, and a racy ``+=`` would silently drift the sampling period
    (or double-fire the due slot)."""

    def __init__(self, every: Optional[int] = None):
        self.every = sample_every() if every is None else max(1, every)
        self._n = 0
        self._lock = threading.Lock()

    def due(self) -> bool:
        with self._lock:
            self._n += 1
            return self._n % self.every == 0


def _fail(where: str, msg: str) -> None:
    raise InvariantViolation(f"[{where}] {msg}")


# ---------------------------------------------------------------------------
# BlockManager
# ---------------------------------------------------------------------------
def check_block_manager(bm: Any, *, where: str = "block-manager") -> None:
    n = bm.num_blocks
    free = list(bm._free)
    cached = list(bm._cached)
    ref = bm._ref
    pins: Dict[int, int] = bm._pins

    # ownership map: block -> sequence ids whose table contains it
    owners: Dict[int, List[int]] = {}
    for sid, alloc in bm._seqs.items():
        seen = set()
        for b in alloc.block_table:
            if b in seen:
                _fail(where, f"seq {sid} lists block {b} twice in its "
                             f"block table {alloc.block_table}")
            seen.add(b)
            owners.setdefault(b, []).append(sid)

    # conservation: free / cached / live partition the pool exactly
    free_set, cached_set = set(free), set(cached)
    if len(free_set) != len(free):
        dupes = sorted(b for b in free_set if free.count(b) > 1)
        _fail(where, f"free list contains duplicates: {dupes}")
    if free_set & cached_set:
        _fail(where, f"blocks both free and cached: "
                     f"{sorted(free_set & cached_set)}")
    # no-freed-while-referenced (checked before the conservation count so a
    # double-free names the block and its owner instead of a bare tally)
    for b in free + cached:
        if b in owners:
            _fail(where, f"block {b} was freed while still referenced by "
                         f"seq(s) {owners[b]}")
        if int(ref[b]) != 0:
            _fail(where, f"block {b} is on the "
                         f"{'cached' if b in cached_set else 'free'} list "
                         f"but has refcount {int(ref[b])}")
        if pins.get(b):
            _fail(where, f"block {b} was freed while still pinned "
                         f"({pins[b]} snapshot pin(s))")

    live = [b for b in range(n) if int(ref[b]) >= 1]
    if len(free) + len(cached) + len(live) != n:
        lost = sorted(set(range(n)) - free_set - cached_set - set(live))
        detail = str(lost) if lost else "by double-count"
        _fail(where,
              f"block conservation broken: free={len(free)} + "
              f"cached={len(cached)} + live={len(live)} != "
              f"num_blocks={n} (leaked/overlapping blocks: {detail})")

    # refcount accounting: ref == table occurrences + pins
    for b in range(n):
        expect = len(owners.get(b, ())) + pins.get(b, 0)
        if int(ref[b]) != expect:
            _fail(where,
                  f"block {b}: refcount {int(ref[b])} != "
                  f"{len(owners.get(b, ()))} table reference(s) "
                  f"(seqs {owners.get(b, [])}) + {pins.get(b, 0)} pin(s)")

    # pin lifecycle
    for b, p in pins.items():
        if p <= 0:
            _fail(where, f"block {b} has non-positive pin count {p}")
        if int(ref[b]) < p:
            _fail(where, f"block {b}: {p} pin(s) exceed refcount "
                         f"{int(ref[b])}")

    # prefix index <-> block bijection
    for key, b in bm._index.items():
        if bm._block_key.get(b) != key:
            _fail(where,
                  f"prefix index names block {b} for key {key!r} but the "
                  f"block maps back to {bm._block_key.get(b)!r}")
        parent = key[0]
        if parent != -1 and parent not in bm._block_key:
            _fail(where, f"indexed block {b} chains through parent "
                         f"{parent} which is not indexed (orphaned chain)")
        if int(ref[b]) == 0 and b not in cached_set:
            _fail(where, f"indexed block {b} is neither live nor cached")
    for b, key in bm._block_key.items():
        if bm._index.get(key) != b:
            _fail(where, f"block {b} claims prefix key {key!r} but the "
                         f"index maps it to {bm._index.get(key)}")
    for b in cached:
        if b not in bm._block_key:
            _fail(where, f"cached block {b} is not in the prefix index "
                         f"(cache_freed keeps only indexed blocks)")

    # allocation arithmetic
    for sid, alloc in bm._seqs.items():
        need = bm.blocks_needed(alloc.num_tokens)
        if len(alloc.block_table) != need:
            _fail(where,
                  f"seq {sid}: {len(alloc.block_table)} block(s) allocated "
                  f"but {alloc.num_tokens} token(s) need {need}")

    # pending COW destinations must be live (the engine has not yet copied
    # the page contents; a freed dst would hand the page to a new owner
    # before the copy lands)
    for src, dst in bm._cow_ops:
        if int(ref[dst]) < 1:
            _fail(where, f"pending COW op ({src} -> {dst}) targets a freed "
                         f"destination block")

    # incremental slot table mirrors the per-seq tables
    table = bm._table
    if table is not None:
        sentinel = n
        row_owner: Dict[int, int] = {}
        for sid, row in bm._seq_rows.items():
            if sid not in bm._seqs:
                _fail(where, f"slot table row {row} bound to unknown seq "
                             f"{sid}")
            if row in row_owner:
                _fail(where, f"slot table row {row} bound to both seq "
                             f"{row_owner[row]} and seq {sid}")
            row_owner[row] = sid
            bt = bm._seqs[sid].block_table
            got = [int(x) for x in table[row, :len(bt)]]
            if got != bt:
                _fail(where,
                      f"slot table row {row} desynced for seq {sid}: "
                      f"table={got} vs block_table={bt}")
            if not (table[row, len(bt):] == sentinel).all():
                _fail(where,
                      f"slot table row {row} (seq {sid}) has stale entries "
                      f"past the allocation: {table[row, len(bt):]}")
        for row in range(table.shape[0]):
            if row not in row_owner and not (table[row] == sentinel).all():
                _fail(where,
                      f"unbound slot table row {row} is not all-sentinel: "
                      f"{table[row]}")


# ---------------------------------------------------------------------------
# Engine (round boundaries)
# ---------------------------------------------------------------------------
def check_engine(engine: Any, *, where: str = "engine") -> None:
    bm = engine.block_mgr
    check_block_manager(bm, where=f"{where}/block-manager")

    seen_req: Dict[int, int] = {}
    for i, req in enumerate(engine.slots):
        if req is None:
            if int(engine.lengths[i]) != 0 or int(engine.prefill_pos[i]) != 0:
                _fail(where,
                      f"empty slot {i} has length {int(engine.lengths[i])} "
                      f"/ prefill_pos {int(engine.prefill_pos[i])}")
            continue
        if req.req_id in seen_req:
            _fail(where, f"request {req.req_id} occupies both slot "
                         f"{seen_req[req.req_id]} and slot {i}")
        seen_req[req.req_id] = i
        if not bm.has(req.req_id):
            _fail(where, f"slot {i} holds request {req.req_id} with no "
                         f"KV allocation")
        if bm._table is not None:
            row = bm._seq_rows.get(req.req_id)
            if row != i:
                _fail(where, f"request {req.req_id} sits in slot {i} but "
                             f"its slot-table row is {row}")
        length = int(engine.lengths[i])
        ppos = int(engine.prefill_pos[i])
        kv = bm.seq_tokens(req.req_id)
        if not 0 <= ppos <= req.prompt_len:
            _fail(where, f"slot {i} (req {req.req_id}): prefill_pos {ppos} "
                         f"outside [0, prompt_len={req.prompt_len}]")
        if ppos >= req.prompt_len:
            # decode-ready: the next decode step's KV slot is reserved
            if kv != length + 1:
                _fail(where,
                      f"slot {i} (req {req.req_id}) decode-ready with "
                      f"{kv} KV token(s) allocated but length {length} "
                      f"(expected length + 1 = {length + 1}: the next "
                      f"write slot must be reserved)")
        else:
            if length != ppos:
                _fail(where,
                      f"slot {i} (req {req.req_id}) mid-prefill with "
                      f"length {length} != prefill_pos {ppos}")
            if not ppos <= kv <= req.prompt_len + 1:
                _fail(where,
                      f"slot {i} (req {req.req_id}) mid-prefill at "
                      f"{ppos}/{req.prompt_len} but allocation covers "
                      f"{kv} token(s)")

    # incremental slot table == from-scratch rebuild (the reference path)
    if getattr(engine.cfg, "incremental_block_table", False) \
            and bm.slot_table() is not None:
        rebuilt = engine._block_table_array()
        incremental = bm.slot_table()
        if not np.array_equal(incremental, rebuilt):
            bad = [r for r in range(rebuilt.shape[0])
                   if not (incremental[r] == rebuilt[r]).all()]
            detail = "; ".join(
                f"row {r}: incremental={incremental[r].tolist()} vs "
                f"rebuild={rebuilt[r].tolist()}" for r in bad[:4])
            _fail(where,
                  f"incremental slot table diverged from from-scratch "
                  f"rebuild on row(s) {bad}: {detail}")


# ---------------------------------------------------------------------------
# Queue layer (controller ticks)
# ---------------------------------------------------------------------------
def _alive_flags(controller: Any) -> List[bool]:
    """Per-instance liveness; controllers without supervision (pre-fault-
    tolerance callers, stub controllers in tests) read as all-alive.
    DRAINING counts alive (its residents are still finishing); DEAD and
    DRAINED are departed."""
    n = len(controller.instances)
    health = getattr(controller, "health", None)
    if health is None:
        return [True] * n
    flags = [h.state not in ("dead", "drained") for h in health]
    # callers may grow controller.instances after construction (tests,
    # scale-up): unsupervised extras read as alive
    flags += [True] * (n - len(flags))
    return flags[:n]


def check_queue_layer(controller: Any, *, where: str = "queue-layer") -> None:
    # placement: group -> virtual queues that can reach it
    alive = _alive_flags(controller)
    placements: Dict[int, List[int]] = {}
    vq_groups: List[Any] = []
    for idx, inst in enumerate(controller.instances):
        vq = inst.virtual_queue
        if not alive[idx]:
            undone = [g for g in vq.groups if not g.done()]
            if undone:
                _fail(where,
                      f"departed (dead/drained) instance "
                      f"{vq.instance_id} still holds {len(undone)} "
                      f"group(s) {[g.group_id for g in undone]}: "
                      f"mark_dead/_finish_drains must empty the virtual "
                      f"queue and nothing may re-place onto a departed "
                      f"instance")
            continue
        for g in vq.groups:
            placements.setdefault(id(g), []).append(vq.instance_id)
            vq_groups.append(g)

    known = {id(g) for g in controller.groups}
    for g in controller.groups:
        if g.done():
            continue
        homes = placements.get(id(g), [])
        if not homes:
            _fail(where,
                  f"group {g.group_id} (model {g.model}, "
                  f"{g.num_pending()} pending) is stranded: reachable "
                  f"from no virtual queue")
        if len(homes) > 1:
            _fail(where,
                  f"group {g.group_id} (model {g.model}) is placed in "
                  f"{len(homes)} virtual queues: instances {homes}")
    for g in vq_groups:
        if not g.done() and id(g) not in known:
            _fail(where,
                  f"virtual queue holds group {g.group_id} "
                  f"(model {g.model}) unknown to the controller")

    # single ownership: every non-terminal queued request in exactly one
    # group (by identity — req_id labels alone can go stale on re-group)
    membership: Dict[int, List[int]] = {}
    for g in controller.groups:
        for r in g.requests:
            membership.setdefault(id(r), []).append(g.group_id)
    for r in controller.global_queue:
        if r.finished():
            continue
        owners = membership.get(id(r), [])
        if len(owners) != 1:
            _fail(where,
                  f"request {r.req_id} (model {r.model}, slo {r.slo}) is "
                  f"owned by {len(owners)} group(s) {owners}; every "
                  f"non-terminal request must be reachable from exactly "
                  f"one virtual queue")

    # group homogeneity + conservative SLO
    for g in controller.groups:
        for r in g.requests:
            if r.model != g.model:
                _fail(where,
                      f"group {g.group_id} (model {g.model}) contains "
                      f"request {r.req_id} for model {r.model}")
            if r.group_id != g.group_id:
                _fail(where,
                      f"request {r.req_id} in group {g.group_id} carries "
                      f"stale group_id {r.group_id}")
        if g.requests:
            mn = min(r.slo for r in g.requests)
            if g.slo != mn:
                _fail(where,
                      f"group {g.group_id} SLO {g.slo} != member minimum "
                      f"{mn} (the RWT walk would schedule against the "
                      f"wrong deadline)")


# ---------------------------------------------------------------------------
# Terminal-state conservation (fault tolerance: §4 "the global queue is
# the durable request store")
# ---------------------------------------------------------------------------
def check_terminal_states(controller: Any, engines: Optional[List[Any]] = None,
                          *, where: str = "terminal-states") -> None:
    """Every submitted request is in exactly one of
    {queued-in-placed-group, engine-resident, finished, rejected,
    failed-quarantined} at tick boundaries.

    ``engines`` (index-aligned with ``controller.instances``) enables the
    residency cross-check: an ``_in_flight`` request must actually sit in
    an ALIVE engine's slots or pushback — the state engine failure paths
    are most likely to strand.  Terminal requests are classified before
    ``_in_flight`` is consulted (the engine's finish path leaves the flag
    set on completed requests by design)."""
    alive = _alive_flags(controller)

    # group membership over not-done groups with an alive placement
    placed: Dict[int, bool] = {}
    for idx, inst in enumerate(controller.instances):
        if not alive[idx]:
            continue
        for g in inst.virtual_queue.groups:
            placed[id(g)] = True
    member_placed: Dict[int, List[int]] = {}
    for g in controller.groups:
        if g.done():
            continue
        for r in g.requests:
            if placed.get(id(g), False):
                member_placed.setdefault(id(r), []).append(g.group_id)

    # residency over alive engines (slots + pushback limbo)
    resident: Dict[int, str] = {}
    if engines is not None:
        for idx, eng in enumerate(engines):
            if eng is None or not alive[idx]:
                continue
            for slot, r in enumerate(eng.slots):
                if r is not None:
                    resident[id(r)] = f"engine {idx} slot {slot}"
            pushed = getattr(eng, "_pushback", None)
            if pushed is not None:
                resident[id(pushed)] = f"engine {idx} pushback"

    failed_ids = {id(r) for r in getattr(controller, "failed", ())}
    for r in controller.global_queue + controller.finished \
            + controller.rejected:
        rid = f"request {r.req_id} (model {r.model}, slo {r.slo})"
        terminal = [s for s, on in (("rejected", r.rejected),
                                    ("failed", getattr(r, "failed", False)),
                                    ("finished", r.finished())) if on]
        if terminal:
            # exactly-one is state-machine exactness, not double counting:
            # attainment already scores failed-first.  rejected+finished
            # is legal (rejections are stamped finished); failed+rejected
            # would double-classify.
            if r.rejected and getattr(r, "failed", False):
                _fail(where, f"{rid} is both rejected (never admitted) and "
                             f"failed-quarantined (admitted, then poisoned)")
            if not r.finished():
                _fail(where, f"{rid} is {terminal[0]} but has no "
                             f"completion_time: group cursors will never "
                             f"skip it (liveness leak)")
            if getattr(r, "failed", False) and id(r) not in failed_ids:
                _fail(where, f"{rid} is failed-quarantined but missing "
                             f"from controller.failed (stats desync)")
            continue
        if getattr(r, "_in_flight", False):
            if engines is not None and id(r) not in resident:
                _fail(where,
                      f"{rid} is marked _in_flight but resident in no "
                      f"alive engine (slot or pushback): a failure path "
                      f"returned it to the queue without clearing the "
                      f"flag, so no agent will ever pull it again")
            continue
        # waiting: must be reachable from exactly one alive virtual queue
        owners = member_placed.get(id(r), [])
        if len(owners) != 1:
            state = ("stranded: member of no group placed on an alive "
                     "instance" if not owners else
                     f"placed {len(owners)} times: groups {owners}")
            _fail(where, f"{rid} is waiting (non-terminal, not in flight) "
                         f"but {state} — engine death must redeliver or "
                         f"quarantine every in-flight request")


# ---------------------------------------------------------------------------
# Cross-engine snapshot migration (self-healing cluster lifecycle)
# ---------------------------------------------------------------------------
def check_migration(controller: Any, engines: Optional[List[Any]] = None,
                    *, where: str = "migration") -> None:
    """Migration-state conservation at tick boundaries:

    * a request is RESIDENT (slot or pushback) on at most one engine —
      a migrated request must not be running on both its source and its
      destination;
    * a resident request carries no live-pinned snapshot — once the
      destination's pages are live, the source's pins must have been
      released (transferred on same-engine resume, materialized away on
      migration), otherwise the source pool pins pages forever;
    * a QUEUED request's pinned snapshot must point at an ALIVE attached
      engine's current pool and epoch — pins into a departed or reset
      pool are dangling (mark_dead / migration_sweep must release them
      and restart the request).
    """
    alive = _alive_flags(controller)
    if engines is not None:
        homes: Dict[int, List[str]] = {}
        for idx, eng in enumerate(engines):
            if eng is None or idx >= len(alive) or not alive[idx]:
                continue
            for slot, r in enumerate(eng.slots):
                if r is not None:
                    homes.setdefault(id(r), []).append(
                        f"engine {idx} slot {slot}")
            pushed = getattr(eng, "_pushback", None)
            if pushed is not None:
                homes.setdefault(id(pushed), []).append(
                    f"engine {idx} pushback")
        by_id = {}
        for eng in engines:
            if eng is None:
                continue
            for r in list(eng.slots) + [getattr(eng, "_pushback", None)]:
                if r is not None:
                    by_id[id(r)] = r
        for rid, places in homes.items():
            if len(places) > 1:
                r = by_id[rid]
                _fail(where,
                      f"request {r.req_id} (model {r.model}) is resident "
                      f"in {len(places)} engines at once: {places} — a "
                      f"migrated request must run on exactly one engine")
            r = by_id[rid]
            snap = getattr(r, "snapshot", None)
            if isinstance(snap, dict) and snap.get("pinned"):
                _fail(where,
                      f"request {r.req_id} is resident ({places[0]}) but "
                      f"its snapshot still pins {len(snap['pinned'])} "
                      f"block(s) in a source pool: source pins must be "
                      f"released iff destination pages are live")

    # queued pinned snapshots must have a live owner pool + epoch
    pools = {}
    if engines is not None:
        for idx, eng in enumerate(engines):
            bm = getattr(eng, "block_mgr", None)
            if bm is not None:
                pools[id(bm)] = (idx, bm)
    for r in controller.global_queue:
        if r.finished() or getattr(r, "_in_flight", False):
            continue
        snap = getattr(r, "snapshot", None)
        if not isinstance(snap, dict) or not snap.get("pinned"):
            continue
        owner = snap.get("pin_owner")
        entry = pools.get(id(owner)) if engines is not None else None
        if engines is None:
            continue   # no residency info: owner liveness unknowable here
        if entry is None or entry[0] >= len(alive) or not alive[entry[0]]:
            _fail(where,
                  f"request {r.req_id} (model {r.model}) holds a snapshot "
                  f"pinned in a departed/unattached pool: mark_dead or "
                  f"the migration sweep must release dead pins and "
                  f"restart the request")
        elif snap.get("pin_epoch") != getattr(owner, "epoch", None):
            _fail(where,
                  f"request {r.req_id} (model {r.model}) holds a snapshot "
                  f"pinned at a stale pool epoch "
                  f"{snap.get('pin_epoch')} != {getattr(owner, 'epoch', None)}: "
                  f"the pages were reset under it")


# ---------------------------------------------------------------------------
# Test-suite hooks (tests/conftest.py honors QLINT_INVARIANTS=1)
# ---------------------------------------------------------------------------
_BM_MUTATORS = ("allocate", "extend", "append_token", "free",
                "share_prefix", "fork", "evict_split", "resume_pinned",
                "release_pins", "register_prefix", "bind_slot", "reset")
_ENGINE_ROUNDS = ("step", "steps")


def install_test_hooks() -> None:
    """Wrap every BlockManager transition and engine round boundary with
    the invariant checks (idempotent).  Used by ``tests/conftest.py`` when
    ``QLINT_INVARIANTS=1`` so the whole tier-1 suite doubles as an
    invariant suite — no per-test opt-in required."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.kv_cache import BlockManager

    if getattr(BlockManager, "_qlint_hooked", False):
        return
    BlockManager._qlint_hooked = True
    ContinuousBatchingEngine._qlint_hooked = True
    sampler = InvariantSampler()

    def _wrap_bm(name):
        orig = getattr(BlockManager, name)

        def checked(self, *a, **kw):
            out = orig(self, *a, **kw)
            if sampler.due():
                check_block_manager(
                    self, where=f"QLINT_INVARIANTS/BlockManager.{name}")
            return out

        checked.__name__ = orig.__name__
        checked.__qualname__ = orig.__qualname__
        setattr(BlockManager, name, checked)

    def _wrap_round(name):
        orig = getattr(ContinuousBatchingEngine, name)

        def checked(self, *a, **kw):
            out = orig(self, *a, **kw)
            check_engine(self, where=f"QLINT_INVARIANTS/engine.{name}")
            return out

        checked.__name__ = orig.__name__
        checked.__qualname__ = orig.__qualname__
        setattr(ContinuousBatchingEngine, name, checked)

    for name in _BM_MUTATORS:
        _wrap_bm(name)
    for name in _ENGINE_ROUNDS:
        _wrap_round(name)
