"""Paged KV-cache block manager (PagedAttention-style accounting) with
refcounted prefix sharing and copy-on-write pages.

This manager owns the **allocation state machine** the iteration scheduler
uses for admission / preemption decisions: a free list of fixed-size
blocks, a per-sequence block table, and token-capacity queries.  The
paper's RWT estimator consumes ``GPU`` (total token capacity) from here
(Appendix A.1, Eq. 16).

Under the dense attention backends the block ids are pure bookkeeping (the
KV lives in per-slot ``(B, KVH, S, D)`` arrays); under the paged backends
(``attention_backend="paged-*"``) each id names a PHYSICAL page of the
global pool ``(num_blocks, KVH, block_size, D)`` — freeing a sequence
makes its HBM immediately reusable by any other sequence.

KV-page lifecycle (allocate -> share -> COW -> evict/snapshot -> resume)
-----------------------------------------------------------------------
Every physical block carries a **refcount**:

  * ``allocate`` pops blocks off the free list at refcount 1 (sole owner).
  * Once a block is FULL and its token contents are known, the engine
    publishes it to the **prefix index** (``register_prefix``): a
    ``(parent_physical_block, token_tuple) -> block_id`` map.  Chains are
    content-addressed by walking the map from the root (parent ``-1``), so
    two prompts sharing a leading template resolve to the SAME physical
    chain without hashing whole prefixes (vLLM-style chained block hash,
    but exact — keyed on the parent's physical id + raw token ids, so hash
    collisions cannot alias different contents).
  * ``match_prefix`` walks the index over an incoming prompt and returns
    the longest indexed chain covering at most ``len(prompt) - 1`` tokens
    (at least one prompt token must still run prefill to produce the
    first-token logits); ``share_prefix`` then attaches a new sequence to
    that chain — refcount + 1 per shared block, zero page copies — and
    allocates fresh blocks only for the private tail.  ``fork`` clones a
    whole live sequence the same way (parallel-sampling style).
  * **Copy-on-write**: any write that would land in a block with
    refcount > 1 (``append_token`` / ``extend`` growing into a shared
    partial tail block, or ``fork`` of a sequence whose last block is
    partial) first moves the writer onto a fresh private copy.  The
    manager only re-points the table (old refcount - 1, new block at
    refcount 1) and records ``(src, dst)`` in a pending op list; the
    engine drains ``take_cow_ops`` and performs the actual page copy on
    device before the next dispatch.  Shared blocks in the index are
    always full and never written, so COW sources are never indexed.
  * **Eviction** (``evict_split``): leading blocks still referenced by
    another owner (refcount > 1) are NOT freed or copied — the departing
    sequence's reference transfers to a **pin** held by its host-side
    snapshot, so the chain outlives even the other sharers.  Only the
    private tail is released (and its page contents snapshotted by the
    engine).  ``resume_pinned`` hands the pinned chain back to the
    resuming sequence (pin -> sequence reference, still no copies);
    ``release_pins`` drops a snapshot that will never resume.  Pins are
    epoch-guarded: ``reset`` invalidates every outstanding pin.
  * A block whose refcount reaches 0 is deregistered from the prefix
    index and returned to the free list — it can never be reached through
    a stale chain afterwards (the index only ever names live blocks).
  * **Freed-block cache** (``cache_freed=True``, off by default): an
    indexed block whose refcount reaches 0 stays in the prefix index on a
    free-but-cached LRU list instead of being deregistered, so a LATER
    request with the same leading tokens (a multi-turn session's follow-up
    carrying the previous turn as its prompt prefix) still matches after
    the original sequence finished.  Cached blocks count as free capacity:
    allocation evicts the LRU cached subtree on demand (descendants of a
    cached block are themselves cached — refcounts are non-increasing
    along a chain — and are dropped with it so a reused physical id can
    never alias stale content), and ``share_prefix`` revives matched
    cached blocks back to refcount 1 with zero copies.

The manager can additionally maintain an **incremental slot table**
(``attach_slot_table``): a persistent fixed-shape ``(rows, width)`` int32
array mapping engine slots to physical page ids, updated in place by every
allocate/share/fork/COW/extend/append_token/free instead of being rebuilt
O(rows x width) in Python each engine iteration.  ``table_version`` bumps
on every table mutation so the engine refreshes its device copy only when
something actually changed.  Two rows may name the same physical page
(shared prefixes); the kernels only ever read shared pages — writes target
private blocks, which COW guarantees.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# prefix-index key: (parent physical block id | -1 for the root,
#                    token ids filling this block)
PrefixKey = Tuple[int, Tuple[int, ...]]


class OutOfBlocksError(RuntimeError):
    pass


@dataclasses.dataclass
class SeqAlloc:
    block_table: List[int]
    num_tokens: int
    # leading full blocks already published to the prefix index (a lazy
    # watermark — register_prefix is idempotent and re-walks are cheap)
    registered: int = 0


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int = 16,
                 watermark: float = 0.01, cache_freed: bool = False):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.cache_freed = cache_freed
        # reserve a small watermark so decode appends don't immediately OOM
        self.watermark_blocks = max(1, int(num_blocks * watermark))
        self._free: List[int] = list(range(num_blocks))
        # freed-but-indexed blocks (cache_freed): LRU insertion order,
        # evicted on demand by _acquire, revived by share_prefix
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._seqs: Dict[int, SeqAlloc] = {}
        # per-block reference counts: 0 = free, 1 = sole owner, >1 = shared
        self._ref = np.zeros(num_blocks, np.int32)
        # snapshot pins: block -> number of evicted-sequence snapshots
        # holding a reference (each pin is one unit of _ref)
        self._pins: Dict[int, int] = {}
        # prefix index: chained content-addressed full blocks
        self._index: Dict[PrefixKey, int] = {}
        self._block_key: Dict[int, PrefixKey] = {}
        # pending (src, dst) page copies the engine must apply on device
        # before its next dispatch
        self._cow_ops: List[Tuple[int, int]] = []
        # bumped by reset(): outstanding pins from before a reset are dead
        self.epoch = 0
        # incremental slot table (attach_slot_table): row per engine slot,
        # sentinel num_blocks for unallocated logical blocks / unbound rows
        self._table: Optional[np.ndarray] = None
        self._seq_rows: Dict[int, int] = {}
        self.table_version = 0

    # ------------------------------------------------------------------
    # incremental slot table
    # ------------------------------------------------------------------
    def attach_slot_table(self, rows: int, width: int) -> None:
        """Maintain a persistent ``(rows, width)`` int32 slot -> physical
        page table.  Row ``r`` mirrors the block table of the sequence bound
        to it via ``bind_slot``; unbound rows and unallocated logical blocks
        hold the sentinel ``num_blocks`` (writes dropped, reads masked).
        Every subsequent allocate/extend/append_token/free updates the table
        in place — O(new blocks) instead of an O(rows x width) rebuild."""
        self._table = np.full((rows, width), self.num_blocks, np.int32)
        self._seq_rows.clear()
        self.table_version += 1

    def bind_slot(self, seq_id: int, row: int) -> None:
        """Bind an allocated sequence to a table row (engine slot) and
        populate the row from its current block table."""
        if self._table is None:
            return
        assert seq_id in self._seqs, seq_id
        self._seq_rows[seq_id] = row
        blocks = self._seqs[seq_id].block_table
        assert len(blocks) <= self._table.shape[1], \
            (len(blocks), self._table.shape)
        self._table[row, :len(blocks)] = blocks
        self._table[row, len(blocks):] = self.num_blocks
        self.table_version += 1

    def _table_append(self, seq_id: int, new_blocks: List[int],
                      start: int) -> None:
        """Record blocks just appended to ``seq_id``'s block table at
        logical positions [start, start + len(new_blocks))."""
        if self._table is None or not new_blocks:
            return
        row = self._seq_rows.get(seq_id)
        if row is None:
            return
        assert start + len(new_blocks) <= self._table.shape[1], \
            (start, len(new_blocks), self._table.shape)
        self._table[row, start:start + len(new_blocks)] = new_blocks
        self.table_version += 1

    def _table_set(self, seq_id: int, idx: int, block: int) -> None:
        """Re-point one logical position (COW re-targeting)."""
        if self._table is None:
            return
        row = self._seq_rows.get(seq_id)
        if row is None:
            return
        self._table[row, idx] = block
        self.table_version += 1

    def _table_clear(self, seq_id: int) -> None:
        row = self._seq_rows.pop(seq_id, None)
        if self._table is not None and row is not None:
            self._table[row, :] = self.num_blocks
            self.table_version += 1

    def slot_table(self) -> Optional[np.ndarray]:
        """The incrementally-maintained table (None until attached).  The
        caller must treat it as read-only; it is mutated in place by the
        allocation state machine."""
        return self._table

    # ------------------------------------------------------------------
    @property
    def token_capacity(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: the free list plus the freed-but-cached
        blocks (evictable on demand, so they ARE capacity)."""
        return len(self._free) + len(self._cached)

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    def tokens_allocated(self) -> int:
        return sum(s.num_tokens for s in self._seqs.values())

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def ref_count(self, block: int) -> int:
        return int(self._ref[block])

    def pin_count(self, block: int) -> int:
        return self._pins.get(block, 0)

    def can_allocate(self, num_tokens: int, *, respect_watermark: bool = True,
                     reserve_blocks: int = 0, shared_blocks: int = 0) -> bool:
        """``reserve_blocks``: extra blocks already promised elsewhere (e.g.
        the unallocated remainder of mid-prefill sequences).
        ``shared_blocks``: leading blocks that will be attached from the
        prefix index (or a pinned snapshot) instead of the free list."""
        need = max(self.blocks_needed(num_tokens) - shared_blocks, 0)
        reserve = self.watermark_blocks if respect_watermark else 0
        return need <= self.free_blocks - reserve - reserve_blocks

    # ------------------------------------------------------------------
    # block acquisition / release
    # ------------------------------------------------------------------
    def _acquire(self, n: int) -> List[int]:
        blocks = []
        for _ in range(n):
            b = self._free.pop() if self._free else self._evict_cached()
            assert self._ref[b] == 0, (b, self._ref[b])
            self._ref[b] = 1
            blocks.append(b)
        return blocks

    def _evict_cached(self) -> int:
        """Reclaim the LRU freed-but-cached block for allocation."""
        block, _ = self._cached.popitem(last=False)
        self._deregister(block)
        return block

    def _deregister(self, block: int) -> None:
        """Remove ``block`` from the prefix index, and with it every
        indexed DESCENDANT: their keys chain through this physical id,
        which is about to become reusable — a reused id must never alias
        stale content.  Descendants of a cached block are cached too
        (refcounts are non-increasing along a chain), so the subtree walk
        moves them from the cache to the plain free list."""
        key = self._block_key.pop(block, None)
        if key is None or self._index.get(key) != block:
            return
        del self._index[key]
        children = [b for (parent, _toks), b in self._index.items()
                    if parent == block]
        for c in children:
            if c in self._cached:
                del self._cached[c]
                self._free.append(c)
            self._deregister(c)

    def _release_block(self, block: int) -> None:
        """Drop one reference; at zero the block is deregistered from the
        prefix index and returned to the free list — or, with
        ``cache_freed``, kept indexed on the cached LRU list so later
        same-prefix admissions still match it."""
        assert self._ref[block] >= 1, block
        self._ref[block] -= 1
        if self._ref[block] == 0:
            if self._cow_ops:
                # A pending COW op whose *destination* dies here is moot (the
                # queuing sequence is gone) and must not run: the block goes
                # back on the free list and may be reallocated before the
                # engine drains take_cow_ops(), so a late copy would clobber
                # the new owner's page.  Ops whose *source* dies stay queued —
                # the old page contents remain valid until the next dispatch,
                # and the engine drains COW ops before dispatching.
                self._cow_ops = [(s, d) for (s, d) in self._cow_ops
                                 if d != block]
            if self.cache_freed \
                    and self._index.get(self._block_key.get(block)) == block:
                self._cached[block] = None
                return
            self._deregister(block)
            self._free.append(block)

    # ------------------------------------------------------------------
    # allocation state machine
    # ------------------------------------------------------------------
    def allocate(self, seq_id: int, num_tokens: int, *,
                 respect_watermark: bool = True) -> List[int]:
        """Allocate a fresh sequence's blocks.

        ``respect_watermark`` defaults to True so an admission-time
        ``can_allocate`` check and the allocation it green-lights enforce
        the SAME bound — previously ``allocate`` ignored the watermark and
        could silently eat the reserve ``can_allocate`` had just refused to
        touch.  Pass False only for allocations that are allowed to dip
        into the reserve (mirroring ``extend`` / ``append_token``, which
        never apply it to in-flight sequences).
        """
        if seq_id in self._seqs:
            raise KeyError(f"seq {seq_id} already allocated")
        need = self.blocks_needed(num_tokens)
        reserve = self.watermark_blocks if respect_watermark else 0
        if need > self.free_blocks - reserve:
            raise OutOfBlocksError(
                f"need {need} blocks, {self.free_blocks} free"
                + (f" ({reserve} reserved by watermark)" if reserve else ""))
        blocks = self._acquire(need)
        self._seqs[seq_id] = SeqAlloc(block_table=blocks, num_tokens=num_tokens)
        return blocks

    def _cow(self, seq_id: int, idx: int) -> None:
        """Move ``seq_id`` off the shared block at logical position ``idx``
        onto a fresh private copy.  The caller guarantees a free block.
        Only ever hits partial tail blocks — indexed blocks are full and
        never written, so a COW source is never in the prefix index."""
        alloc = self._seqs[seq_id]
        old = alloc.block_table[idx]
        assert self._ref[old] > 1, (old, int(self._ref[old]))
        assert old not in self._block_key, old
        new = self._acquire(1)[0]
        self._ref[old] -= 1
        alloc.block_table[idx] = new
        self._cow_ops.append((old, new))
        self._table_set(seq_id, idx, new)

    def take_cow_ops(self) -> List[Tuple[int, int]]:
        """Drain pending ``(src, dst)`` page copies.  The engine MUST apply
        them on device before the next dispatch that could write ``dst``."""
        ops, self._cow_ops = self._cow_ops, []
        return ops

    def _write_needs_cow(self, alloc: SeqAlloc) -> bool:
        """True when the next appended token lands in an existing block the
        sequence does not own exclusively."""
        if alloc.num_tokens % self.block_size == 0 or not alloc.block_table:
            return False
        return bool(self._ref[alloc.block_table[-1]] > 1)

    def append_needs_cow(self, seq_id: int) -> bool:
        """Engine burst planning: will growing this sequence trigger a COW
        (one extra free block beyond the plain block math)?"""
        return self._write_needs_cow(self._seqs[seq_id])

    def extend(self, seq_id: int, num_tokens: int) -> bool:
        """Grow ``seq_id``'s allocation to cover ``num_tokens`` total.

        Chunk-granular prefill allocates one chunk at a time instead of the
        whole prompt up front; each subsequent chunk extends the allocation.
        Returns False when the needed blocks aren't free (caller preempts) —
        like ``append_token``, the watermark is not applied to in-flight
        sequences.  Growth that writes into a shared partial tail block
        copy-on-writes it first (one extra free block).
        """
        alloc = self._seqs[seq_id]
        if num_tokens <= alloc.num_tokens:
            return True
        need = self.blocks_needed(num_tokens) - len(alloc.block_table)
        cow = self._write_needs_cow(alloc)
        if need + (1 if cow else 0) > self.free_blocks:
            return False
        if cow:
            self._cow(seq_id, len(alloc.block_table) - 1)
        start = len(alloc.block_table)
        for _ in range(need):
            alloc.block_table.append(self._acquire(1)[0])
        alloc.num_tokens = num_tokens
        self._table_append(seq_id, alloc.block_table[start:], start)
        return True

    def append_token(self, seq_id: int) -> bool:
        """Account one more token; returns False if a new block (or a COW
        copy of a shared tail block) was needed but none was free (caller
        must preempt)."""
        alloc = self._seqs[seq_id]
        if alloc.num_tokens % self.block_size == 0:
            if not self.free_blocks:
                return False
            alloc.block_table.append(self._acquire(1)[0])
            self._table_append(seq_id, alloc.block_table[-1:],
                               len(alloc.block_table) - 1)
        elif self._write_needs_cow(alloc):
            if not self.free_blocks:
                return False
            self._cow(seq_id, len(alloc.block_table) - 1)
        alloc.num_tokens += 1
        return True

    def free(self, seq_id: int) -> None:
        alloc = self._seqs.pop(seq_id, None)
        if alloc is not None:
            for b in alloc.block_table:
                self._release_block(b)
            self._table_clear(seq_id)

    def block_table(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id].block_table)

    def seq_tokens(self, seq_id: int) -> int:
        return self._seqs[seq_id].num_tokens

    def has(self, seq_id: int) -> bool:
        return seq_id in self._seqs

    def reset(self) -> None:
        self._free = list(range(self.num_blocks))
        self._cached.clear()
        self._seqs.clear()
        self._seq_rows.clear()
        self._ref[:] = 0
        self._pins.clear()
        self._index.clear()
        self._block_key.clear()
        self._cow_ops.clear()
        self.epoch += 1
        if self._table is not None:
            self._table[:] = self.num_blocks
        self.table_version += 1

    # ------------------------------------------------------------------
    # prefix index: content-addressed full blocks
    # ------------------------------------------------------------------
    def register_prefix(self, seq_id: int, tokens: Sequence[int],
                        upto_tokens: int) -> int:
        """Publish ``seq_id``'s full leading blocks whose token contents
        (``tokens``, the prompt) are computed up to ``upto_tokens``.
        Idempotent; returns the number of registered leading blocks.

        Registration stops at the first key already claimed by a DIFFERENT
        physical chain (duplicate content computed concurrently): deeper
        blocks of this chain would be unreachable from the index root, so
        publishing them would only leak entries."""
        alloc = self._seqs[seq_id]
        bs = self.block_size
        n_full = min(int(upto_tokens), alloc.num_tokens, len(tokens)) // bs
        n_full = min(n_full, len(alloc.block_table))
        i = alloc.registered
        while i < n_full:
            b = alloc.block_table[i]
            if b in self._block_key:        # already published (shared chain)
                i += 1
                continue
            parent = alloc.block_table[i - 1] if i > 0 else -1
            key = (parent, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            if key in self._index:
                break
            self._index[key] = b
            self._block_key[b] = key
            i += 1
        alloc.registered = i
        return i

    def match_prefix(self, tokens: Sequence[int],
                     max_tokens: Optional[int] = None) -> List[int]:
        """Longest indexed chain of full blocks covering a leading run of
        ``tokens``.  Capped at ``max_tokens`` (default ``len(tokens) - 1``:
        at least one prompt token must still run prefill so the final chunk
        produces the first-token logits)."""
        toks = tokens
        if max_tokens is None:
            max_tokens = max(len(toks) - 1, 0)
        bs = self.block_size
        n_full = min(len(toks), max_tokens) // bs
        parent = -1
        out: List[int] = []
        for i in range(n_full):
            key = (parent, tuple(int(t) for t in toks[i * bs:(i + 1) * bs]))
            b = self._index.get(key)
            if b is None:
                break
            out.append(b)
            parent = b
        return out

    def share_prefix(self, seq_id: int, num_tokens: int,
                     shared_blocks: Sequence[int], *,
                     respect_watermark: bool = True) -> List[int]:
        """Attach a fresh sequence to an existing indexed chain: refcount+1
        on each shared block (no copies), fresh blocks for the private tail
        up to ``num_tokens``.  ``shared_blocks`` must be a chain returned by
        ``match_prefix`` (live, full blocks)."""
        if seq_id in self._seqs:
            raise KeyError(f"seq {seq_id} already allocated")
        shared = list(shared_blocks)
        need = self.blocks_needed(num_tokens) - len(shared)
        assert need >= 0, (num_tokens, len(shared))
        reserve = self.watermark_blocks if respect_watermark else 0
        # cached matched blocks are revived (leave the allocatable pool)
        # rather than consumed, so they reduce capacity without reducing
        # need — same arithmetic the engine's can_allocate uses when it
        # counts only live matched blocks as shared
        cached_shared = sum(1 for b in shared if self._ref[b] == 0)
        if need > self.free_blocks - cached_shared - reserve:
            raise OutOfBlocksError(
                f"need {need} fresh blocks, "
                f"{self.free_blocks - cached_shared} free"
                + (f" ({reserve} reserved by watermark)" if reserve else ""))
        for b in shared:
            if self._ref[b] == 0:       # revive from the freed-block cache
                del self._cached[b]
                self._ref[b] = 1
            else:
                self._ref[b] += 1
        blocks = shared + self._acquire(need)
        self._seqs[seq_id] = SeqAlloc(block_table=blocks,
                                      num_tokens=num_tokens,
                                      registered=len(shared))
        return blocks

    def fork(self, src_seq_id: int, new_seq_id: int) -> List[int]:
        """Clone a live sequence: the new sequence shares EVERY block of the
        source (refcount+1 each, no copies).  A partial tail block is
        copy-on-written for the new sequence immediately so the two decodes
        never scatter into the same page."""
        if new_seq_id in self._seqs:
            raise KeyError(f"seq {new_seq_id} already allocated")
        src = self._seqs[src_seq_id]
        tail_partial = bool(src.block_table) \
            and src.num_tokens % self.block_size != 0
        if tail_partial and not self.free_blocks:
            raise OutOfBlocksError("fork needs one free block for the COW "
                                   "copy of the partial tail block")
        for b in src.block_table:
            self._ref[b] += 1
        self._seqs[new_seq_id] = SeqAlloc(block_table=list(src.block_table),
                                          num_tokens=src.num_tokens,
                                          registered=src.registered)
        if tail_partial:
            self._cow(new_seq_id, len(src.block_table) - 1)
        return list(self._seqs[new_seq_id].block_table)

    # ------------------------------------------------------------------
    # eviction under shared ownership
    # ------------------------------------------------------------------
    def shared_prefix_len(self, seq_id: int) -> int:
        """Leading blocks of ``seq_id`` that another owner also references
        (refcount > 1) — the run ``evict_split`` will pin instead of free.
        Refcounts are non-increasing along a chain (sharing only ever
        attaches prefixes; COW peels the first divergent block), so the
        leading run is exactly the shared region."""
        n = 0
        for b in self._seqs[seq_id].block_table:
            if self._ref[b] > 1:
                n += 1
            else:
                break
        return n

    def evict_split(self, seq_id: int) -> Tuple[List[int], List[int]]:
        """Evict ``seq_id`` keeping shared blocks alive: returns
        ``(pinned, private)``.  ``pinned`` blocks keep this sequence's
        reference as a snapshot pin (NOT freed, NOT copied — they stay in
        the prefix index and matchable); ``private`` blocks are released
        (the engine snapshots their page contents).  With no sharing in
        play this degenerates to ``([], all_blocks)`` == ``free``."""
        k = self.shared_prefix_len(seq_id)
        alloc = self._seqs.pop(seq_id)
        pinned = alloc.block_table[:k]
        private = alloc.block_table[k:]
        for b in pinned:
            self._pins[b] = self._pins.get(b, 0) + 1
        for b in private:
            self._release_block(b)
        self._table_clear(seq_id)
        return pinned, private

    def resume_pinned(self, seq_id: int, pinned_blocks: Sequence[int],
                      num_tokens: int, *,
                      respect_watermark: bool = True) -> List[int]:
        """Re-create an evicted sequence from its snapshot: the pinned chain
        transfers back (pin -> sequence reference, no copies) and fresh
        blocks cover the private remainder, which the engine re-scatters
        from the snapshot."""
        if seq_id in self._seqs:
            raise KeyError(f"seq {seq_id} already allocated")
        pinned = list(pinned_blocks)
        for b in pinned:
            assert self._pins.get(b, 0) >= 1 and self._ref[b] >= 1, b
        need = self.blocks_needed(num_tokens) - len(pinned)
        assert need >= 0, (num_tokens, len(pinned))
        reserve = self.watermark_blocks if respect_watermark else 0
        if need > self.free_blocks - reserve:
            raise OutOfBlocksError(
                f"need {need} fresh blocks, {self.free_blocks} free"
                + (f" ({reserve} reserved by watermark)" if reserve else ""))
        for b in pinned:
            self._pins[b] -= 1
            if self._pins[b] == 0:
                del self._pins[b]
        blocks = pinned + self._acquire(need)
        self._seqs[seq_id] = SeqAlloc(block_table=blocks,
                                      num_tokens=num_tokens)
        return blocks

    def release_pins(self, blocks: Sequence[int], epoch: int) -> None:
        """Drop a snapshot's pins (the snapshot will never resume HERE —
        discarded, or resumed on another engine).  ``epoch`` must be the
        pool epoch recorded at eviction: after a ``reset`` the pins are
        already dead and this is a no-op."""
        if epoch != self.epoch:
            return
        for b in blocks:
            self._pins[b] -= 1
            if self._pins[b] == 0:
                del self._pins[b]
            self._release_block(b)
