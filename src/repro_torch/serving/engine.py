"""Continuous-batching LLM engine (PyTorch twin of
``src/repro/serving/engine.py``, chunked-prefill paths).

The engine is the "LLM serving instance" of the paper (Def. 2.3): a fixed
slot array holding the running batch, KV accounting through
``BlockManager`` (admission, preemption, refcounted prefix sharing with
copy-on-write pages on the paged layout), chunked prefill, eviction
snapshots, model swapping and the request-pull hook the QLM agent drives.
Its host-side logic is the reference engine's, line for line; what
changed is the compute:

  * backend ``"paged-cuda"`` (``None`` means the same), the counterpart
    of the reference's ``"paged-pallas"``: every round runs
    ``prefill_chunk_paged`` / ``decode_step_paged`` over the KV page pool
    ``(layers, num_blocks + 1, KVH, block_size, D)``, whose attention is
    the hand-written CUDA paged kernels (their int8 twins for a
    ``kv_quant`` model) on a CUDA device and their plain PyTorch versions
    on the CPU.  Full attention only;
  * backend ``"cuda"``, the counterpart of ``"pallas"``: the dense
    per-slot cache ``(layers, max_slots, KVH, cache_len + 1, D)`` (a
    rolling window for sliding-window models), ``prefill_chunk`` /
    ``decode_step``; decode runs the dense CUDA decode kernel (or its
    int8 twin) under full attention, the chunk step and rolling-window
    decode run plain PyTorch, as the reference runs jnp there.  Prefix
    sharing is inert on this layout, as in the reference.  An SSM
    (mamba2) serves only here: its per-slot state ``{"conv", "ssm"}``
    takes the place of the KV cache, and it is admitted through the
    reference's single-shot prefill (``_prefill_one``: batch 1 at the
    exact prompt length, whose scan is the CUDA SSD kernel on a CUDA
    device), since its state carry has no chunked prefill;
  * the cache is updated in place; COW page copies land before any
    dispatch or snapshot;
  * the block table is uploaded only when ``BlockManager.table_version``
    moves, from a copy of the manager's table, which it mutates in place;
  * timed regions end in ``torch.cuda.synchronize`` on a CUDA device, so
    ``prefill_time`` / ``decode_time`` (and the RWT calibration built on
    them) measure compute, not launch;
  * ``steps(k)`` runs the burst as a host loop over device-side finish
    flags with the reference's ``lax.while_loop`` rules and one host sync
    per burst: the host caps the burst at the largest number of tokens any
    slot may still emit, so only a burst cut short by EOS runs idle
    iterations (every slot frozen, nothing emitted);
  * ``pages_per_tile`` is forwarded to the model config's
    ``paged_pages_per_tile`` as in the reference, and the CUDA kernels
    ignore it: they tile by keys (64 a tile, from any pages), not by pages.
    ``donate_buffers`` is accepted and has no effect: the cache is always
    updated in place;
  * eviction snapshots keep the same dict, with ``"cache"`` holding CPU
    torch tensors of the evicted pages or slot (bfloat16 has no numpy
    dtype); a snapshot resumes only on an engine of its own layout.

Not ported: the reference's ``"xla"`` / ``"paged-xla"`` backends, the
single-shot prefill of a dense transformer (``prefill_chunk_tokens=0``),
modality extras and ``fork_slot`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, ClassVar, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.request import Request
from repro_torch.device import resolve_device
from repro_torch.models.model_factory import Model
from repro_torch.serving.kv_cache import BlockManager

ATTENTION_BACKENDS = ("cuda", "paged-cuda")
# backend names of the reference engine; "pallas" / "paged-pallas" are
# served here as "cuda" / "paged-cuda"
_REFERENCE_ONLY_BACKENDS = ("xla", "pallas", "paged-xla", "paged-pallas")


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8
    max_seq_len: int = 512
    block_size: int = 16
    kv_blocks: Optional[int] = None    # None => max_slots*max_seq_len worth
    eos_token: Optional[int] = None
    dtype: torch.dtype = torch.float32
    # Where the model runs; "cuda" needs a card, "cpu" runs the kernels'
    # plain versions.  The engine never falls back from one to the other.
    device: str = "cuda"
    # Chunked prefill: max prompt tokens processed per slot per step().
    prefill_chunk_tokens: int = 128
    # Chunk-length padding buckets; None => powers of two up to
    # prefill_chunk_tokens.
    prefill_buckets: Optional[Tuple[int, ...]] = None
    # "paged-cuda" (page pool) or "cuda" (dense per-slot cache); None
    # means "paged-cuda".
    attention_backend: Optional[str] = None
    # The reference's KV pages per Pallas grid step, forwarded to the
    # model config's paged_pages_per_tile; the CUDA kernels tile by keys
    # (64 a tile, gathered from any pages) and do not read it.
    pages_per_tile: Optional[int] = None
    # Fused multi-step decode: ``steps()`` runs up to this many decode
    # iterations per host round trip.  1 = the single-step ``step()`` loop.
    decode_burst: int = 1
    # The reference donates the cache to its jitted calls so XLA updates
    # it in place; PyTorch always updates it in place, so this has no
    # effect.
    donate_buffers: bool = True
    # Run repro_torch.analysis.invariants.check_engine at every
    # step()/steps() round boundary (also forced on by QLINT_INVARIANTS=1).
    debug_invariants: bool = False
    # Refcounted prefix sharing + copy-on-write pages.
    prefix_sharing: bool = True
    # The BlockManager keeps the (max_slots, max_blocks_per_seq) block table
    # up to date in place; the invariant checker holds it against the
    # from-scratch rebuild ``_block_table_array`` when this is set.
    incremental_block_table: ClassVar[bool] = True

    @property
    def paged(self) -> bool:
        return self.attention_backend != "cuda"

    def resolved_kv_blocks(self) -> int:
        if self.kv_blocks is not None:
            return self.kv_blocks
        return (self.max_slots * self.max_seq_len) // self.block_size

    def max_blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.block_size)

    def resolved_buckets(self) -> Tuple[int, ...]:
        """Chunk-length padding buckets: the custom ones completed up to
        prefill_chunk_tokens, else powers of two from 16 capped by it."""
        if self.prefill_buckets:
            buckets = sorted(self.prefill_buckets)
            if self.prefill_chunk_tokens > 0 \
                    and buckets[-1] < self.prefill_chunk_tokens:
                # buckets must cover the largest possible chunk, else the
                # padding falls back to exact lengths
                buckets.append(self.prefill_chunk_tokens)
            return tuple(buckets)
        if self.prefill_chunk_tokens <= 0:
            return ()
        buckets = []
        b = 16
        while b < self.prefill_chunk_tokens:
            buckets.append(b)
            b *= 2
        buckets.append(self.prefill_chunk_tokens)
        return tuple(buckets)


@dataclasses.dataclass
class EngineStats:
    decode_iterations: int = 0
    prefills: int = 0
    prefill_chunks: int = 0
    evictions: int = 0
    resumes: int = 0
    model_swaps: int = 0
    tokens_generated: int = 0
    preemptions: int = 0
    decode_time: float = 0.0
    prefill_time: float = 0.0
    swap_time: float = 0.0
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_shared_blocks: int = 0
    prefix_shared_tokens: int = 0
    prompt_tokens_admitted: int = 0
    cow_copies: int = 0
    forks: int = 0
    cancellations: int = 0
    sheds: int = 0
    migrations_out: int = 0
    migrations_in: int = 0


class ContinuousBatchingEngine:
    def __init__(self, model: Model, params, cfg: EngineConfig,
                 model_name: str = "default",
                 clock: Callable[[], float] = time.monotonic):
        if cfg.attention_backend in _REFERENCE_ONLY_BACKENDS:
            raise NotImplementedError(
                f"attention_backend {cfg.attention_backend!r} is the "
                f"reference's; the port serves {ATTENTION_BACKENDS} "
                f"(\"pallas\" -> \"cuda\", \"paged-pallas\" -> "
                f"\"paged-cuda\")")
        if cfg.attention_backend not in ATTENTION_BACKENDS + (None,):
            raise ValueError(
                f"attention_backend must be one of {ATTENTION_BACKENDS} "
                f"or None, got {cfg.attention_backend!r}")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # lifecycle clock vs calibration wall clock (see the reference)
        self.clock = clock
        self._wall = time.monotonic
        self.lock = threading.RLock()
        self.paged = cfg.paged
        # sharing needs a physical page pool: inert on the dense layout
        self.prefix_sharing = bool(cfg.prefix_sharing) and self.paged
        self._check_layout(model)
        self.model = self._with_tile(model)
        self.params = params
        self.model_name = model_name
        self.stats = EngineStats()
        self.block_mgr = BlockManager(cfg.resolved_kv_blocks(),
                                      cfg.block_size,
                                      cache_freed=self.prefix_sharing)
        self.block_mgr.attach_slot_table(cfg.max_slots,
                                         cfg.max_blocks_per_seq())
        self._bt_device: Optional[torch.Tensor] = None
        self._bt_version_seen = -1
        self.slots: List[Optional[Request]] = [None] * cfg.max_slots
        self.lengths = np.zeros(cfg.max_slots, np.int32)
        self.prefill_pos = np.zeros(cfg.max_slots, np.int32)
        self.cache = self._init_cache()
        self.pull_source: Optional[Callable[[], Optional[Request]]] = None
        self._pinned_snapshots: List[Request] = []
        self._pushback: Optional[Request] = None
        # requests that finished inside admit() (single-shot path, EOS or
        # max_new_tokens on the prefill token); returned by the next step()
        self._admit_completed: List[Request] = []

    def _check_layout(self, model: Model) -> None:
        """Refuse, before any state changes, a model this engine cannot
        serve: one that needs the unported single-shot prefill of a dense
        transformer, one without pageable KV (an SSM) or with a sliding
        window on the page pool."""
        if model.prefill is None and (self.cfg.prefill_chunk_tokens <= 0
                                      or model.prefill_chunk is None):
            raise NotImplementedError(
                f"the single-shot prefill of a {model.cfg.arch_type} model "
                f"(prefill_chunk_tokens <= 0) is not ported: "
                f"{model.cfg.name} needs chunked prefill")
        if self.paged and model.init_paged_cache is None:
            raise ValueError(
                f"attention_backend "
                f"{self.cfg.attention_backend or 'paged-cuda'!r} requires "
                f"an arch with pageable KV (got {model.cfg.arch_type}: serve "
                f"{model.cfg.name} on attention_backend='cuda')")
        if self.paged and model.cfg.sliding_window is not None:
            raise ValueError(
                f"paged attention backends support full attention only; "
                f"{model.cfg.name} has a sliding window (serve it on "
                f"attention_backend='cuda')")

    def _with_tile(self, model: Model) -> Model:
        """``model`` with ``cfg.pages_per_tile`` in its config's
        ``paged_pages_per_tile``, as the reference forwards it."""
        ppt = self.cfg.pages_per_tile
        if ppt is None or model.cfg.paged_pages_per_tile == ppt:
            return model
        from repro_torch.models.model_factory import build_model
        return build_model(dataclasses.replace(model.cfg,
                                               paged_pages_per_tile=ppt))

    def _init_cache(self) -> Dict[str, torch.Tensor]:
        if self.paged:
            return self.model.init_paged_cache(
                self.cfg.resolved_kv_blocks(), self.cfg.block_size,
                self.cfg.dtype, self.device)
        return self.model.init_cache(self.cfg.max_slots, self.cfg.max_seq_len,
                                     self.cfg.dtype, self.device)

    def _sync(self) -> None:
        """Wait for the device: ends every timed region."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # torch.tensor copies: the host array may change after the call
        return torch.tensor(a, device=self.device)

    # ------------------------------------------------------------------
    # block tables
    # ------------------------------------------------------------------
    def _block_table_array(self) -> np.ndarray:
        """From-scratch rebuild of the (max_slots, max_blocks_per_seq) int32
        block table (sentinel ``num_blocks`` for unallocated logical blocks
        and empty slots).  The reference path the invariant checker holds
        the incremental table against."""
        sentinel = self.block_mgr.num_blocks
        bt = np.full((self.cfg.max_slots, self.cfg.max_blocks_per_seq()),
                     sentinel, np.int32)
        for i in self.active_slots():
            r = self.slots[i]
            if self.block_mgr.has(r.req_id):
                row = self.block_mgr.block_table(r.req_id)
                assert len(row) <= bt.shape[1], (len(row), bt.shape)
                bt[i, :len(row)] = row
        return bt

    def _device_block_table(self) -> torch.Tensor:
        """Device copy of the slot block table, uploaded only when the
        BlockManager's incremental table changed since the last dispatch."""
        version = self.block_mgr.table_version
        if self._bt_device is None or self._bt_version_seen != version:
            self._bt_device = self._to_device(self.block_mgr.slot_table())
            self._bt_version_seen = version
        return self._bt_device

    # ------------------------------------------------------------------
    # slot plumbing
    # ------------------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _slot_index(self, b: int) -> tuple:
        """Slot ``b`` of every dense cache leaf: the KV leaves (layers, B,
        KVH, cache_len + 1, ...) without their write-sink column, an SSM's
        conv and state leaves whole."""
        if "k" not in self.cache:
            return (slice(None), b)
        S = self.cache["k"].shape[3] - 1
        return (slice(None), b, slice(None), slice(0, S))

    def _extract_cache(self, b: int) -> Dict[str, torch.Tensor]:
        """Dense eviction snapshot: slot ``b`` of every leaf, copied to CPU
        tensors (a copy on the CPU too: the slot is rewritten while the
        snapshot waits)."""
        idx = self._slot_index(b)
        return {name: leaf[idx].to("cpu", copy=True)
                for name, leaf in self.cache.items()}

    def _restore_cache(self, snapshot: Dict[str, torch.Tensor],
                       b: int) -> None:
        idx = self._slot_index(b)
        for name, leaf in self.cache.items():
            leaf[idx] = snapshot[name].to(self.device, leaf.dtype)

    def _insert_cache(self, slot_cache: Dict[str, torch.Tensor],
                      b: int) -> None:
        """Write a batch-1 cache (the single-shot prefill's) into slot b."""
        for name, leaf in self.cache.items():
            leaf[:, b] = slot_cache[name][:, 0]

    def _prefill_one(self, prompt: np.ndarray) -> Tuple[int, Dict[str, Any]]:
        """Prefill a single request (batch 1, exact length: SSM-state safe)
        from a fresh cache; returns (first token, that cache)."""
        cache1 = self.model.init_cache(1, self.cfg.max_seq_len,
                                       self.cfg.dtype, self.device)
        tokens = torch.tensor(prompt, dtype=torch.int32,
                              device=self.device)[None]
        logits, cache1 = self.model.prefill(self.params, {"tokens": tokens},
                                            cache1)
        return int(torch.argmax(logits[0], dim=-1)), cache1

    def _extract_pages(self, block_ids: List[int]) -> Dict[str, torch.Tensor]:
        """Eviction snapshot: copy ONLY the given pages (axis 1 of each
        (layers, num_blocks + 1, ...) pool) to host memory, as CPU tensors."""
        ids = torch.tensor(block_ids, dtype=torch.long, device=self.device)
        return {name: pool[:, ids].cpu() for name, pool in self.cache.items()}

    def _restore_pages(self, snapshot: Dict[str, torch.Tensor],
                       block_ids: List[int], offset: int = 0) -> None:
        """Scatter snapshotted page contents into freshly allocated pages
        starting at logical block ``offset`` (the pinned shared prefix,
        already resident, precedes them)."""
        n_snap = snapshot["k"].shape[1]
        assert len(block_ids) - offset >= n_snap, \
            (len(block_ids), offset, n_snap)
        ids = torch.tensor(block_ids[offset:offset + n_snap], dtype=torch.long,
                           device=self.device)
        for name, pool in self.cache.items():
            pool[:, ids] = snapshot[name].to(self.device, pool.dtype)

    def _apply_cow(self) -> None:
        """Apply pending copy-on-write page copies (BlockManager re-pointed
        the tables; the page CONTENTS move here) — before any dispatch that
        could write a COW destination page, and before an eviction snapshot
        reads one."""
        if not self.paged:
            return
        ops = self.block_mgr.take_cow_ops()
        if not ops:
            return
        src = torch.tensor([s for s, _ in ops], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([d for _, d in ops], dtype=torch.long,
                           device=self.device)
        for pool in self.cache.values():
            pool[:, dst] = pool[:, src]
        self.stats.cow_copies += len(ops)

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def decode_slots(self) -> List[int]:
        """Slots whose prefill is complete (participate in decode)."""
        return [i for i, r in enumerate(self.slots)
                if r is not None and self.prefill_pos[i] >= r.prompt_len]

    def prefilling_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots)
                if r is not None and self.prefill_pos[i] < r.prompt_len]

    def num_active(self) -> int:
        return len(self.active_slots())

    def running_requests(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    # ------------------------------------------------------------------
    # admission (request pulling LSO actuation point)
    # ------------------------------------------------------------------
    def _owed_prefill_blocks(self) -> int:
        """KV blocks committed to mid-prefill slots but not yet allocated."""
        owed = 0
        for i in self.prefilling_slots():
            r = self.slots[i]
            have = len(self.block_mgr.block_table(r.req_id)) \
                if self.block_mgr.has(r.req_id) else 0
            owed += max(self.block_mgr.blocks_needed(r.prompt_len + 1) - have, 0)
        return owed

    def _usable_pins(self, snap) -> Optional[List[int]]:
        """The pinned shared blocks of an eviction snapshot, IF they live in
        THIS engine's current pool (owner + epoch match).  ``[]`` for an
        unshared snapshot; None when the pins belong to another pool."""
        pinned = snap.get("pinned") or []
        if not pinned:
            return []
        if snap.get("pin_owner") is self.block_mgr \
                and snap.get("pin_epoch") == self.block_mgr.epoch:
            return pinned
        return None

    def _discard_snapshot(self, req: Request) -> None:
        """Drop a snapshot, releasing any pins it holds on its SOURCE pool."""
        snap, req.snapshot = req.snapshot, None
        if snap and snap.get("pinned"):
            snap["pin_owner"].release_pins(snap["pinned"], snap["pin_epoch"])

    def _use_chunked(self) -> bool:
        return (self.cfg.prefill_chunk_tokens > 0
                and self.model.prefill_chunk is not None)

    def can_admit(self, req: Request) -> bool:
        if self._free_slot() is None:
            return False
        if req.extras:
            # modality extras ride a single-shot prefill that is not ported
            return False
        snap = req.snapshot
        shared_blocks = 0
        if snap is not None:
            pins = self._usable_pins(snap)
            if pins is None and req.generated > 0:
                # shared blocks pinned in another pool: not resumable here
                return False
            shared_blocks = len(pins or ())
        elif self.prefix_sharing:
            # LIVE indexed chains arrive from the pool, not the free list
            shared_blocks = sum(
                1 for b in self.block_mgr.match_prefix(req.prompt_tokens)
                if self.block_mgr.ref_count(b) >= 1)
        if snap is not None \
                and snap.get("prefill_pos", req.prompt_len) >= req.prompt_len:
            need = snap["length"] + 1
        else:
            need = req.prompt_len + req.generated + 1
        if need > self.cfg.max_seq_len:
            return False
        return self.block_mgr.can_allocate(
            need, reserve_blocks=self._owed_prefill_blocks(),
            shared_blocks=shared_blocks)

    def admit(self, req: Request, extras: Optional[Dict[str, Any]] = None) -> bool:
        """Start prefill for (or snapshot-restore) ``req`` in a free slot.
        On the chunked path admission only reserves the first chunk's KV
        blocks and marks the slot mid-prefill; the compute happens inside
        ``step()``.  An arch without chunked prefill (the SSM) is
        prefilled here, in one call."""
        slot = self._free_slot()
        if slot is None or not self.can_admit(req):
            return False
        if extras or req.extras:
            if self.paged:
                raise ValueError(
                    "paged attention backends have no legacy single-shot "
                    "prefill path (modality extras need a dense backend)")
            raise NotImplementedError(
                "modality extras (the single-shot prefill of a VLM or "
                "enc-dec model) are not ported")
        t0 = self._wall()
        my_layout = "paged" if self.paged else "dense"
        if req.snapshot is not None \
                and req.snapshot.get("layout", "dense") != my_layout:
            # page contents cannot be transplanted across layouts: recompute
            # when nothing was generated yet
            if req.generated == 0:
                self._discard_snapshot(req)
            else:
                raise ValueError(
                    f"cannot resume a {req.snapshot.get('layout', 'dense')} "
                    f"KV snapshot on a {my_layout} engine mid-decode")
        if req.snapshot is not None \
                and self._usable_pins(req.snapshot) is None:
            # shared-prefix blocks still pinned in another pool: recompute
            # when nothing was generated yet
            if req.generated == 0:
                self._discard_snapshot(req)
            else:
                raise ValueError(
                    "cannot resume a live-pinned KV snapshot outside the "
                    "engine that evicted it mid-decode (materialize it "
                    "first: cross-engine migration)")
        if req.snapshot is not None:
            snap = req.snapshot
            length = int(snap["length"])
            ppos = int(snap.get("prefill_pos", req.prompt_len))
            if ppos >= req.prompt_len:
                kv_tokens = int(snap.get("kv_tokens", length + 1))
                alloc_tokens = max(kv_tokens, length + 1)
            else:
                alloc_tokens = int(snap.get("kv_tokens", ppos))
            pinned = self._usable_pins(snap) or []
            if pinned:
                blocks = self.block_mgr.resume_pinned(req.req_id, pinned,
                                                      alloc_tokens)
            else:
                blocks = self.block_mgr.allocate(req.req_id, alloc_tokens)
            self.block_mgr.bind_slot(req.req_id, slot)
            if self.paged:
                self._restore_pages(snap["cache"], blocks,
                                    offset=len(pinned))
            else:
                self._restore_cache(snap["cache"], slot)
            self.lengths[slot] = length
            self.prefill_pos[slot] = ppos
            if snap.get("pin_owner") is not None \
                    and snap.get("pin_owner") is not self.block_mgr:
                self.stats.migrations_in += 1
            req.snapshot = None  # pins were transferred, not released
            self.stats.resumes += 1
            self.slots[slot] = req
        elif self._use_chunked():
            shared: List[int] = []
            if self.prefix_sharing:
                self.stats.prefix_lookups += 1
                shared = self.block_mgr.match_prefix(req.prompt_tokens)
            start = len(shared) * self.cfg.block_size
            first = min(self._chunk_quantum(), req.prompt_len - start)
            if shared:
                self.block_mgr.share_prefix(req.req_id, start + first, shared)
                self.stats.prefix_hits += 1
                self.stats.prefix_shared_blocks += len(shared)
                self.stats.prefix_shared_tokens += start
            else:
                self.block_mgr.allocate(req.req_id, first)
            req.prefix_shared_tokens = start
            self.stats.prompt_tokens_admitted += req.prompt_len
            self.block_mgr.bind_slot(req.req_id, slot)
            self.prefill_pos[slot] = start
            self.lengths[slot] = start
            self.slots[slot] = req
        else:
            # single-shot path (the SSM's state carry).  Compute first: a
            # raising prefill must leave the engine clean.
            tok, cache1 = self._prefill_one(np.asarray(req.prompt_tokens))  # qlint: disable=host-sync-in-hot-path -- host prompt list -> array for the one-shot prefill path
            self.slots[slot] = req
            self._insert_cache(cache1, slot)
            self.lengths[slot] = req.prompt_len
            self.prefill_pos[slot] = req.prompt_len
            self.block_mgr.allocate(req.req_id, req.prompt_len + 1)
            self.block_mgr.bind_slot(req.req_id, slot)
            self._sync()  # the slot's state write: prefill_time feeds the RWT
            now = self.clock()
            if req.first_token_time is None:
                req.first_token_time = now
            req.output_tokens.append(tok)
            req.generated += 1
            self.stats.prefills += 1
            # the chunked path's first-token finish check (EOS on the
            # prefill token, max_new_tokens == 1); may free the slot
            self._finish_if_done(slot, tok, now, self._admit_completed)
        self.stats.prefill_time += self._wall() - t0
        return True

    # ------------------------------------------------------------------
    # eviction LSO
    # ------------------------------------------------------------------
    def evict_slot(self, slot: int) -> Request:
        """Snapshot the slot's private KV pages to host memory and free it;
        shared leading blocks become snapshot pins (not freed, not copied).
        Mid-prefill slots keep their chunk progress."""
        req = self.slots[slot]
        assert req is not None
        kv_tokens = self.block_mgr.seq_tokens(req.req_id) \
            if self.block_mgr.has(req.req_id) else 0
        if self.paged:
            # pending COW copies must land before the snapshot reads pages
            self._apply_cow()
            pinned, private = self.block_mgr.evict_split(req.req_id)
            cache_snap = self._extract_pages(private)
        else:
            pinned = []
            cache_snap = self._extract_cache(slot)
            self.block_mgr.free(req.req_id)
        req.snapshot = {
            "cache": cache_snap,
            "length": int(self.lengths[slot]),
            "prefill_pos": int(self.prefill_pos[slot]),
            "kv_tokens": kv_tokens,
            "layout": "paged" if self.paged else "dense",
            "pinned": pinned,
            "pin_owner": self.block_mgr,
            "pin_epoch": self.block_mgr.epoch,
            "shared_tokens": len(pinned) * self.cfg.block_size,
        }
        req.n_evictions += 1
        if pinned:
            self._pinned_snapshots = [
                r for r in self._pinned_snapshots
                if r.snapshot is not None and r.snapshot.get("pinned")]
            self._pinned_snapshots.append(req)
        self.slots[slot] = None
        self.lengths[slot] = 0
        self.prefill_pos[slot] = 0
        self.stats.evictions += 1
        return req

    def evict_request(self, req_id: int) -> Optional[Request]:
        for i, r in enumerate(self.slots):
            if r is not None and r.req_id == req_id:
                return self.evict_slot(i)
        return None

    def flush(self) -> List[Request]:
        """Evict everything (used before a model swap)."""
        return [self.evict_slot(i) for i in self.active_slots()]

    # ------------------------------------------------------------------
    # cancellation + shedding hooks
    # ------------------------------------------------------------------
    def _cancel_slot(self, slot: int) -> Request:
        """Free a resident slot WITHOUT a snapshot (pending COW copies land
        first, so none can overwrite a page a later admission owns)."""
        req = self.slots[slot]
        assert req is not None, slot
        self._apply_cow()
        self.block_mgr.free(req.req_id)
        self.slots[slot] = None
        self.lengths[slot] = 0
        self.prefill_pos[slot] = 0
        req._in_flight = False
        req.cancelled = True
        if req.completion_time is None:
            req.completion_time = self.clock()
        self.stats.cancellations += 1
        return req

    def cancel_request(self, req: Request) -> bool:
        """Terminate ``req`` wherever it lives in THIS engine: resident slot
        or eviction snapshot.  False when the engine holds no state for it."""
        for i, r in enumerate(self.slots):
            if r is not None and r.req_id == req.req_id:
                self._cancel_slot(i)
                return True
        if req.snapshot is not None:
            self._discard_snapshot(req)
            req.cancelled = True
            if req.completion_time is None:
                req.completion_time = self.clock()
            self.stats.cancellations += 1
            return True
        return False

    def shed_slots(self, should_shed: Callable[[Request], bool],
                   drop: bool = False) -> List[Request]:
        """Evict (``drop=False``) or cancel (``drop=True``) every active slot
        whose request matches ``should_shed``."""
        out: List[Request] = []
        for i in list(self.active_slots()):
            req = self.slots[i]
            if req is None or not should_shed(req):
                continue
            if drop:
                self._cancel_slot(i)
                req.shed = True
            else:
                self.evict_slot(i)
                req._in_flight = False
            self.stats.sheds += 1
            out.append(req)
        return out

    def abandon(self) -> List[Request]:
        """Crash salvage: reclaim every resident request (and the pushback
        limbo) WITHOUT stamping it terminal; host bookkeeping only."""
        out: List[Request] = []
        self.block_mgr._cow_ops.clear()
        for i in self.active_slots():
            req = self.slots[i]
            self.block_mgr.free(req.req_id)
            self.slots[i] = None
            self.lengths[i] = 0
            self.prefill_pos[i] = 0
            req._in_flight = False
            out.append(req)
        pushed = self.take_pushback()
        if pushed is not None:
            pushed._in_flight = False
            out.append(pushed)
        return out

    def _materialize_one(self, req: Request) -> bool:
        """Copy a live pinned snapshot's pinned page CONTENTS into the
        snapshot (before the private tail) and release the pins: the
        snapshot becomes portable."""
        snap = req.snapshot
        if not snap or not snap.get("pinned") \
                or snap.get("pin_owner") is not self.block_mgr \
                or snap.get("pin_epoch") != self.block_mgr.epoch:
            return False
        pinned = snap["pinned"]
        shared_pages = self._extract_pages(pinned)
        snap["cache"] = {name: torch.cat([shared_pages[name], private], dim=1)
                         for name, private in snap["cache"].items()}
        self.block_mgr.release_pins(pinned, snap["pin_epoch"])
        snap["pinned"] = []
        return True

    def materialize_snapshot(self, req: Request) -> bool:
        """Cross-engine migration hook: make ``req``'s snapshot portable."""
        out = self._materialize_one(req)
        if out:
            self.stats.migrations_out += 1
            self._pinned_snapshots = [
                r for r in self._pinned_snapshots
                if r.snapshot is not None and r.snapshot.get("pinned")]
        return out

    def _materialize_pinned_snapshots(self) -> None:
        """Make every still-live pinned snapshot portable (before a pool
        reset kills the pins)."""
        for req in self._pinned_snapshots:
            self._materialize_one(req)
        self._pinned_snapshots = []

    def fork_slot(self, slot: int) -> Optional[Request]:
        raise NotImplementedError("fork_slot is not ported yet")

    # ------------------------------------------------------------------
    # model swapping LSO
    # ------------------------------------------------------------------
    def swap_model(self, model: Model, params, model_name: str) -> List[Request]:
        """Flush, replace the weights and rebuild the cache for the new
        model's shapes (layers, KV heads, head_dim, ``cache_len``, int8;
        an SSM's conv and state)."""
        self._check_layout(model)
        t0 = self._wall()
        evicted = self.flush()
        # swapped-out snapshots belong to the OLD model: drop them
        for r in evicted:
            self._discard_snapshot(r)
        # earlier evictions stay valid: save their pinned pages first
        self._materialize_pinned_snapshots()
        self.model = self._with_tile(model)
        self.params = params
        self.model_name = model_name
        self.cache = self._init_cache()
        self.block_mgr.reset()
        self._bt_device = None
        self._bt_version_seen = -1
        self._sync()
        self.stats.model_swaps += 1
        self.stats.swap_time += self._wall() - t0
        return evicted

    # ------------------------------------------------------------------
    # one iteration
    # ------------------------------------------------------------------
    def take_pushback(self) -> Optional[Request]:
        r, self._pushback = self._pushback, None
        return r

    def _chunk_quantum(self) -> int:
        """Effective chunk size: clamped to the rolling SWA cache length so
        one chunk never writes the same cache slot twice."""
        C = self.cfg.prefill_chunk_tokens
        w = self.model.cfg.sliding_window
        if w is not None:
            C = min(C, min(self.cfg.max_seq_len, w))
        return C

    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.resolved_buckets():
            if n <= b:
                return b
        return n

    def _finish_if_done(self, slot: int, tok: int, now: float,
                        done: List[Request]) -> bool:
        req = self.slots[slot]
        eos = (self.cfg.eos_token is not None and tok == self.cfg.eos_token)
        # the capacity finish fires at max_seq_len (see the reference)
        if eos or req.generated >= req.max_new_tokens \
                or self.lengths[slot] >= self.cfg.max_seq_len:
            req.completion_time = now
            done.append(req)
            self.block_mgr.free(req.req_id)
            self.slots[slot] = None
            self.lengths[slot] = 0
            self.prefill_pos[slot] = 0
            return True
        return False

    def _prefill_chunk_round(self, done: List[Request]) -> None:
        """One chunk of prefill for EVERY mid-prefill slot, batched into one
        call padded to the smallest covering length bucket."""
        work = self.prefilling_slots()
        if not work:
            return
        t0 = self._wall()
        C = self._chunk_quantum()
        chunks: Dict[int, Tuple[np.ndarray, int, bool]] = {}
        for i in work:
            req = self.slots[i]
            pos = int(self.prefill_pos[i])
            n = min(C, req.prompt_len - pos)
            final = pos + n >= req.prompt_len
            need = req.prompt_len + 1 if final else pos + n
            if not self.block_mgr.extend(req.req_id, need):
                # mid-prefill OOM: preempt; the snapshot keeps chunk progress
                self.stats.preemptions += 1
                self.evict_slot(i)
                req._in_flight = False
                continue
            chunk = np.asarray(req.prompt_tokens[pos:pos + n], np.int32)  # qlint: disable=host-sync-in-hot-path -- host prompt slice -> chunk array, no device sync
            chunks[i] = (chunk, n, final)
        if not chunks:
            return
        # COW copies from the extends above land before this dispatch
        self._apply_cow()
        bucket = self._bucket_for(max(n for _, n, _ in chunks.values()))
        tokens = np.zeros((self.cfg.max_slots, bucket), np.int32)
        starts = np.zeros(self.cfg.max_slots, np.int32)
        valid = np.zeros(self.cfg.max_slots, np.int32)
        for i, (chunk, n, _) in chunks.items():
            tokens[i, :n] = chunk
            starts[i] = self.prefill_pos[i]
            valid[i] = n
        if self.paged:
            # the table is refreshed AFTER the extends above
            logits, self.cache = self.model.prefill_chunk_paged(
                self.params, self.cache, self._to_device(tokens),
                self._to_device(starts), self._to_device(valid),
                self._device_block_table())
        else:
            logits, self.cache = self.model.prefill_chunk(
                self.params, self.cache, self._to_device(tokens),
                self._to_device(starts), self._to_device(valid))
        toks_out = torch.argmax(logits, dim=-1).cpu().numpy()
        self._sync()  # the cache writes too: prefill_time feeds the RWT
        self.stats.prefill_chunks += 1
        now = self.clock()
        for i, (_, n, final) in chunks.items():
            req = self.slots[i]
            self.prefill_pos[i] += n
            self.lengths[i] = self.prefill_pos[i]
            if self.prefix_sharing:
                self.block_mgr.register_prefix(
                    req.req_id, req.prompt_tokens, int(self.prefill_pos[i]))
            if final:
                tok = int(toks_out[i])
                if req.first_token_time is None:
                    req.first_token_time = now
                req.output_tokens.append(tok)
                req.generated += 1
                self.stats.prefills += 1
                self._finish_if_done(i, tok, now, done)
        self.stats.prefill_time += self._wall() - t0

    def _last_tokens(self, active: List[int]) -> np.ndarray:
        tokens = np.zeros(self.cfg.max_slots, np.int32)
        for i in active:
            r = self.slots[i]
            tokens[i] = r.output_tokens[-1] if r.output_tokens \
                else r.prompt_tokens[-1]
        return tokens

    def _decode_step(self, tokens: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot on this engine's layout; returns
        the logits, the cache updated in place."""
        if self.paged:
            logits, self.cache = self.model.decode_step_paged(
                self.params, self.cache, tokens, lengths,
                self._device_block_table())
        else:
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, tokens, lengths)
        return logits

    def _decode_round(self, done: List[Request]) -> None:
        active = self.decode_slots()
        if not active:
            return
        t0 = self._wall()
        # pending COW copies land before this dispatch writes their pages
        self._apply_cow()
        logits = self._decode_step(self._to_device(self._last_tokens(active)),
                                   self._to_device(self.lengths))
        next_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        self._sync()
        self.stats.decode_iterations += 1
        self.stats.decode_time += self._wall() - t0

        now = self.clock()
        for i in active:
            req = self.slots[i]
            # record the token FIRST: its KV is already written
            self.lengths[i] += 1
            tok = int(next_tokens[i])
            req.output_tokens.append(tok)
            req.generated += 1
            self.stats.tokens_generated += 1
            if req.first_token_time is None:
                req.first_token_time = now
            if self._finish_if_done(i, tok, now, done):
                continue
            # reserve the NEXT decode step's KV slot; preempt on OOM
            if not self.block_mgr.append_token(req.req_id):
                self.stats.preemptions += 1
                self.evict_slot(i)
                req._in_flight = False

    def _plan_burst(self, active: List[int], k: int) -> int:
        """Largest burst width n <= k whose KV writes the pool can cover now
        (each slot extended to ``lengths + min(n, rem) + 1`` tokens, capped
        at max_seq_len, plus one block per shared tail that must COW).
        Returns 0 when not even n=2 fits: the single-step round then owns
        the pool-exhaustion endgame.  The width is then capped at the
        largest ``rem``: after that many iterations every slot has
        exhausted ``max_new_tokens`` or ``max_seq_len``, so the burst needs
        no device-side check for all slots finished."""
        rem, cur = {}, {}
        cow_extra = 0
        for i in active:
            r = self.slots[i]
            rem[i] = min(r.max_new_tokens - r.generated,
                         self.cfg.max_seq_len - int(self.lengths[i]))
            cur[i] = len(self.block_mgr.block_table(r.req_id))
            if self.prefix_sharing \
                    and self.block_mgr.append_needs_cow(r.req_id):
                cow_extra += 1

        def blocks_short(n: int) -> int:
            need = cow_extra
            for i in active:
                tokens = min(int(self.lengths[i]) + min(n, rem[i]) + 1,
                             self.cfg.max_seq_len)
                need += max(self.block_mgr.blocks_needed(tokens) - cur[i], 0)
            return need

        n = max(k, 0)
        free = self.block_mgr.free_blocks
        while n > 1 and blocks_short(n) > free:
            n -= 1
        if n <= 1:
            return 0
        n = min(n, max(rem.values()))
        for i in active:
            tokens = min(int(self.lengths[i]) + min(n, rem[i]) + 1,
                         self.cfg.max_seq_len)
            ok = self.block_mgr.extend(self.slots[i].req_id, tokens)
            assert ok, (i, tokens)  # blocks_short(n) <= free guarantees it
        return n

    def _decode_burst(self, n: int, tokens: torch.Tensor,
                      lengths: torch.Tensor, remaining: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
        """``n`` decode iterations with the argmax, length increments and
        EOS / max-token / max-seq-len finish flags all on the device, with
        no host sync (the reference's ``lax.while_loop``, which also stops
        once every slot retired: here ``_plan_burst`` caps ``n`` so that
        only EOS can retire every slot early, and the iterations after it
        emit nothing).  Returns the (decode_burst, max_slots) token buffer,
        -1 where a slot was inactive.  Finished slots keep rewriting their
        final token's k/v at their frozen position — idempotent, and their
        pages are freed at the host sync."""
        K = max(int(self.cfg.decode_burst), 1)
        out = torch.full((K, self.cfg.max_slots), -1, dtype=torch.int32,
                         device=self.device)
        eos = self.cfg.eos_token
        for i in range(n):
            logits = self._decode_step(tokens, lengths)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            produced = torch.where(active, nxt, tokens)
            out[i] = torch.where(active, nxt, -1)
            step = active.to(torch.int32)
            lengths = lengths + step
            remaining = remaining - step
            fin = (remaining <= 0) | (lengths >= self.cfg.max_seq_len)
            if eos is not None:
                fin = fin | (produced == eos)
            tokens = produced
            active = active & ~fin
        return out

    def _decode_burst_round(self, done: List[Request], k: int) -> None:
        """Fused decode: up to ``k`` decode iterations per host round trip,
        then replay the per-token bookkeeping from the token buffer.
        Token-identical to running ``_decode_round`` k times."""
        active = self.decode_slots()
        if not active:
            return
        n = self._plan_burst(active, min(k, max(self.cfg.decode_burst, 1)))
        if n == 0:
            self._decode_round(done)
            return
        t0 = self._wall()
        self._apply_cow()
        remaining = np.zeros(self.cfg.max_slots, np.int32)
        active_mask = np.zeros(self.cfg.max_slots, bool)
        for i in active:
            r = self.slots[i]
            remaining[i] = r.max_new_tokens - r.generated
            active_mask[i] = True
        out = self._decode_burst(
            n, self._to_device(self._last_tokens(active)),
            self._to_device(self.lengths), self._to_device(remaining),
            self._to_device(active_mask))
        out = out.cpu().numpy()
        self._sync()
        executed = int((out >= 0).any(axis=1).sum())
        self.stats.decode_iterations += executed
        self.stats.decode_time += self._wall() - t0

        now = self.clock()
        for i in active:
            req = self.slots[i]
            for j in range(executed):
                tok = int(out[j, i])
                if tok < 0:
                    break  # slot went inactive on device at iteration j
                self.lengths[i] += 1
                req.output_tokens.append(tok)
                req.generated += 1
                self.stats.tokens_generated += 1
                if req.first_token_time is None:
                    req.first_token_time = now
                if self._finish_if_done(i, tok, now, done):
                    break
            else:
                # survived the whole burst: the up-front reservation left
                # exactly the single-step invariant (lengths + 1 tokens)
                assert self.block_mgr.seq_tokens(req.req_id) \
                    == int(self.lengths[i]) + 1

    def _admit_from_pull(self) -> None:
        """Request pulling: admit while capacity allows; a refused request
        is handed back to the virtual-queue owner via take_pushback()."""
        if self.pull_source is None:
            return
        while self._free_slot() is not None:
            req = self.pull_source()
            if req is None:
                break
            if not self.admit(req):
                # pool-pressure valve: materialize accumulated pinned
                # snapshots, then retry once before pushing back
                if self._pinned_snapshots:
                    self._materialize_pinned_snapshots()
                    if self.admit(req):
                        continue
                self._pushback = req
                break

    def step(self) -> List[Request]:
        """Admit from the pull source, run one prefill chunk round, then one
        decode iteration.  Returns requests completed this step."""
        self._admit_from_pull()
        done: List[Request] = []
        self._prefill_chunk_round(done)
        self._decode_round(done)
        admit_done, self._admit_completed = self._admit_completed, []
        self._check_invariants()
        return admit_done + done

    def steps(self, k: Optional[int] = None) -> List[Request]:
        """Like ``step()`` but the decode side runs up to ``k`` iterations
        (default ``cfg.decode_burst``) per host round trip; single-step
        whenever a slot is mid-prefill or the pool is at the preemption
        edge."""
        k = self.cfg.decode_burst if k is None else k
        if k <= 1:
            return self.step()
        self._admit_from_pull()
        done: List[Request] = []
        if self.prefilling_slots():
            self._prefill_chunk_round(done)
            self._decode_round(done)
        else:
            self._decode_burst_round(done, k)
        admit_done, self._admit_completed = self._admit_completed, []
        self._check_invariants()
        return admit_done + done

    # ------------------------------------------------------------------
    # runtime invariant checking (repro_torch.analysis.invariants)
    # ------------------------------------------------------------------
    _inv_sampler = None

    def _check_invariants(self) -> None:
        if not self.cfg.debug_invariants:
            from repro_torch.analysis.invariants import invariants_enabled
            if not invariants_enabled():
                return
        if self._inv_sampler is None:
            from repro_torch.analysis.invariants import InvariantSampler
            self._inv_sampler = InvariantSampler()
        if self._inv_sampler.due():
            from repro_torch.analysis.invariants import check_engine
            check_engine(self, where=f"engine:{self.model_name}/round")

    # ------------------------------------------------------------------
    # profiling (feeds the RWT estimator)
    # ------------------------------------------------------------------
    def profile(self, prompts: List[np.ndarray],
                max_new_tokens: int = 32) -> Dict[str, float]:
        """Run one batch (paper §6 "Hardware Profiling") and return
        {prefill_time P, decode_per_token d, throughput theta}."""
        reqs = [Request(prompt_tokens=p, model=self.model_name, slo=1e9,
                        max_new_tokens=max_new_tokens) for p in prompts]
        s = self.stats
        pf0, dt0, it0, tok0 = (s.prefill_time, s.decode_time,
                               s.decode_iterations, s.tokens_generated)
        for r in reqs:
            if not self.admit(r):
                break
        n_admitted = self.num_active()
        while self.num_active() > 0:
            self.steps()
        self._sync()
        prefill_t = s.prefill_time - pf0
        decode_t = s.decode_time - dt0
        iters = s.decode_iterations - it0
        tokens = s.tokens_generated - tok0
        return {
            "prefill_time": prefill_t / max(n_admitted, 1),
            "decode_per_token": decode_t / max(iters, 1),
            "throughput": tokens / max(decode_t, 1e-9),
            "batch_size": float(n_admitted),
        }
