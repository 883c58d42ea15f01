"""Discrete-event cluster simulator for paper-scale experiments.

Token-granular continuous batching: every instance iteration generates one
token for each running sequence and lasts ``d`` seconds (+ prefill cost
``P`` on iterations that admitted new work, + swap cost ``S`` when the
agent switches models).  KV memory is tracked per token against the
device's ``token_capacity``; overflow preempts the newest sequence
(vLLM semantics).  Eviction and swap follow the same LSO rules as the real
engine's ``QLMAgent`` — the simulator and engine share the QLM core
(groups / virtual queues / RWT / global scheduler) verbatim.

Execution semantics honor ``PolicyTraits``:
  * ``continuous_batching=False`` (SHEPHERD): admissions only into an empty
    batch; the batch runs to completion (fixed batching);
  * ``uses_eviction`` / ``plans_swaps`` gate the corresponding LSOs.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.policies import PolicyTraits, make_policy
from repro_torch.core.qlm import QLMConfig, QLMController
from repro_torch.core.request import Request
from repro_torch.core.request_group import RequestGroup
from repro_torch.core.rwt_estimator import HardwareProfile
from repro_torch.core.virtual_queue import VirtualQueue


@dataclasses.dataclass
class SimSeq:
    req: Request
    kv_tokens: int          # prompt + generated so far
    remaining: int          # output tokens still to generate (ground truth)
    prefill_remaining: int = 0  # prompt tokens not yet prefilled (chunked mode)


@dataclasses.dataclass
class SimStats:
    iterations: int = 0
    prefill_rounds: int = 0
    swaps: int = 0
    evictions: int = 0
    preemptions: int = 0
    busy_time: float = 0.0
    swap_time: float = 0.0
    tokens: int = 0


class SimInstance:
    def __init__(self, instance_id: int,
                 hw_by_model: Dict[str, HardwareProfile],
                 traits: PolicyTraits,
                 max_batch_requests: int = 256):
        self.id = instance_id
        self.hw_by_model = hw_by_model
        self.traits = traits
        self.max_batch = max_batch_requests
        self.vq = VirtualQueue(instance_id)
        self.loaded_model: Optional[str] = None
        self.running: List[SimSeq] = []
        self.kv_used = 0
        self.stats = SimStats()
        self.busy_until = 0.0
        self.scheduled = False  # an 'iter' event is in flight
        self._last_head: Optional[int] = None  # eviction fires on head CHANGE (§5)

    # ------------------------------------------------------------------
    def info(self) -> InstanceInfo:
        return InstanceInfo(instance_id=self.id, hw_by_model=self.hw_by_model,
                            current_model=self.loaded_model,
                            virtual_queue=self.vq)

    def hw(self) -> Optional[HardwareProfile]:
        if self.loaded_model is None:
            return None
        return self.hw_by_model[self.loaded_model]

    def capacity(self) -> int:
        hw = self.hw()
        return hw.token_capacity if hw else 0

    # ------------------------------------------------------------------
    def _evict_seq(self, seq: SimSeq, *, preempted: bool = False) -> None:
        """Back into its group's pending set; progress (generated) kept —
        the KV snapshot lives in host memory (eviction LSO).  Mid-prefill
        chunk progress is kept too, mirroring the engine's
        ``snapshot["prefill_pos"]`` resume (no recompute)."""
        self.running.remove(seq)
        self.kv_used -= seq.kv_tokens
        seq.req._prefill_done = seq.req.prompt_len - seq.prefill_remaining
        seq.req._in_flight = False
        seq.req.n_evictions += 1
        if preempted:
            self.stats.preemptions += 1
        else:
            self.stats.evictions += 1

    def _agent_sync(self, now: float) -> float:
        """LSO actuation (mirrors core.lso.QLMAgent.sync). Returns extra
        time consumed (model swap)."""
        head = self.vq.head_group()
        if head is None:
            return 0.0
        extra = 0.0
        if head.model != self.loaded_model:
            if self.loaded_model is None:
                # cold instance: load the model (always allowed)
                self.loaded_model = head.model
                extra += self.hw_by_model[head.model].swap_time
                self.stats.swaps += 1
            elif self.traits.plans_swaps or not self.running:
                # swap LSO: flush + load (baselines only swap when idle —
                # they don't plan swaps, matching "swap on demand")
                for seq in list(self.running):
                    self._evict_seq(seq)
                self.loaded_model = head.model
                extra += self.hw_by_model[head.model].swap_time
                self.stats.swaps += 1
        head_changed = head.group_id != self._last_head
        self._last_head = head.group_id
        if self.traits.uses_eviction and head.model == self.loaded_model \
                and head_changed:
            # §5: eviction fires when the global scheduler CHANGES the head
            # group (an RWT-detected violation put a tighter group first);
            # evicting on mere blockage thrashes an underloaded system.
            first = head.next_pending()
            if first is not None:
                need = first.prompt_len + first.generated + 1
                blocked = (self.kv_used + need > self.capacity()
                           or len(self.running) >= self.max_batch)
                if blocked:
                    for seq in sorted(
                            (s for s in self.running
                             if s.req.group_id != head.group_id),
                            key=lambda s: -s.req.slo):  # loosest SLO first
                        self._evict_seq(seq)
                        if self.kv_used + need <= self.capacity() and \
                                len(self.running) < self.max_batch:
                            break
        self.stats.swap_time += extra
        return extra

    def _admit(self, now: float) -> Tuple[int, int]:
        """Request pulling LSO: FCFS within the head group.
        Returns (n_admitted, prompt_tokens_admitted)."""
        if not self.traits.continuous_batching and self.running:
            return 0, 0  # fixed batching (SHEPHERD)
        admitted = 0
        prompt_tokens = 0
        while len(self.running) < self.max_batch:
            req = self.vq.next_request(self.loaded_model)
            if req is None:
                break
            fresh = req.generated == 0  # eviction resume restores KV, no prefill
            # shared-prefix cache hits (ground truth, like
            # true_output_tokens): the leading run neither occupies new KV
            # (it rides the shared chain) nor runs prefill compute.  Only
            # first admissions benefit; a resume restores its snapshot.
            shared = 0
            if fresh:
                shared = min(max(getattr(req, "prefix_shared_tokens", 0), 0),
                             max(req.prompt_len - 1, 0))
            need = req.prompt_len + req.generated + 1 - shared
            if self.kv_used + need > self.capacity():
                break
            req._in_flight = True
            rem = max((req.true_output_tokens or req.max_new_tokens) - req.generated, 1)
            pre = 0
            if fresh and self.traits.prefill_chunk_tokens:
                # mid-prefill evictions resume from their snapshot progress
                # (which already covers the shared run — don't double-count)
                done = max(getattr(req, "_prefill_done", 0), shared)
                pre = max(req.prompt_len - done, 0)
            self.running.append(SimSeq(req, kv_tokens=need - 1, remaining=rem,
                                       prefill_remaining=pre))
            self.kv_used += need - 1
            admitted += 1
            if fresh:
                prompt_tokens += req.prompt_len - shared
        return admitted, prompt_tokens

    def iteration(self, now: float) -> Tuple[float, List[Request]]:
        """Run one serve-loop quantum starting at ``now``.
        Returns (finish_time, completed_requests)."""
        extra = self._agent_sync(now)
        admitted, prompt_tokens = self._admit(now + extra)
        hw = self.hw()
        if hw is None or not self.running:
            self.busy_until = now + extra
            return self.busy_until, []
        # per-model quantum: the engine clamps its chunk to the model's
        # sliding window (engine._chunk_quantum); HardwareProfile carries
        # the window and owns the clamp (hw.chunk_quantum) so sim chunk
        # counts match the engine for SWA models
        chunk = self.traits.prefill_chunk_tokens
        if chunk:
            chunk = hw.chunk_quantum(chunk)
        dur = extra
        if chunk:
            # chunked prefill (mirrors the real engine's step()): every
            # mid-prefill sequence advances by at most ``chunk`` prompt
            # tokens this iteration, THEN decode runs for the sequences that
            # are prefill-complete — like the engine, a sequence finishing
            # its final chunk decodes in the same quantum.
            processed = 0
            for seq in self.running:
                if seq.prefill_remaining > 0:
                    n = min(chunk, seq.prefill_remaining)
                    seq.prefill_remaining -= n
                    processed += n
            if processed:
                dur += hw.prefill_time * (processed / 1024.0)
                self.stats.prefill_rounds += 1
            if any(s.prefill_remaining == 0 for s in self.running):
                # the engine's decode round is a no-op while every running
                # sequence is still mid-prefill — don't charge d for it.
                # Chunk-interleaved iterations dispatch single-step (the
                # engine's burst fallback), so no dispatch amortization.
                dur += hw.decode_seconds(1 if processed else None)
        else:
            # burst-amortized per-iteration cost: the engine fuses
            # decode_burst iterations per dispatch, so the per-dispatch
            # host overhead is charged once per burst, not once per token
            dur += hw.decode_seconds()
            if admitted:
                # lump accounting: prefill cost scales with admitted PROMPT
                # tokens (the paper's §6 observation: per-input-token cost
                # ≈ 100x below per-output-token cost; hw.prefill_time is per
                # 1k prompt tokens)
                dur += hw.prefill_time * (prompt_tokens / 1024.0)
                self.stats.prefill_rounds += 1
        end = now + dur
        completed: List[Request] = []
        for seq in list(self.running):
            if seq.prefill_remaining > 0:
                continue  # still prefilling: no decode token this iteration
            seq.kv_tokens += 1
            self.kv_used += 1
            seq.remaining -= 1
            seq.req.generated += 1
            self.stats.tokens += 1
            if seq.req.first_token_time is None:
                seq.req.first_token_time = end
            if seq.remaining <= 0:
                seq.req.completion_time = end
                seq.req._in_flight = False
                self.running.remove(seq)
                self.kv_used -= seq.kv_tokens
                completed.append(seq.req)
        # KV overflow: preempt newest (vLLM recompute/preempt semantics)
        while self.kv_used > self.capacity() and self.running:
            self._evict_seq(self.running[-1], preempted=True)
        self.stats.iterations += 1
        self.stats.busy_time += dur
        self.busy_until = end
        return end, completed

    def has_work(self) -> bool:
        return bool(self.running) or self.vq.pending_requests() > 0


# ---------------------------------------------------------------------------

class ClusterSimulator:
    def __init__(self, instance_profiles: Sequence[Dict[str, HardwareProfile]],
                 policy_name: str = "qlm", *, qlm_cfg: Optional[QLMConfig] = None,
                 max_batch_requests: int = 256, seed: int = 0,
                 traits_override: Optional[Dict] = None):
        self.policy = make_policy(policy_name)
        traits = self.policy.traits
        if traits_override:
            traits = dataclasses.replace(traits, **traits_override)
        if traits.prefill_chunk_tokens:
            # keep the RWT hardware model coherent with the execution model:
            # chunk-interleaved prefill changes both the iteration schedule
            # AND the estimator's prefill term (hw.prefill_seconds)
            instance_profiles = [
                {m: dataclasses.replace(
                    hw, prefill_chunk_tokens=traits.prefill_chunk_tokens)
                 for m, hw in prof.items()}
                for prof in instance_profiles]
        # SHEPHERD's waiting over-estimation: scale its view of drain times
        self.instances = [
            SimInstance(i, prof, traits, max_batch_requests)
            for i, prof in enumerate(instance_profiles)]
        self.traits = traits
        self.controller: Optional[QLMController] = None
        if traits.name == "qlm":
            self.controller = QLMController(
                [inst.info() for inst in self.instances],
                cfg=qlm_cfg, seed=seed)
            if not traits.reorders:  # fig11/14 ablation: pulling only
                self.controller.cfg = dataclasses.replace(
                    self.controller.cfg, reschedule_on_arrival=False)
        self._groups: List[RequestGroup] = []   # baseline-managed groups
        self.completed: List[Request] = []
        self.now = 0.0

    # ------------------------------------------------------------------
    def _infos(self) -> List[InstanceInfo]:
        return [inst.info() for inst in self.instances]

    def _on_arrival(self, req: Request) -> None:
        if self.controller is not None:
            # keep controller instance views fresh (loaded models change)
            self.controller.instances = self._infos()
            self.controller.submit(req, self.now)
            return
        # baselines: singleton group, incremental placement
        g = RequestGroup(model=req.model, slo=req.slo)
        g.add(req)
        self._groups.append(g)
        name = self.traits.name
        if name == "shepherd":
            models = sorted({x.model for x in self._groups})
            candidates = self._shepherd_subset(req.model, models)
        else:
            candidates = self.instances
        inst = min(candidates, key=lambda i: i.vq.pending_requests())
        if name == "vllm":
            inst.vq.groups.append(g)
        else:  # edf & shepherd: deadline-sorted insert
            idx = 0
            q = inst.vq.groups
            while idx < len(q) and q[idx].earliest_deadline() <= g.earliest_deadline():
                idx += 1
            q.insert(idx, g)

    def _shepherd_subset(self, model: str, models: List[str]) -> List[SimInstance]:
        n_inst = len(self.instances)
        i = models.index(model)
        lo = (i * n_inst) // len(models)  # qlint: disable=unguarded-div -- models contains `model` (index above raised otherwise), so non-empty
        hi = max(lo + 1, ((i + 1) * n_inst) // len(models))  # qlint: disable=unguarded-div -- same: models proven non-empty by .index
        return self.instances[lo:hi]

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], *,
            max_sim_time: float = 1e7) -> Dict[str, float]:
        counter = itertools.count()
        heap: List[Tuple[float, int, str, object]] = []
        for r in requests:
            heapq.heappush(heap, (r.arrival_time, next(counter), "arrival", r))

        def schedule_inst(inst: SimInstance, t: float):
            if not inst.scheduled:
                inst.scheduled = True
                heapq.heappush(heap, (max(t, inst.busy_until),
                                      next(counter), "iter", inst))

        n_total = len(requests)
        while heap and len(self.completed) < n_total:
            t, _, kind, payload = heapq.heappop(heap)
            if t > max_sim_time:
                break
            self.now = t
            if kind == "arrival":
                self._on_arrival(payload)
                for inst in self.instances:
                    if inst.has_work():
                        schedule_inst(inst, t)
            else:
                inst = payload
                inst.scheduled = False
                n_running_before = len(inst.running)
                end, done = inst.iteration(t)
                self.completed.extend(done)
                # Only reschedule on PROGRESS (time advanced or a live batch);
                # an instance whose queued groups are entirely in flight
                # elsewhere would otherwise spin at constant sim time.
                progressed = end > t or inst.running or done
                if inst.has_work() and progressed:
                    schedule_inst(inst, end)
                if done:
                    if self.controller is not None:
                        self.controller.gc_groups()
                    # completions can unblock other instances' head groups
                    for other in self.instances:
                        if other is not inst and other.has_work():
                            schedule_inst(other, end)

        return self.metrics(requests)

    # ------------------------------------------------------------------
    def metrics(self, requests: Sequence[Request]) -> Dict[str, float]:
        done = [r for r in requests if r.finished()]
        with_ttft = [r for r in requests if r.ttft() is not None]
        makespan = max((r.completion_time for r in done), default=0.0)
        first_arrival = min((r.arrival_time for r in requests), default=0.0)
        span = max(makespan - first_arrival, 1e-9)
        slo_ok = [r for r in with_ttft if r.slo_met()]
        util = sum(i.stats.busy_time for i in self.instances) / (
            len(self.instances) * span)
        return {
            "policy": self.traits.name,
            "n_requests": float(len(requests)),
            "completed": float(len(done)),
            "slo_attainment": len(slo_ok) / max(len(requests), 1),
            "throughput_rps": len(done) / span,
            "token_throughput": sum(i.stats.tokens for i in self.instances) / span,
            "makespan": makespan,
            "device_utilization": util,
            "evictions": float(sum(i.stats.evictions for i in self.instances)),
            "preemptions": float(sum(i.stats.preemptions for i in self.instances)),
            "swaps": float(sum(i.stats.swaps for i in self.instances)),
            "mean_ttft": (sum(r.ttft() for r in with_ttft) / len(with_ttft))
                          if with_ttft else float("inf"),
            "mean_itl": (sum(r.itl() for r in done) / len(done))
                         if done else float("inf"),
        }
