"""Request Waiting Time (RWT) Estimator — paper §6 and Appendix A.1.

    C_q = W_q + P + D_q                                  (Eq. 1)
    W_q = Σ_{i<q} O_i / Θ                                (Eq. 2)
    Σ O_i ~ N((q−1)μ_o, (q−1)σ_o²)                       (Eq. 3, CLT)
    D_q = O_max · ε · d                                  (Eq. 4, conservative)
    C   = max_q C_q                                      (Eq. 5)

with the Appendix A.1 throughput model:

    Θ = B / (d · ε)          (Eq. 15)
    B ≈ GPU / E[I_i + O_i]   (Eq. 16)

Profiling inputs (paper "Offline Profiling"): a WorkloadProfile (token
distribution fitted from request history per request group) and a
HardwareProfile (P, d, ε, GPU token capacity, swap time S — one batch run
per (model, device) combination; see ``serving.engine.profile`` /
``sim.profiles``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Input/output token distribution for one request group."""
    mu_input: float
    sigma_input: float
    mu_output: float
    sigma_output: float

    @staticmethod
    def fit(input_lens: Sequence[float], output_lens: Sequence[float]) -> "WorkloadProfile":
        import numpy as np
        i = np.asarray(input_lens, float)
        o = np.asarray(output_lens, float)
        return WorkloadProfile(float(i.mean()), float(i.std() + 1e-9),
                               float(o.mean()), float(o.std() + 1e-9))


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Per (model, device-type) constants from one profiling batch run."""
    # P: prefill seconds per 1k prompt tokens (the simulator and
    # prefill_seconds() charge it as a rate); used as-is as the constant
    # per-admission term when no prompt length is supplied (§6's "≈ constant
    # per model" reading, i.e. a ~1k-token prompt).
    prefill_time: float
    decode_per_token: float      # d seconds per decode iteration
    inefficiency: float          # ε ≥ 1, continuous-batching preemption factor
    token_capacity: int          # GPU — total KV tokens the device holds
    swap_time: float = 0.0       # S — model load time onto this device
    model_max_tokens: int = 2048  # decode bound for Eq. 4
    # Chunked-prefill quantum of the serving instance (None = single-shot
    # lump prefill).  With chunking, a prompt of I tokens occupies
    # ceil(I / chunk) iterations that each also run a decode step, so the
    # prefill term of C_q grows by that interleaving overhead.
    prefill_chunk_tokens: Optional[int] = None
    # Sliding-window width of the model served on this profile (None = full
    # attention).  The real engine clamps its chunk quantum to the window
    # (engine._chunk_quantum: a single chunk must never write the same
    # rolling cache slot twice); carrying the window here lets the
    # simulator and the RWT prefill term charge the SAME per-model chunk
    # counts instead of one approximate quantum per policy.
    sliding_window: Optional[int] = None
    # Fused multi-step decode width of the serving instance
    # (EngineConfig.decode_burst): the engine dispatches up to this many
    # decode iterations per host round-trip, so the per-dispatch host
    # overhead below amortizes across the burst instead of being charged
    # per token.
    decode_burst: int = 1
    # Host + dispatch seconds per fused decode dispatch (the
    # host_overhead_fraction engine_bench.py measures, in absolute terms).
    # 0 folds it into decode_per_token (the pre-burst reading).
    dispatch_overhead: float = 0.0

    def decode_seconds(self, burst: Optional[int] = None) -> float:
        """Effective seconds per decode ITERATION: pure per-token compute
        ``d`` plus the per-dispatch host overhead amortized over the burst
        width (``burst`` overrides ``self.decode_burst``; chunk-interleaved
        iterations run single-step, so they pass 1)."""
        b = max(burst if burst is not None else self.decode_burst, 1)
        return self.decode_per_token + self.dispatch_overhead / b

    def chunk_quantum(self, quantum: Optional[int] = None) -> Optional[int]:
        """Effective per-model chunked-prefill quantum (mirrors the
        engine's sliding-window clamp); None = lump prefill.

        ``quantum`` overrides ``self.prefill_chunk_tokens`` as the
        unclamped quantum (the simulator passes the policy's value so the
        clamp lives in ONE place).  ``sliding_window`` is expected to be
        pre-capped at the engine's max_seq_len by its producer
        (``calibrate_from_engine`` does this).
        """
        c = quantum if quantum is not None else self.prefill_chunk_tokens
        if c and self.sliding_window is not None:
            return min(c, self.sliding_window)
        return c

    def prefill_seconds(self, prompt_tokens: Optional[float] = None,
                        effective_prompt_tokens: Optional[float] = None) -> float:
        """Prefill term P for one request.

        Without ``prompt_tokens`` this is the paper's constant P.  With it,
        P scales per-1k-prompt-tokens (matching the simulator's accounting)
        and, when the instance prefills in chunks, adds one interleaved
        decode iteration per chunk (window-clamped via ``chunk_quantum``).

        ``effective_prompt_tokens`` is the portion that actually runs
        prefill compute once shared-prefix KV cache hits are subtracted
        (engine: chunked prefill starts at the first unshared token) — the
        rate AND the chunk count both scale with it, so waiting-time
        estimates reflect cache hits.  Defaults to ``prompt_tokens``
        (no sharing).  Chunk-interleaved decode iterations dispatch
        single-step, hence ``decode_seconds(burst=1)``.
        """
        if prompt_tokens is None:
            return self.prefill_time
        eff = effective_prompt_tokens if effective_prompt_tokens is not None \
            else prompt_tokens
        eff = min(max(eff, 0.0), prompt_tokens)
        t = self.prefill_time * (eff / 1024.0)
        chunk = self.chunk_quantum()
        if chunk:
            n_chunks = math.ceil(max(eff, 1.0) / chunk)
            t += n_chunks * self.decode_seconds(burst=1)
        return t

    def batch_size(self, wl: WorkloadProfile) -> float:
        """Eq. 16: B ≈ GPU / E[I + O]."""
        return self.token_capacity / max(wl.mu_input + wl.mu_output, 1.0)

    def throughput(self, wl: WorkloadProfile) -> float:
        """Eq. 15: Θ = B / (d · ε) output tokens per second, with d the
        burst-amortized per-iteration cost (``decode_seconds``)."""
        return self.batch_size(wl) / (self.decode_seconds() * self.inefficiency)


@dataclasses.dataclass(frozen=True)
class WaitEstimate:
    mean: float
    std: float

    def conservative(self, z: float = 1.0) -> float:
        return self.mean + z * self.std


class RWTEstimator:
    """Stateless estimator; all state arrives via the profiles."""

    def __init__(self, z_conservative: float = 1.0):
        self.z = z_conservative

    # -- Eq. 2/3: waiting time for a request at queue position q ----------
    def waiting_time(self, queue_position: int, wl: WorkloadProfile,
                     hw: HardwareProfile) -> WaitEstimate:
        q_ahead = max(queue_position, 0)
        theta = hw.throughput(wl)
        mean = q_ahead * wl.mu_output / theta
        std = math.sqrt(q_ahead) * wl.sigma_output / theta
        return WaitEstimate(mean, std)

    # -- Eq. 4: conservative decode bound ---------------------------------
    def decode_time(self, hw: HardwareProfile,
                    max_output_tokens: Optional[int] = None) -> float:
        o = max_output_tokens if max_output_tokens is not None else hw.model_max_tokens
        return o * hw.inefficiency * hw.decode_seconds()

    # -- Eq. 1/5: completion bound for a request / group ------------------
    def request_completion(self, queue_position: int, wl: WorkloadProfile,
                           hw: HardwareProfile,
                           max_output_tokens: Optional[int] = None,
                           prompt_tokens: Optional[float] = None,
                           effective_prompt_tokens: Optional[float] = None
                           ) -> WaitEstimate:
        """Eq. 1/5.  ``prompt_tokens`` (e.g. ``wl.mu_input``) switches the
        prefill term from the constant P to the token-scaled,
        chunk-interleaving-aware estimate (``hw.prefill_seconds``);
        ``effective_prompt_tokens`` further subtracts shared-prefix cache
        hits from the prefill work (engine skips prefill for cached full
        blocks)."""
        w = self.waiting_time(queue_position, wl, hw)
        extra = hw.prefill_seconds(prompt_tokens, effective_prompt_tokens) \
            + self.decode_time(hw, max_output_tokens)
        return WaitEstimate(w.mean + extra, w.std)

    def group_drain_time(self, n_requests: int, wl: WorkloadProfile,
                         hw: HardwareProfile,
                         prompt_tokens: Optional[float] = None,
                         effective_prompt_tokens: Optional[float] = None
                         ) -> WaitEstimate:
        """Eq. 5 over a whole request group: the LAST request's completion.

        The group's total output tokens ~ N(nμ_o, nσ_o²); drain = tokens/Θ,
        plus the conservative tail decode for the final request.
        ``prompt_tokens`` (the group's μ_input) makes the prefill term
        token-scaled and chunk-interleaving-aware (``hw.prefill_seconds``);
        ``effective_prompt_tokens`` (the group's μ_input net of expected
        prefix-cache hits — request groups share prompt templates, so the
        hit rate is per-group) shrinks it accordingly.
        """
        theta = hw.throughput(wl)
        mean = n_requests * wl.mu_output / theta
        std = math.sqrt(max(n_requests, 1)) * wl.sigma_output / theta
        return WaitEstimate(
            mean + hw.prefill_seconds(prompt_tokens, effective_prompt_tokens),
            std)

    def group_first_token_time(self, n_ahead_tokens: float,
                               wl: WorkloadProfile, hw: HardwareProfile,
                               prompt_tokens: Optional[float] = None,
                               effective_prompt_tokens: Optional[float] = None
                               ) -> float:
        """TTFT for a group whose predecessors hold ``n_ahead_tokens``
        pending output tokens (used by the violation monitor)."""
        theta = hw.throughput(wl)
        return n_ahead_tokens / theta \
            + hw.prefill_seconds(prompt_tokens, effective_prompt_tokens)

    # -- accuracy metric (Fig. 18) ----------------------------------------
    @staticmethod
    def r_squared(predicted: Sequence[float], actual: Sequence[float]) -> float:
        import numpy as np
        p = np.asarray(predicted, float)
        a = np.asarray(actual, float)
        ss_res = float(np.sum((a - p) ** 2))
        ss_tot = float(np.sum((a - a.mean()) ** 2))
        return 1.0 - ss_res / max(ss_tot, 1e-12)
