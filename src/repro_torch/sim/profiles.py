"""Hardware / model profiles for the cluster simulator.

Constants follow the paper's testbed (§8: NVIDIA A10 24 GB and A100 80 GB;
Mistral-7B, Vicuna-13B, Llama-70B) with published vLLM-era numbers:

  * decode_per_token — per-iteration latency at saturated batch,
  * token_capacity  — KV tokens that fit after weights (paged, ~100% util),
  * swap_time       — CPU→GPU weight transfer (~25 GB/s PCIe 4),
  * prefill_time    — prefill cost per 1k prompt tokens,
  * inefficiency ε  — continuous-batching preemption factor.

The same dataclass is produced by ``calibrate_from_engine`` for reduced
models on CPU, so every simulator experiment can also run end-to-end
against the real JAX engine (tests do this).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.rwt_estimator import HardwareProfile

# (device, model) -> profile
_A100 = {
    "mistral-7b":   HardwareProfile(prefill_time=0.15, decode_per_token=0.025,
                                    inefficiency=1.2, token_capacity=120_000,
                                    swap_time=1.0, model_max_tokens=2048),
    "vicuna-13b":   HardwareProfile(prefill_time=0.20, decode_per_token=0.040,
                                    inefficiency=1.2, token_capacity=60_000,
                                    swap_time=2.0, model_max_tokens=2048),
    "llama-70b":    HardwareProfile(prefill_time=0.45, decode_per_token=0.110,
                                    inefficiency=1.25, token_capacity=40_000,
                                    swap_time=8.0, model_max_tokens=2048),
}
_A10 = {
    # ~3x less memory, ~2.5x slower; 70B does not fit on one A10
    "mistral-7b":   HardwareProfile(prefill_time=0.40, decode_per_token=0.065,
                                    inefficiency=1.25, token_capacity=18_000,
                                    swap_time=2.2, model_max_tokens=2048),
    "vicuna-13b":   HardwareProfile(prefill_time=0.60, decode_per_token=0.105,
                                    inefficiency=1.3, token_capacity=7_000,
                                    swap_time=4.5, model_max_tokens=2048),
}


def _with_ft_aliases(base: Dict[str, HardwareProfile]) -> Dict[str, HardwareProfile]:
    """Fine-tuned variants share the base model's profile (§8 W_B)."""
    out = dict(base)
    alias = {
        "mistral-7b-ft": "mistral-7b",
        "vicuna-13b-ft": "vicuna-13b",
        "vicuna-13b-ft2": "vicuna-13b",
        "llama-70b-ft1": "llama-70b",
        "llama-70b-ft2": "llama-70b",
    }
    for ft, b in alias.items():
        if b in base:
            out[ft] = base[b]
    return out


DEVICE_PROFILES: Dict[str, Dict[str, HardwareProfile]] = {
    "a100": _with_ft_aliases(_A100),
    "a10": _with_ft_aliases(_A10),
}


def profiles_for(device: str, models=None) -> Dict[str, HardwareProfile]:
    table = DEVICE_PROFILES[device]
    if models is None:
        return dict(table)
    return {m: table[m] for m in models if m in table}


def calibrate_from_engine(engine, token_capacity: int,
                          swap_time: float = 0.1,
                          model_max_tokens: int = 64,
                          dispatch_overhead: float = 0.0) -> HardwareProfile:
    """Paper §6 'Hardware Profiling': one batch run on the real engine.

    ``decode_per_token`` is measured at the engine's configured
    ``decode_burst`` (profile() drives ``steps()``), so the per-dispatch
    host overhead is already amortized INTO the measurement at that burst
    width; the profile carries the width so the simulator charges the same
    amortization.  Pass ``dispatch_overhead`` (absolute seconds per
    dispatch, e.g. derived from engine_bench's host_overhead_fraction x
    wall_us_per_iter) to model re-running the same instance at a DIFFERENT
    burst width without re-profiling."""
    import numpy as np
    # the longest calibration prompt that fits alongside the decode budget:
    # short prompts would extrapolate fixed per-step dispatch overhead into
    # the per-1k-token rate
    calib_prompt_tokens = max(8, min(64, engine.cfg.max_seq_len // 2))
    prompts = [np.random.randint(0, 100, size=calib_prompt_tokens)
               for _ in range(engine.cfg.max_slots)]
    # warm the jitted prefill/decode paths first: the cold compile would
    # otherwise dominate the measurement (and get extrapolated per-token)
    engine.profile([np.random.randint(0, 100, size=calib_prompt_tokens)],
                   max_new_tokens=2)
    prof = engine.profile(prompts, max_new_tokens=16)
    return HardwareProfile(
        # profile() measures per-admission wall time for the calibration
        # prompts; normalize to the per-1k-prompt-token rate the simulator
        # and HardwareProfile.prefill_seconds charge with
        prefill_time=prof["prefill_time"] * 1024.0 / calib_prompt_tokens,
        decode_per_token=prof["decode_per_token"],
        inefficiency=1.2,
        token_capacity=token_capacity,
        swap_time=swap_time,
        model_max_tokens=model_max_tokens,
        prefill_chunk_tokens=engine.cfg.prefill_chunk_tokens or None,
        # carry the model's window so sim/RWT chunk counts reproduce the
        # engine's window-clamped quantum (engine._chunk_quantum also caps
        # at max_seq_len, so mirror both bounds)
        sliding_window=None if engine.model.cfg.sliding_window is None
        else min(engine.model.cfg.sliding_window, engine.cfg.max_seq_len),
        # burst-aware dispatch accounting: the sim charges the per-dispatch
        # overhead once per decode_burst iterations, mirroring steps()
        decode_burst=max(engine.cfg.decode_burst, 1),
        dispatch_overhead=dispatch_overhead)
