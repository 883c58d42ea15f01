"""Hardware profiles for the RWT estimator, calibrated on a real engine.

Trimmed copy of the reference package's ``sim/profiles.py``: only
``calibrate_from_engine`` (paper §6 "Hardware Profiling") is kept; the
published A100/A10 tables belong to the simulator, which the port does not
carry.
"""
from __future__ import annotations

from repro_torch.core.rwt_estimator import HardwareProfile


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
