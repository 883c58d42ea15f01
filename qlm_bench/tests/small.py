"""Small sizes of the benchmark's cells for the CPU tests: the same
configurations and mixes, cut so that a run takes seconds."""
from __future__ import annotations

import contextlib
import copy

import torch

from qlm_bench import harness

SEED = 2**31 + 12345          # the driver's seeds exceed 32 signed bits


def small(cell_name: str, *, limit: float = 1e-3, seconds: float = 1.5):
    """(spec, config, traffic) of ``cell_name`` at a CPU size.  The limit
    is the CPU's: the port and the reference both compute in float32
    there, so a sound run's gap is 0 to rounding."""
    spec = harness.load_spec()
    cell = harness.cell_of(spec, cell_name)
    config = copy.deepcopy(harness.load_json("configs", cell["config"]))
    m = config["model"]
    m.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=500)
    if "moe" in m:
        m["moe"].update(num_experts=4, experts_per_token=2, d_ff_expert=64,
                        capacity_factor=2.0)
    config["engine"].update(max_slots=4, max_seq_len=256,
                            prefill_chunk_tokens=32, kv_blocks=None)
    config["check"].update(limits={"max_logit_gap": limit}, sample_requests=6)
    traffic = copy.deepcopy(harness.traffic_of(cell))
    for k in ("input", "output"):
        traffic["lengths"][k].update(min=1, max=48)
    if "mega" in traffic:
        traffic["mega"].update(total_min=120, total_max=160)
    traffic.update(rate=8.0, lead_in_s=0.5)
    return spec, config, traffic


@contextlib.contextmanager
def one_thread():
    """torch on one thread for the block: the test workers run side by
    side, and a small model gains nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run_small(cell_name: str, *, traced: bool = False, hooks=None,
              seed: int = SEED, **kw) -> dict:
    """One CPU run of the cell at its small size."""
    spec, config, traffic = small(cell_name, **kw)
    with one_thread():
        return harness.run_cell(cell_name, seed, kw.get("seconds", 1.5),
                                traced, device="cpu", spec=spec,
                                config=config, traffic=traffic, hooks=hooks)
