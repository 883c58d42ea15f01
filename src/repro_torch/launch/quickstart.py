"""Quickstart: the QLM stack in ~60 lines (twin of
``examples/quickstart.py``).

Builds one real model, wraps it in a continuous-batching engine, submits
a mixed interactive/batch workload through the QLM controller, and prints
SLO attainment.  By default the model is the reference's reduced
granite-3-2b (2 layers, d_model 128); ``run(cfg=...)`` takes any config,
the published one included.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The engine names ``attention_backend="cuda"``, the dense per-slot cache:
the reference's default layout, where the port's default is the page
pool.  On the card every decode step's attention runs the dense decode
kernel (``kernels/decode_attention.py``) in bfloat16; on the CPU its plain
version in float32.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.lso import QLMAgent
from repro_torch.core.qlm import QLMConfig, QLMController
from repro_torch.core.request import make_request
from repro_torch.core.rwt_estimator import HardwareProfile
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig


def reduced_config() -> ModelConfig:
    """The reference's model: granite-3-2b reduced to 2 layers of 128."""
    return get_arch("granite-3-2b").reduced(num_layers=2, d_model=128)


def run(cfg: Optional[ModelConfig] = None, device="cuda", params=None,
        model=None) -> dict:
    """The quickstart on ``cfg`` (default ``reduced_config()``): weights
    drawn from a generator seeded 0 (bfloat16 on the card, float32 on the
    CPU) unless ``params`` are given; ``model`` replaces
    ``build_model(cfg)`` (a wrapped one, say).  Returns the requests, the
    attainment, the request-group count and the engine's stats."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    # 1. a real model (reduced granite-3-2b family unless cfg says other)
    cfg = cfg or reduced_config()
    model = model or build_model(cfg)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen, dtype, dev)

    # 2. an LLM serving instance = engine + model (Def. 2.3)
    engine = ContinuousBatchingEngine(
        model, params, EngineConfig(max_slots=4, max_seq_len=64,
                                    attention_backend="cuda",
                                    device=str(dev), dtype=dtype),
        model_name="granite")

    # 3. QLM: virtual queue + LSO agent + controller with an RWT profile
    vq = VirtualQueue(0)
    agent = QLMAgent(engine, vq, {"granite": (model, params)})
    hw = HardwareProfile(prefill_time=0.05, decode_per_token=0.02,
                         inefficiency=1.2, token_capacity=256,
                         swap_time=0.1, model_max_tokens=16)
    info = InstanceInfo(0, {"granite": hw}, "granite", vq)
    controller = QLMController([info], QLMConfig(avg_batch_size=4))

    # 4. submit a burst of mixed-SLO requests
    rng = np.random.default_rng(0)
    now = time.monotonic()
    requests = []
    for i in range(12):
        slo_class = ["interactive", "batch1", "batch2"][i % 3]
        r = make_request(rng.integers(0, 100, size=8).tolist(), "granite",
                         slo_class, arrival_time=now, max_new_tokens=6)
        requests.append(r)
        controller.submit(r, now)
    groups = len(controller.groups)
    print(f"submitted {len(requests)} requests in {groups} request groups")

    # 5. serve until done
    while not all(r.finished() for r in requests):
        agent.run_iteration()

    for r in requests[:3]:
        print(f"req {r.req_id} [{r.slo_class:11s}] ttft={r.ttft():.3f}s "
              f"tokens={r.output_tokens}")
    attainment = controller.slo_attainment()
    print(f"SLO attainment: {attainment:.0%}")
    print(f"engine stats: {engine.stats}")
    return {"requests": requests, "attainment": attainment, "groups": groups,
            "stats": engine.stats}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "versions)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
