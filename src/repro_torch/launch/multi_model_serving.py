"""Multi-model serving with model swapping, paper Scenario 2 / Fig. 2
(twin of ``examples/multi_model_serving.py``).

Two model families share ONE serving instance.  QLM's request groups keep
same-model requests together, so the engine swaps models a handful of
times instead of per-request (Insight #3).  Compare against a per-request
EDF order to see the thrash.  By default the models are the reference's
reduced granite-3-2b and h2o-danube-1.8b (2 layers of 128); ``main``
takes any registry, the published configs included.

  PYTHONPATH=src python -m repro_torch.launch.multi_model_serving [--device cpu]

The engine names ``attention_backend="cuda"``, the dense per-slot cache
(the reference's default layout; the port's default page pool refuses
h2o-danube's sliding window).  On the card granite's decode attention runs
the dense decode kernel in bfloat16; h2o-danube's rolling window runs
plain, as in the reference.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.global_scheduler import InstanceInfo
from repro_torch.core.lso import QLMAgent
from repro_torch.core.qlm import QLMConfig, QLMController
from repro_torch.core.request import make_request
from repro_torch.core.request_group import RequestGroup
from repro_torch.core.rwt_estimator import HardwareProfile
from repro_torch.core.virtual_queue import VirtualQueue
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

MODELS = ("granite-3-2b", "h2o-danube-1.8b")


def build_registry(device="cuda", cfgs=None):
    """name -> (Model, params) for MODELS: ``cfgs[name]`` where given, else
    the reduced config; each model's weights from a generator seeded 0,
    bfloat16 on the card and float32 on the CPU."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    reg = {}
    for name in MODELS:
        cfg = (cfgs or {}).get(name) or get_arch(name).reduced(
            num_layers=2, d_model=128)
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        reg[name] = (model, model.init(gen, dtype, dev))
    return reg


def make_requests(n=16, seed=0):
    rng = np.random.default_rng(seed)
    now = time.monotonic()
    return [make_request(rng.integers(0, 100, size=6).tolist(),
                         MODELS[i % 2], "batch1", arrival_time=now,
                         max_new_tokens=4) for i in range(n)]


def serve(requests, use_qlm_grouping: bool, reg):
    """Serve ``requests`` on one engine over ``reg``; returns its stats."""
    m0, p0 = reg[MODELS[0]]
    p_any = p0["embed"]
    eng = ContinuousBatchingEngine(
        m0, p0, EngineConfig(max_slots=4, max_seq_len=64,
                             attention_backend="cuda",
                             device=str(p_any.device), dtype=p_any.dtype),
        model_name=MODELS[0])
    vq = VirtualQueue(0)
    agent = QLMAgent(eng, vq, reg)

    if use_qlm_grouping:
        hw = HardwareProfile(0.05, 0.02, 1.2, 256, swap_time=0.5,
                             model_max_tokens=8)
        info = InstanceInfo(0, {n: hw for n in MODELS}, eng.model_name, vq)
        ctrl = QLMController([info], QLMConfig(avg_batch_size=8))
        now = time.monotonic()
        for r in requests:
            ctrl.submit(r, now)
    else:
        # per-request "EDF" alternation: one singleton group per request
        groups = []
        for r in requests:
            g = RequestGroup(model=r.model, slo=r.slo)
            g.add(r)
            groups.append(g)
        vq.set_order(groups)

    while not all(r.finished() for r in requests):
        agent.run_iteration()
    return eng.stats


def main(argv: Optional[List[str]] = None, registry=None) -> dict:
    """Both orders on one registry (``build_registry(--device)`` unless
    given); returns their stats."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    reg = registry or build_registry(args.device)
    s_interleaved = serve(make_requests(), False, reg)
    s_qlm = serve(make_requests(seed=0), True, reg)
    print(f"per-request order : {s_interleaved.model_swaps} model swaps, "
          f"{s_interleaved.swap_time:.2f}s swapping")
    print(f"QLM request groups: {s_qlm.model_swaps} model swaps, "
          f"{s_qlm.swap_time:.2f}s swapping")
    if not s_qlm.model_swaps < s_interleaved.model_swaps:
        raise AssertionError("request groups must swap less than the "
                             "per-request order")
    print("=> request groups amortize model swapping (Insight #3)")
    return {"interleaved": s_interleaved, "qlm": s_qlm}


if __name__ == "__main__":
    main()
