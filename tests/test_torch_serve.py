"""The port's serving driver (``repro_torch.launch.serve``) end to end on
the CPU: the QLM controller, agents and the port's engine serve a small
Poisson workload on reduced GQA granite.  Every request must end terminal,
no KV block may leak, and every served request's tokens must equal the
JAX engine's greedy tokens for the same prompt and weights (exact).  The
CLI also serves two models, reduced granite and reduced h2o-danube, on the
dense backend with model swaps; reduced mamba2 alone on the dense backend
(single-shot prefill); and reduced granite with reduced mamba2, swapping
between a transformer and an SSM.  The threaded driver (one thread per
engine, ``--threaded``) serves the same workload on two instances with the
JAX engine's tokens, and ``--compare-drivers`` runs both drivers.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.core.request import Request as JaxRequest
from repro.launch import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params

torch.set_num_threads(2)
ARCH = "granite-3-2b"


def test_round_robin_serves_every_request_like_the_jax_engine():
    kw = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2)
    jmodel = jax_build_model(ARCHITECTURES[ARCH].reduced(**kw))
    jparams = jmodel.init(jax.random.key(3))
    tcfg = get_arch(ARCH).reduced(**kw)
    registry = {ARCH: (build_model(tcfg),
                       from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu"))}
    args = argparse.Namespace(
        slots=4, decode_burst=2, backend=None, prefix_sharing=True,
        debug_invariants=True, device="cpu", instances=1,
        routing="solver", requests=8, rate=20.0, max_new_tokens=6, seed=0,
        max_wall=120.0)
    np.random.seed(0)            # calibrate_from_engine draws its prompts
    stats, seen, engines = serve.run_round_robin(args, registry, [ARCH])

    assert stats["requests"] == len(seen) == 8
    assert all(r.finished() or r.dropped() for r in seen)
    assert stats["served"] >= 1 and stats["tokens"] > 0
    assert all(e.block_mgr.used_blocks == 0 for e in engines)
    assert all(e.cfg.dtype == torch.float32 for e in engines)
    assert all(e.device.type == "cpu" for e in engines)

    served = [r for r in seen if r.output_tokens]
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(
        attention_backend="paged-xla", max_slots=len(served),
        max_seq_len=128), model_name=ARCH)
    twins = [JaxRequest(prompt_tokens=list(r.prompt_tokens), model=ARCH,
                        slo=1e9, max_new_tokens=r.max_new_tokens)
             for r in served]
    for t in twins:
        assert ref.admit(t)
    while ref.num_active():
        ref.step()
    assert [r.output_tokens for r in served] == \
        [t.output_tokens for t in twins]


def test_serve_cli_swaps_granite_and_danube_on_the_dense_backend(capsys):
    """``--backend cuda --arch2 h2o-danube-1.8b --device cpu``: both reduced
    models (h2o-danube with its 64-token rolling window) share one engine,
    every request is served and the engine swaps models."""
    stats = serve.main(["--backend", "cuda", "--arch2", "h2o-danube-1.8b",
                        "--device", "cpu", "--requests", "8", "--rate",
                        "20", "--max-new-tokens", "4", "--slots", "4",
                        "--debug-invariants"])
    assert stats["requests"] == stats["served"] == 8
    assert stats["failed"] == stats["dropped_unserved"] == 0
    # tokens counts decode steps: every request's 3 tokens after the first
    # (more where a swap flushed a request and it was recomputed)
    assert stats["swaps"] >= 1 and stats["tokens"] >= 8 * 3
    assert "swaps" in capsys.readouterr().out


def test_serve_cli_serves_mamba2_on_the_dense_backend():
    """``--backend cuda --arch mamba2-130m --device cpu``: every request is
    admitted through the single-shot prefill and served."""
    stats = serve.main(["--backend", "cuda", "--arch", "mamba2-130m",
                        "--device", "cpu", "--requests", "8", "--rate",
                        "20", "--max-new-tokens", "4", "--slots", "4",
                        "--debug-invariants"])
    assert stats["requests"] == stats["served"] == 8
    assert stats["failed"] == stats["dropped_unserved"] == 0
    assert stats["tokens"] == 8 * 3 and stats["swaps"] == 0


def test_serve_cli_swaps_granite_and_mamba2():
    """``--backend cuda --arch2 mamba2-130m``: a transformer and an SSM
    share one engine through the swap LSO; every request is served."""
    stats = serve.main(["--backend", "cuda", "--arch2", "mamba2-130m",
                        "--device", "cpu", "--requests", "8", "--rate",
                        "20", "--max-new-tokens", "4", "--slots", "4",
                        "--debug-invariants"])
    assert stats["requests"] == stats["served"] == 8
    assert stats["failed"] == stats["dropped_unserved"] == 0
    assert stats["swaps"] >= 1 and stats["tokens"] >= 8 * 3


def test_threaded_driver_serves_every_request_like_the_jax_engine():
    """``run_threaded`` (one thread per engine, two instances) serves the
    round-robin test's workload: every request ends terminal and served,
    no block leaks on either engine, and every request's tokens equal the
    JAX engine's greedy tokens and the round-robin driver's on the same
    seed (exact)."""
    kw = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2)
    jmodel = jax_build_model(ARCHITECTURES[ARCH].reduced(**kw))
    jparams = jmodel.init(jax.random.key(3))
    tcfg = get_arch(ARCH).reduced(**kw)
    registry = {ARCH: (build_model(tcfg),
                       from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu"))}
    args = argparse.Namespace(
        slots=4, decode_burst=2, backend=None, prefix_sharing=True,
        debug_invariants=True, device="cpu", instances=2, threaded=True,
        routing="solver", requests=8, rate=20.0, max_new_tokens=6, seed=0,
        max_wall=120.0)
    runs = {}
    for threaded in (True, False):
        args.threaded = threaded
        np.random.seed(0)        # calibrate_from_engine draws its prompts
        stats, seen, engines = serve.run_once(args, registry, [ARCH])
        assert stats["driver"] == ("threaded" if threaded
                                   else "round-robin")
        assert stats["requests"] == stats["served"] == len(seen) == 8
        assert all(r.finished() for r in seen)
        assert all(e.block_mgr.used_blocks == 0 for e in engines)
        assert len(engines) == 2
        runs[threaded] = [r.output_tokens for r in seen]
    assert all(len(t) == 6 for t in runs[True])
    assert runs[True] == runs[False]

    prompts = [list(r.prompt_tokens) for r in seen]
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(
        attention_backend="paged-xla", max_slots=len(prompts),
        max_seq_len=128), model_name=ARCH)
    twins = [JaxRequest(prompt_tokens=p, model=ARCH, slo=1e9,
                        max_new_tokens=6) for p in prompts]
    for t in twins:
        assert ref.admit(t)
    while ref.num_active():
        ref.step()
    assert runs[True] == [t.output_tokens for t in twins]


def test_serve_cli_threaded_and_compare_drivers(capsys, monkeypatch):
    """``--threaded`` and ``--compare-drivers`` on the CPU serve every
    request (each engine on its own thread, the controller ticking on its
    own); ``--hetero`` over three instances calibrates once per tier, on
    the reference's tier configs, and serves every request."""
    flags = ["--device", "cpu", "--instances", "2", "--requests", "8",
             "--rate", "20", "--max-new-tokens", "4", "--slots", "4",
             "--debug-invariants"]
    stats = serve.main(flags + ["--threaded"])
    assert stats["driver"] == "threaded"
    assert stats["requests"] == stats["served"] == 8
    assert stats["failed"] == stats["dropped_unserved"] == 0
    assert len(stats["engine_rounds"]) == 2 and stats["controller_ticks"] > 0
    out = serve.main(flags + ["--compare-drivers"])
    assert set(out) == {"threaded", "round-robin"}
    for st in out.values():
        assert st["requests"] == st["served"] == 8
    assert "tokens/s           threaded" in capsys.readouterr().out
    calibrated = []
    real = serve.calibrate_registry

    def counting(registry, ecfg):
        calibrated.append((ecfg.max_slots, ecfg.decode_burst))
        return real(registry, ecfg)

    monkeypatch.setattr(serve, "calibrate_registry", counting)
    flags[flags.index("--instances") + 1] = "3"
    stats = serve.main(flags + ["--hetero", "--threaded"])
    assert calibrated == [(8, 4), (4, 2), (2, 1)]
    tiers = [jax_serve.hetero_engine_cfg(JaxEngineConfig(max_slots=4), i)
             for i in range(3)]
    assert calibrated == [(c.max_slots, c.decode_burst) for c in tiers]
    assert stats["requests"] == stats["served"] == 8
    assert stats["failed"] == stats["dropped_unserved"] == 0
    assert len(stats["engine_rounds"]) == 3
