"""One run of one cell: set-up, lead-in, the measured window, the metrics
and the correctness check.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name:

  * ``configs/<config>.json``: the published configuration, the sizes as
    run (``"model"``, laid over the port's ``get_arch(arch)``), the
    architecture ``"family"``, the engine settings, the correctness limit;
  * ``families/<family>.py``: the family's refusal, weights, reference and
    attention layers (``families/__init__.py``);
  * ``traffic/<mix>.json``: a mix's parameters, read by ``generator.py``;
  * ``cells/<cell>.json`` (optional): the cell's own values, such as the
    rate, laid over its mix;
  * ``metrics/<metric>.py``: ``read(run, qualifier) -> float | None``.  A
    metric ``base.qualifier`` without a file of its own is read by
    ``metrics/base.py`` with ``qualifier`` (a configuration name).

The window is driven as ``launch/serve.py::run_round_robin`` drives it:
the harness is the open-loop client, submitting each request to
``QLMController.submit`` when it falls due, then running
``QLMAgent.run_iteration`` and ``QLMController.tick``; below that, all is
the port's own code.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from qlm_bench import check, counting, families, generator, trace

BENCH = families.BENCH
ROOT = BENCH.parent
if str(ROOT / "src") not in sys.path:        # the port, beside the bench
    sys.path.insert(0, str(ROOT / "src"))
TRACE_SLICE_S = 4.0        # the traced slice: the middle of the window


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / kind / f"{name}.json").read_text())


def cell_of(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def traffic_of(cell: dict, bench: Path = BENCH) -> dict:
    """The cell's mix with the cell's own values laid over it."""
    mix = load_json("traffic", cell["traffic"], bench)
    own = bench / "cells" / f"{cell['name']}.json"
    if own.exists():
        mix.update(json.loads(own.read_text()))
    return mix


def metrics_of(spec: dict, cell: str, traced: bool) -> List[dict]:
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, bench: Path = BENCH):
    """(read, qualifier) for metric ``name``."""
    path, qualifier = bench / "metrics" / f"{name}.py", None
    if not path.exists() and "." in name:
        base, qualifier = name.split(".", 1)
        path = bench / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(
        f"qlm_bench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read, qualifier


# ---------------------------------------------------------------------------
# what a run records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Seen:
    """One request as the harness sees it: due time, limit, and after each
    agent round the observations that changed: its output token count
    (``obs``) and how far into its prompt the engine is (``pre``: its
    slot's prefill position, the cached prefix included, capped at the
    prompt's length)."""
    req: object
    due: float
    cls: str
    ttft_s: float
    prompt_len: int
    obs: List[tuple] = dataclasses.field(default_factory=list)
    pre: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def first_token(self) -> Optional[float]:
        return self.req.first_token_time

    @property
    def dropped(self) -> bool:
        return bool(self.req.dropped())

    def prompt_spans(self, ws: float, we: float):
        """(start, end) prompt positions reached in [ws, we], one pair per
        observation that moved the prefill there."""
        prev = 0
        for t, pos in self.pre:
            if ws <= t <= we and pos > prev:
                yield prev, pos
            prev = max(prev, pos)


@dataclasses.dataclass
class Ledger:
    """Counts of the model calls of a traced slice (the harness's wrappers
    around the Model it builds)."""
    engine: object = None
    slice: object = None        # the trace.Slice, for the model's spans
    on: bool = False
    round_calls: int = 0
    round_state: tuple = ()
    useful_rows: int = 0
    computed_rows: int = 0
    prefill_least_s: float = 0.0
    decode_least_s: float = 0.0
    prefill_launches: int = 0
    decode_launches: int = 0


@dataclasses.dataclass
class Run:
    """What one run recorded, for the metric readers."""
    model: dict                 # the sizes as run
    seconds: float
    window: tuple               # (start, end), time.monotonic
    seen: List[Seen]
    stats: tuple                # EngineStats as dicts, window start / end
    controller_s: float         # submit + tick, in the window
    ticks: int
    backlog: tuple              # requests unfinished, window start / end
    ledger: Optional[Ledger] = None
    trace: Optional[dict] = None
    setup_s: float = 0.0
    layers: list = dataclasses.field(default_factory=list)  # attention_layers
    kv_pool: Optional[dict] = None  # page-pool blocks: all, in use (window)

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.window[0] <= t <= self.window[1]

    def delta(self, key: str) -> float:
        return self.stats[1][key] - self.stats[0][key]


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def model_config(config: dict, bench: Path = BENCH):
    """The port's ModelConfig: ``get_arch(arch)`` with the configuration's
    sizes laid over it; refused by the family where its reference does not
    compute it."""
    from repro_torch.configs import get_arch

    sizes = dict(config["model"])
    cfg = get_arch(config["arch"])
    if "moe" in sizes:
        sizes["moe"] = dataclasses.replace(cfg.moe, **sizes["moe"])
    cfg = dataclasses.replace(cfg, **sizes)
    families.of(config, bench).accepts(cfg)
    return cfg


def engine_config(config: dict, device: str, dtype):
    from repro_torch.serving import EngineConfig
    return EngineConfig(device=device, dtype=dtype, **config["engine"])


def wrapped(model, ledger: Ledger, esize: int, layers: list):
    """The Model with its paged prefill and decode counting, while
    ``ledger.on``, the rows each chunk round advances and computes and
    each attention launch's least time, ``count`` launches of each of the
    family's ``layers`` groups, and opening a host span."""
    prefill, decode = model.prefill_chunk_paged, model.decode_step_paged

    def prefill_chunk_paged(params, cache, tokens, starts, valid, table):
        eng = ledger.engine
        if ledger.on and eng is not None:
            C = eng.cfg.prefill_chunk_tokens
            st, vd = [], []
            for i in eng.prefilling_slots():
                pos = int(eng.prefill_pos[i])
                st.append(pos)
                vd.append(min(C, eng.slots[i].prompt_len - pos))
            ledger.useful_rows += sum(vd)
            ledger.computed_rows += tokens.shape[0] * tokens.shape[1]
            for L, H, KVH, D, window in layers:
                ledger.prefill_least_s += L * counting.prefill_least_s(
                    esize, H, KVH, D, st, vd, window)
                ledger.prefill_launches += L
        with trace.span(ledger.slice, "model.prefill_chunk"):
            return prefill(params, cache, tokens, starts, valid, table)

    def decode_step_paged(params, cache, tokens, lengths, table):
        eng = ledger.engine
        if ledger.on and eng is not None:
            if ledger.round_calls == 0:
                ledger.round_state = [
                    (int(eng.lengths[i]),
                     eng.slots[i].max_new_tokens - eng.slots[i].generated)
                    for i in eng.decode_slots()]
            k = ledger.round_calls
            ctx = [n + k + 1 for n, rem in ledger.round_state if k < rem]
            for L, H, KVH, D, window in layers:
                ledger.decode_least_s += L * counting.decode_least_s(
                    esize, H, KVH, D, ctx, window)
                ledger.decode_launches += L
        ledger.round_calls += 1
        with trace.span(ledger.slice, "model.decode_step"):
            return decode(params, cache, tokens, lengths, table)

    return dataclasses.replace(model, prefill_chunk_paged=prefill_chunk_paged,
                               decode_step_paged=decode_step_paged)


def build(config: dict, params, device: str, dtype, ledger: Optional[Ledger],
          bench: Path = BENCH):
    """The cluster of ``launch/serve.py::build_cluster`` with one instance:
    the model calibrated on a throwaway engine (``calibrate_registry``),
    then the serving engine, its agent and the controller."""
    from repro_torch.core.global_scheduler import InstanceInfo
    from repro_torch.core.lso import QLMAgent
    from repro_torch.core.qlm import QLMConfig, QLMController
    from repro_torch.core.virtual_queue import VirtualQueue
    from repro_torch.launch.serve import calibrate_registry
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine

    name = config["name"]
    model = build_model(model_config(config, bench))
    if ledger is not None:
        model = wrapped(model, ledger, torch.empty((), dtype=dtype)
                        .element_size(), families.of(config, bench)
                        .attention_layers(config["model"]))
    registry = {name: (model, params)}
    ecfg = engine_config(config, device, dtype)
    hw = calibrate_registry(registry, ecfg)
    eng = ContinuousBatchingEngine(model, params, ecfg, model_name=name)
    vq = VirtualQueue(0)
    agent = QLMAgent(eng, vq, registry)
    info = InstanceInfo(0, dict(hw), eng.model_name, vq)
    controller = QLMController([info], QLMConfig(avg_batch_size=ecfg.max_slots))
    controller.attach_engines([eng])
    return eng, agent, info, controller


def warm_up(eng, vocab: int) -> None:
    """Every shape this cell's traffic uses, once: a chunk round at each
    padding bucket, a single decode step and a full burst."""
    from repro_torch.core.request import Request

    for i, b in enumerate(eng.cfg.resolved_buckets()):
        prompt = ((np.arange(b) + 7919 * (i + 1)) % vocab).tolist()
        req = Request(prompt_tokens=prompt, model=eng.model_name, slo=1e9,
                      max_new_tokens=2 + max(eng.cfg.decode_burst, 1))
        if not eng.admit(req):
            raise RuntimeError("warm-up request refused")
        while eng.num_active():
            eng.steps()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", spec: Optional[dict] = None,
             bench: Path = BENCH, config: Optional[dict] = None,
             traffic: Optional[dict] = None, t_process: Optional[float] = None,
             hooks=None) -> dict:
    """One run; returns the result line's fields, ``checks`` last.
    ``config`` / ``traffic`` replace the files' (the CPU tests' small
    sizes); ``hooks(eng)`` may wrap the engine after it is built (the
    fault tests)."""
    t_process = time.monotonic() if t_process is None else t_process
    spec = load_spec(bench.parent) if spec is None else spec
    cell = cell_of(spec, cell_name)
    config = config or load_json("configs", cell["config"], bench)
    traffic = traffic or traffic_of(cell, bench)
    params = make_params(config, seed, device, bench)
    out = measure(spec, cell_name, config, traffic, params, seed, seconds,
                  traced, device, bench, t_process, hooks)
    verdict = check.judge(config, params, out["requests"], seed,
                          out["run"].window, bench=bench)
    return {**out, "correct": verdict["correct"], "checks": verdict["checks"]}


def dtype_of(config: dict, device: str):
    return getattr(torch, config["dtype"]) if device.startswith("cuda") \
        else torch.float32


def make_params(config: dict, seed: int, device: str, bench: Path = BENCH):
    return families.of(config, bench).make_weights(
        config["model"], seed, dtype_of(config, device), torch.device(device))


def measure(spec, cell_name, config, traffic, params, seed, seconds, traced,
            device, bench=BENCH, t_process=None, hooks=None) -> dict:
    """Set-up (from ``t_process``), lead-in and window, the metrics; the
    port's state freed at the end."""
    t_process = time.monotonic() if t_process is None else t_process
    on_card = device.startswith("cuda")
    dtype = dtype_of(config, device)
    np.random.seed(seed % 2**32)        # calibrate_from_engine's prompts
    ledger = Ledger() if traced else None
    eng, agent, info, controller = build(config, params, device, dtype,
                                         ledger, bench)
    if hooks is not None:
        hooks(eng)
    warm_up(eng, config["model"]["vocab_size"])
    arrivals = generator.schedule(traffic, seed, seconds,
                                  config["model"]["vocab_size"])
    if ledger is not None:
        ledger.engine = eng
        trace.Slice.warm()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    run = serve(traffic, config, seconds, arrivals, t0, eng, agent, info,
                controller, ledger, traced)
    run.setup_s = t0 - t_process
    run.layers = families.of(config, bench).attention_layers(config["model"])
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"timing: setup {run.setup_s:.2f} s, lead-in "
          f"{run.window[0] - t0:.2f} s, window {seconds:g} s; requests in "
          f"the system at the window's start {run.backlog[0]}, at its end "
          f"{run.backlog[1]} ({len(run.seen)} submitted); page pool "
          f"{run.kv_pool['blocks']} blocks, in use at most "
          f"{run.kv_pool['in_use_peak']} in the window, "
          f"{run.kv_pool['in_use_end']} at its end", file=sys.stderr)

    values = {}
    for m in metrics_of(spec, cell_name, traced):
        read, qualifier = reader(m["name"], bench)
        v = read(run, qualifier)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # the port's state goes before the reference runs
    if ledger is not None:
        ledger.engine = ledger.slice = None
    del eng, agent, info, controller
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"attempted": len(run.seen),
            "failed": sum(s.dropped for s in run.seen),
            "metrics": values, "memory_peak_bytes": memory_peak,
            "kv_pool": run.kv_pool, "trace": run.trace, "run": run,
            "requests": [s.req for s in run.seen]}


def serve(traffic, config, seconds, arrivals, t0, eng, agent, info,
          controller, ledger, traced) -> Run:
    """The lead-in and the window, on the wall clock."""
    from repro_torch.core.request import Request

    lead_in = float(traffic.get("lead_in_s", 0.0))
    pool = eng.cfg.resolved_kv_blocks()
    pool_peak = 0                               # blocks in use, window
    pending = list(reversed(arrivals))          # pop() takes the next due
    seen: List[Seen] = []
    live: Dict[int, Seen] = {}
    ws = we = None                              # the window, once open
    backlog = []                                # requests in the system
    stats0 = None
    ctl_s, ticks = 0.0, 0
    sl = trace.Slice() if traced else None
    if ledger is not None:
        ledger.slice = sl
    slice_at = None

    def note(s: Seen, now: float, pos: int, n: int) -> None:
        if not s.pre or s.pre[-1][1] != pos:
            s.pre.append((now, pos))
        if not s.obs or s.obs[-1][1] != n:
            s.obs.append((now, n))

    def observe(now: float, finished) -> None:
        for i, r in enumerate(eng.slots):
            s = None if r is None else live.get(r.req_id)
            if s is not None:
                note(s, now, min(int(eng.prefill_pos[i]), s.prompt_len),
                     len(r.output_tokens))
        for r in finished:
            s = live.pop(r.req_id, None)
            if s is not None:
                note(s, now, s.prompt_len, len(r.output_tokens))

    while True:
        now = time.monotonic()
        if ws is None and now - t0 >= lead_in:
            ws, we = now, now + seconds
            stats0 = dataclasses.asdict(eng.stats)
            backlog = [len(live)]
            slice_at = ws + max(0.0, (seconds - TRACE_SLICE_S) / 2)
        if we is not None and now >= we:
            break
        if sl is not None and slice_at is not None:
            if sl.prof is None and now >= slice_at:
                sl.start()
                ledger.on = True
            elif sl.active and now >= slice_at + min(TRACE_SLICE_S, seconds):
                sl.stop()
                ledger.on = False
        in_win = ws is not None
        t_ctl = time.perf_counter()
        with trace.span(sl, "controller.submit"):
            while pending and t0 + pending[-1].due <= now:
                a = pending.pop()
                req = Request(prompt_tokens=a.prompt.tolist(),
                              model=eng.model_name, slo=a.ttft_s,
                              arrival_time=t0 + a.due,
                              max_new_tokens=a.max_new_tokens,
                              slo_class=a.cls)
                s = Seen(req, t0 + a.due, a.cls, a.ttft_s, len(a.prompt))
                seen.append(s)
                live[req.req_id] = s
                controller.submit(req, now)
        if in_win:
            ctl_s += time.perf_counter() - t_ctl
        if ledger is not None:
            ledger.round_calls = 0
        info.current_model = eng.model_name
        with trace.span(sl, "agent.run_iteration"):
            finished = agent.run_iteration()
        now = time.monotonic()
        observe(now, finished)
        if in_win:
            pool_peak = max(pool_peak, pool - eng.block_mgr.free_blocks)
        t_ctl = time.perf_counter()
        with trace.span(sl, "controller.tick"):
            controller.tick(now)
        if in_win:
            ctl_s += time.perf_counter() - t_ctl
            ticks += 1
        if not eng.num_active() and pending:
            time.sleep(min(0.01, max(0.0, t0 + pending[-1].due - now)))
    if sl is not None and sl.active:
        sl.stop()
        ledger.on = False
    backlog.append(len(live))
    run = Run(config["model"], seconds, (ws, we), seen,
              (stats0, dataclasses.asdict(eng.stats)), ctl_s, ticks,
              tuple(backlog), ledger)
    run.kv_pool = {"blocks": pool, "in_use_peak": pool_peak,
                   "in_use_end": pool - eng.block_mgr.free_blocks}
    if sl is not None and sl.prof is not None:
        run.trace = sl.read()
        print(trace.summary(run.trace, ledger), file=sys.stderr)
    return run
