"""Multi-pod dry run (PyTorch twin of ``src/repro/launch/dryrun.py``): run
every (arch x input shape x mesh) step on a fake device mesh and record
what each device would hold, compute and communicate.

For each combination this builds the right step function, as the
reference does: the train step (``training/train_step.py::
make_train_step`` with AdamW, ``microbatches`` and ``remat``) for
train_4k, the model's ``prefill`` for prefill_32k and its
``decode_step`` (ONE token against a full-length cache) for decode_32k and
long_500k.  Params, optimizer state, cache and data are ``meta`` tensors
(nothing is allocated) wrapped as DTensors on the production mesh, placed
by the sharding rules (``distributed/sharding.py``), and the step runs on
them on torch's fake process group (``launch/mesh.py``), which stands in
for 256 (or 512) devices: DTensor splits each op into this rank's local
ops and the collectives its redistributions need.  (Meta tensors, not
``FakeTensorMode``: DTensor's own bookkeeping of a strided shard builds
small index tensors and reads them back, which fake tensors refuse.)
The record holds

  * memory per device: the local bytes of the arguments, of the outputs
    and of the outputs that alias an argument (the cache and, in
    training, the params and moments, all updated in place), and the
    peak of live local bytes from ``torch.distributed._tools.
    mem_tracker.MemTracker`` (``temp`` is what the peak holds beyond
    arguments and new outputs);
  * flops and bytes accessed per device, and the collectives' bytes
    and counts (``launch/comm_analysis.py``; the bytes are an unfused
    count, one term per aten op, so an upper estimate beside XLA's);

in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``, with the
reference's keys but two: ``trace_s`` replaces ``lower_s`` and
``compile_s`` (there is no compile), and ``transcendentals`` is null
(torch does not count them).  ``fallback_ops`` and
``fallback_collective_bytes`` are the port's own: the ops that ran
replicated (below), and the collective bytes each one's redistributions
issued; ``fallback_sites`` says where in the port each op fell back
(``path:line (function)`` -> count).  A record is a prediction of the
step's footprint on that mesh, not a measurement.

The step runs the kernels' plain versions: a kernel reads its inputs
through their data pointers, and a meta tensor has none
(``kernels/common.py::on_cpu`` sends meta tensors to the plain version;
the reference's dry run lowers its jnp path too).  This is the one place
where the plain versions run on a machine with a card, and the dry run
never touches the card.

Where DTensor has no sharding strategy for an op on the placements it
gets, ``comm_analysis.ReplicateFallback`` replicates that op's inputs at
that call only, as GSPMD's implicit all-gather would, and the record
counts the gather; ``fallback_ops`` lists them.  Which ops fall back
depends on torch's version.  The records of ``launch/hillclimb.py``'s
granite-decode and qwen3-train targets have none under torch 2.11 or
2.13, ``g16_mb4_seqshard_donate`` included: its residual, split over the
batch and the sequence, is gathered on the sequence once a sub-block,
where 2.11 could not view each projection's (B, L) fold as one
dimension.

These places were written so that they shard under torch 2.11 and 2.13
alike, with no fallback and no collective beyond XLA's plan of the
reference (``tests/test_torch_mesh_plan.py`` holds that plan):

  * the residual stream stays whole over "model" between sub-blocks, as
    XLA keeps the reference's: each projection back to it (attention's
    ``wo``, the MLPs' ``down`` / ``fc2``, the SSM's ``out_proj``, the
    MoE combine) is a partial sum over "model" that one all-reduce
    completes (``distributed/local.py::complete``).  Left to the
    residual add, torch 2.13 carried the partial sum into the next
    layer, whose attention completed its q and k at the scores' size
    (qwen3-moe train_4k ``g16_mb4``: 19.8x the collective bytes of
    ``g16``, 188 view fallbacks); the cross-entropy's normalizer is
    vocab-parallel likewise (``models/layers.py::next_token_ce``);

  * the dense cache write (``models/attention.py::_write_dense``).  The
    cache holds the reference's S columns, so ``kv_seq`` shards over
    "model"; a chunk or decode write is a ``scatter_`` along it, which
    DTensor does not shard along a split axis (torch 2.13 shards it along
    the batch only, torch 2.11 not at all).  The
    write runs on each shard's local columns instead
    (``distributed/local.py``): a token lands where the shard owns its
    column, every other write puts back the value its column held,
    which is how GSPMD partitions the reference's ``.at[...].set(mode=
    "drop")``, with no collective.  A form over whole columns (a select
    against a one-hot of all S columns) would read and write the whole
    cache every step.  The single-shot prefill replaces every column with
    one ``copy_``, which DTensor takes shard by shard;
  * the MoE's grouped dispatch (``models/moe.py::_moe_groups``): the
    sort, ranking, scatter and combine run on each device's own groups,
    the dispatch into its own experts' rows (its gradient stays on the
    device, the tokens' a partial sum over the experts), and the ranking
    counts instead of ``searchsorted``, which has no strategy at all;
    the router runs on each device's tokens (``_topk_routing_local``):
    its stable sort's backward is local under either torch;
  * the embedding lookup (``models/layers.py::embed_tokens``) runs as
    XLA partitions the reference's: a masked lookup in each shard's rows
    of the vocab-split table, a partial sum that one all-reduce of the
    output completes, and a local ``index_put`` for its gradient; no
    gather of the table (``distributed/local.py::vocab_lookup``);
  * the k/v projections' head split (``models/attention.py::
    _split_heads``) gathers only the "model" axis where its shards cut a
    KV head, as the kernels' plain versions do for their query heads
    (``distributed/local.py::whole``); ``_sdpa`` runs on each device's
    own query heads against their KV heads' k and v (``_sdpa_local``),
    with no query gather and no reduction of its output's gradient;
  * each sub-block's input gradient, a partial sum over "model", is
    completed once there (``distributed/local.py::complete_grad``), as
    the forward completes its output;
  * the cross-entropy keeps its gathered gold logits in their gathered
    shape (``models/layers.py::next_token_ce``).

A microbatch is a slice of the batch, which DTensor gathers whole; the
train step splits it back over the batch's axes
(``training/train_step.py::_rows``), so each microbatch runs
data-parallel.  The microbatches' gradients are added on their local
tensors, partial sums staying partial, and every gradient is reduced
once, onto its parameter's placements, before the norm and the optimizer
(``training/train_step.py::_reduced``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (ARCHITECTURES, INPUT_SHAPES, get_arch,
                                 get_shape, shape_applicable)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed.sharding import (ShardingRules, batch_axes_tree,
                                              build_shardings, distribute,
                                              map_leaves)
from repro_torch.launch.comm_analysis import DeviceCounter, ReplicateFallback
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_factory import batch_struct, build_model
from repro_torch.training.optimizer import AdamW, tree_leaves
from repro_torch.training.train_step import make_train_step

DTYPE = torch.bfloat16
OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def adapt_config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Hardware adaptation hooks (DESIGN.md §4): zamba2's shared attention
    runs sliding-window in long-context mode so the 500k cache stays
    bounded."""
    if shape.name == "long_500k" and cfg.arch_type == "hybrid" \
            and cfg.sliding_window is None:
        return dataclasses.replace(cfg, sliding_window=4096)
    return cfg


def input_specs(arch: str, shape_name: str, dtype=DTYPE) -> Dict[str, Any]:
    """Public: (shape, dtype) stand-ins for every model input."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    cfg = adapt_config_for_shape(cfg, shape)
    return batch_struct(cfg, shape.global_batch, shape.seq_len, shape.kind,
                        dtype)


# ---------------------------------------------------------------------------

def _placed(mesh, tree, axes, rules: ShardingRules):
    return distribute(mesh, tree, build_shardings(mesh, tree, axes, rules))


def build_step(cfg: ModelConfig, shape: InputShape, mesh,
               rules: Optional[ShardingRules] = None,
               microbatches: int = 1, remat: bool = True,
               dtype: torch.dtype = DTYPE):
    """Returns (step_fn, args, rules): ``step_fn(*args)`` runs one step on
    meta DTensors placed on ``mesh`` (the reference's
    ``build_lowerable``)."""
    rules = rules or ShardingRules.default()
    cfg = adapt_config_for_shape(cfg, shape)
    model = build_model(cfg)
    params = _placed(mesh, model.eval_shape_params(dtype),
                     model.param_axes(), rules)
    data = map_leaves(lambda _, sd: torch.zeros(sd[0], dtype=sd[1],
                                                device="meta"),
                      batch_struct(cfg, shape.global_batch, shape.seq_len,
                                   shape.kind, dtype))
    data = _placed(mesh, data, batch_axes_tree(data), rules)

    if shape.kind == "train":
        opt = AdamW(learning_rate=1e-4)
        opt_state = opt.init(params)
        step_fn = make_train_step(model, opt, microbatches=microbatches,
                                  remat=remat)
        return step_fn, (params, opt_state, data), rules

    cache = _placed(mesh, model.init_cache(shape.global_batch, shape.seq_len,
                                           dtype, "meta"),
                    model.cache_axes(), rules)
    if shape.kind == "prefill":
        def prefill_fn(params, batch, cache):
            return model.prefill(params, batch, cache)
        return prefill_fn, (params, data, cache), rules

    assert shape.kind == "decode"

    def serve_step(params, cache, tokens, lengths):
        return model.decode_step(params, cache, tokens, lengths)
    return serve_step, (params, cache, data["tokens"], data["lengths"]), rules


def _storages(tree) -> Dict[int, int]:
    """Each local storage in ``tree`` (a DTensor's shard, a plain tensor)
    -> the bytes its tensor views, keyed by the storage's identity (a meta
    storage has no address)."""
    out = {}
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        local = t.to_local() if hasattr(t, "to_local") else t
        st = local.untyped_storage()
        out[st._cdata] = local.numel() * local.element_size()
    return out


def _mesh_name(mesh, multi_pod: bool, default: bool) -> str:
    if default:
        return "pod2x16x16" if multi_pod else "pod16x16"
    return "mesh" + "x".join(str(s) for s in mesh.shape)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            rules: Optional[ShardingRules] = None, microbatches: int = 1,
            remat: bool = True, save: bool = True, tag: str = "",
            config_transform: Optional[Callable] = None,
            shape_transform: Optional[Callable] = None, mesh=None,
            dtype: torch.dtype = DTYPE) -> Dict[str, Any]:
    """One record.  ``mesh`` (a ``DeviceMesh``) replaces the production
    mesh, ``shape_transform`` the input shape (a smaller batch, say) and
    ``config_transform`` the config, as the reference's."""
    cfg = get_arch(arch)
    if config_transform is not None:
        cfg = config_transform(cfg)
    shape = get_shape(shape_name)
    if shape_transform is not None:
        shape = shape_transform(shape)
    default_mesh = mesh is None
    if default_mesh:
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = _mesh_name(mesh, multi_pod, default_mesh)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "applicable": shape_applicable(cfg, shape),
    }
    if not rec["applicable"]:
        rec["skip_reason"] = ("long_500k needs sub-quadratic decode; "
                              f"{arch} is full-attention (DESIGN.md §4)")
        if save:
            _save(rec)
        return rec

    fn, args, rules = build_step(cfg, shape, mesh, rules,
                                 microbatches=microbatches, remat=remat,
                                 dtype=dtype)
    arg_storages = _storages(args)
    tracker = MemTracker()
    tracker.track_external(*[a.to_local() if hasattr(a, "to_local") else a
                             for a in tree_leaves(args)
                             if isinstance(a, torch.Tensor)])
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    t0 = time.monotonic()
    with tracker:
        with counter, fallback, implicit_replication():
            out = fn(*args)
        peak = tracker.get_tracker_snapshot("peak")
    t_trace = time.monotonic() - t0
    out_storages = _storages(out)
    argument = sum(arg_storages.values())
    output = sum(out_storages.values())
    alias = sum(n for k, n in out_storages.items() if k in arg_storages)
    peak_bytes = int(peak.get(torch.device("meta"), {}).get("Total", 0))

    rec.update({
        "n_chips": mesh.size(),
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes_per_device": argument,
            "output_bytes_per_device": output,
            "temp_bytes_per_device": max(peak_bytes - argument - output
                                         + alias, 0),
            "alias_bytes_per_device": alias,
            "peak_bytes_per_device": peak_bytes,
        },
        "cost": {
            "flops_per_device": float(counter.flops),
            "bytes_accessed_per_device": float(counter.bytes_accessed),
            "transcendentals": None,
        },
        "collectives": counter.collectives().to_dict(),
        "dropped_shardings": sorted(set(rules.dropped)),
        "fallback_ops": dict(fallback.fallbacks),
        "fallback_collective_bytes": dict(fallback.collective_bytes),
        "fallback_sites": {op: dict(sites)
                           for op, sites in fallback.sites.items()},
        "model_params": cfg.param_count(),
        "model_active_params": cfg.active_param_count(),
        "tokens_per_step": shape.global_batch * (shape.seq_len
                                                 if shape.kind == "train"
                                                 else 1),
        "microbatches": microbatches,
    })
    if save:
        _save(rec)
    return rec


def _save(rec: Dict[str, Any]) -> None:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = OUT_DIR / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    combos = []
    archs = list(ARCHITECTURES) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = [s.name for s in INPUT_SHAPES] \
        if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                combos.append((a, s, mp))

    failures = 0
    for a, s, mp in combos:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        path = OUT_DIR / f"{a}__{s}__{mesh_name}.json"
        if args.skip_existing and path.exists():
            print(f"[skip] {a} {s} {mesh_name} (exists)")
            continue
        try:
            rec = run_one(a, s, multi_pod=mp)
            if not rec["applicable"]:
                print(f"[n/a ] {a:24s} {s:12s} {mesh_name}: "
                      f"{rec['skip_reason']}")
                continue
            mem = rec["memory"]["peak_bytes_per_device"] / 2**30
            fl = rec["cost"]["flops_per_device"]
            cb = rec["collectives"]["total_bytes"]
            print(f"[ ok ] {a:24s} {s:12s} {mesh_name}: "
                  f"peak {mem:.2f} GiB/dev, {fl:.3g} flops/dev, "
                  f"{cb/2**20:.1f} MiB collectives, "
                  f"trace {rec['trace_s']:.0f}s")
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            failures += 1
            print(f"[FAIL] {a} {s} {mesh_name}: {type(e).__name__}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run combinations failed")
    print("dry-run sweep complete")


if __name__ == "__main__":
    main()
