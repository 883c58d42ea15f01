"""Hillclimb driver (PyTorch twin of ``src/repro/launch/hillclimb.py``):
tagged dry-run variants of three (arch x shape) pairs, each with a
hypothesis, reported through the roofline's raw terms
(``launch/roofline.py``, H100 constants).

Every line is a prediction of a dry run on torch's fake process group
(``launch/dryrun.py``), not a measurement.  Two properties of the port's
records bear on reading them:

  * the memory term comes from an unfused byte count, and the dry run
    runs the kernels' plain versions (meta tensors have no data for a
    kernel), so the int8 variant's plain decode, which dequantizes its
    cache into a float copy, may read more than the float one;
  * ``fallbacks`` counts the ops DTensor could not shard and ran
    replicated (``fallback_collective_bytes`` in the record says what
    their gathers carry); the dense cache write and the grouped MoE
    dispatch run shard-local, so the collective terms are those of the
    sharding plan.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --target granite-decode
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Optional, Sequence

from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import analyze


def _report(rec):
    a = analyze(rec, correct=False)  # raw terms: consistent A/B within a pair
    return (f"tag={rec['tag'] or 'baseline':14s} "
            f"compute={a['compute_s']*1e3:9.2f}ms memory={a['memory_s']*1e3:9.2f}ms "
            f"coll={a['collective_s']*1e3:9.2f}ms dominant={a['dominant']:10s} "
            f"peak={a['peak_gib_per_device']:7.2f}GiB "
            f"fallbacks={sum(rec.get('fallback_ops', {}).values())}")


# ---------------------------------------------------------------------------
# variants per target
# ---------------------------------------------------------------------------

def granite_decode():
    """H3: decode is memory-bound (KV cache streaming).  Changes:
    pet      — the live code (bf16 operands, f32 accumulation);
    kvquant8 — int8 KV cache with per-row scales: halves the resident
               cache bytes (the card's kernel reads int8; the dry run's
               plain version dequantizes a float copy).
    """
    yield dict(tag="pet")
    yield dict(tag="kvquant8",
               config_transform=lambda c: dataclasses.replace(c, kv_quant=True))


def deepseek_train():
    """H1: memory-bound; peak = full (L,L) scores + remat residuals.
    Changes:
    mb8       — 8 microbatches: activation batch 16→2 per ubatch;
    chunk512  — q-chunked attention: scores (L,L)→(512,L);
    mb8+chunk — both;
    +seqshard — also shard residual seq dim over 'model'.
    The reference's later tags (donation, dtype) have no torch meaning
    (the port updates in place); they keep their configs so that the
    tables line up.
    """
    yield dict(tag="mb8", microbatches=8)
    yield dict(tag="chunk512",
               config_transform=lambda c: dataclasses.replace(c, train_attn_chunk=512))
    yield dict(tag="mb8_chunk512", microbatches=8,
               config_transform=lambda c: dataclasses.replace(c, train_attn_chunk=512))
    yield dict(tag="mb8_chunk512_seqshard", microbatches=8,
               config_transform=lambda c: dataclasses.replace(
                   c, train_attn_chunk=512, shard_activations_seq=True))
    yield dict(tag="seqshard_donate",
               config_transform=lambda c: dataclasses.replace(
                   c, train_attn_chunk=512, shard_activations_seq=True))
    yield dict(tag="seqshard_donate_fsdp",
               rules_overrides={"embed": "data"},
               config_transform=lambda c: dataclasses.replace(
                   c, train_attn_chunk=512, shard_activations_seq=True))
    yield dict(tag="seqshard_dtype",
               config_transform=lambda c: dataclasses.replace(
                   c, train_attn_chunk=512, shard_activations_seq=True))
    yield dict(tag="seqshard_dtype_wide2d",
               rules_overrides={"ff": ("data", "model"),
                                "heads_x_dim": ("data", "model"),
                                "kv_heads_x_dim": ("data", "model"),
                                "vocab": ("data", "model")},
               config_transform=lambda c: dataclasses.replace(
                   c, train_attn_chunk=512, shard_activations_seq=True))


def qwen3_train():
    """H2: collective-bound by the MoE scatter's gathers.  Changes:
    g16        — dispatch_groups=16 (data-axis-aligned scatter);
    g16+mb4    — plus microbatching (also shrinks dispatch working set).
    The grouped dispatch runs on each device's own groups
    (``models/moe.py``), where the ungrouped one sorts the whole batch's
    pairs.
    """
    def set_groups(c, g, **kw):
        return dataclasses.replace(c, moe=dataclasses.replace(c.moe, dispatch_groups=g), **kw)
    yield dict(tag="g16", config_transform=lambda c: set_groups(c, 16))
    yield dict(tag="g16_mb4", microbatches=4,
               config_transform=lambda c: set_groups(c, 16))
    yield dict(tag="g16_mb4_seqshard_donate", microbatches=4,
               config_transform=lambda c: set_groups(c, 16, shard_activations_seq=True))


TARGETS = {
    "granite-decode": ("granite-3-2b", "decode_32k", granite_decode),
    "deepseek-train": ("deepseek-67b", "train_4k", deepseek_train),
    "qwen3-train": ("qwen3-moe-30b-a3b", "train_4k", qwen3_train),
}


def run(targets: Sequence[str], *, mesh=None,
        shape_transform: Optional[Callable] = None) -> None:
    """Each target's baseline (if its record exists) and variants, one
    report line each; a variant whose record exists is read, not rerun.
    ``mesh`` and ``shape_transform`` go to ``dryrun.run_one``."""
    mesh_name = dryrun._mesh_name(mesh, False, mesh is None)
    for t in targets:
        arch, shape, gen = TARGETS[t]
        print(f"=== {t}: {arch} × {shape} ===")
        base_path = os.path.join(dryrun.OUT_DIR,
                                 f"{arch}__{shape}__{mesh_name}.json")
        if os.path.exists(base_path):
            with open(base_path) as f:
                print("  " + _report(json.load(f)) + "   <- paper-faithful baseline")
        for variant in gen():
            tag = variant.pop("tag")
            done = os.path.join(dryrun.OUT_DIR,
                                f"{arch}__{shape}__{mesh_name}__{tag}.json")
            if os.path.exists(done):
                with open(done) as f:
                    print("  " + _report(json.load(f)) + "   (cached)", flush=True)
                continue
            overrides = variant.pop("rules_overrides", None)
            if overrides:
                variant["rules"] = ShardingRules.default(overrides)
            rec = dryrun.run_one(arch, shape, tag=tag, mesh=mesh,
                                 shape_transform=shape_transform, **variant)
            print("  " + _report(rec), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", choices=sorted(TARGETS) + ["all"], default="all")
    args = ap.parse_args(argv)
    run(sorted(TARGETS) if args.target == "all" else [args.target])


if __name__ == "__main__":
    main()
