"""The dry run with one shard-local part of the model's mesh path put back
to its plain form, to say what that part changes in a record: its
collective bytes, fallbacks, flops and peak (``launch/dryrun.py``;
predictions, not measurements).

Parts (``--without``):

  * ``lookup``: the embedding lookup as a plain index into the
    vocab-split table (``models/layers.py::embed_tokens`` before the
    vocab-parallel lookup): DTensor gathers the table;
  * ``lookup-reduce``: the vocab-parallel lookup's partial sum left to
    the next op, which DTensor may reduce-scatter over the width, where
    ``embed_tokens`` all-reduces it (XLA's lowering of the reference);
  * ``kv-split``: the k/v projections split into KV heads by a plain
    view (``models/attention.py::_split_heads`` without its ``whole``);
  * ``query-split``: ``models/attention.py::_sdpa`` run by DTensor, its
    query heads split into KV groups by a plain view, where it runs on
    each device's own query heads (``_sdpa_local``);
  * ``router-grad``: the MoE's local inputs localized without
    ``grad_placements`` (``models/moe.py``), so the gradients of the
    combine's weights and of the dispatch's tokens are taken for whole
    where they are this rank's share;
  * ``microbatch-split``: a microbatch left as DTensor's slice, gathered
    whole (``training/train_step.py::_rows`` without its re-split).

``none`` is the record as the tree makes it.  Each part is put back by
replacing one function for the duration of its record.

  PYTHONPATH=src python -m repro_torch.launch.ablate --arch qwen3-moe-30b-a3b \\
      --shape train_4k --tag g16 --without none kv-split query-split
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
from typing import Dict, Iterator, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import local
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, layers, moe
from repro_torch.training import train_step


def _plain_lookup(params, tokens):
    return params["embed"][tokens.long()]


def _partial_lookup(params, tokens):
    table = params["embed"]
    if isinstance(table, DTensor):
        return local.vocab_lookup(table, tokens)
    return table[tokens.long()]


def _plain_split(x, heads, hd):
    return x.reshape(*x.shape[:-1], heads, hd)


def _plain_sdpa(q, k, v, mask):
    B, H, Lq, D = q.shape
    KVH = k.shape[1]
    qg = q.reshape(B, KVH, H // KVH, Lq, D)
    scores = torch.matmul(qg.float(), k[:, :, None].float().transpose(
        -1, -2)) * (1.0 / math.sqrt(D))
    if mask is not None:
        scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v[:, :, None])
    return out.reshape(B, H, Lq, D).to(v.dtype)


def _no_grad_placements(x, mesh, placements, grad_placements=None):
    return local.localize(x, mesh, placements)


def _slice(v, lo, hi):
    return v[lo:hi]


PARTS = {
    "lookup": (layers, "embed_tokens", _plain_lookup),
    "lookup-reduce": (layers, "embed_tokens", _partial_lookup),
    "kv-split": (attention, "_split_heads", _plain_split),
    "query-split": (attention, "_sdpa", _plain_sdpa),
    "router-grad": (moe, "localize", _no_grad_placements),
    "microbatch-split": (train_step, "_rows", _slice),
}


@contextlib.contextmanager
def without(part: str) -> Iterator[None]:
    """Inside the block, ``part`` (a key of ``PARTS``, or ``none``) runs
    its plain form."""
    if part == "none":
        yield
        return
    module, name, plain = PARTS[part]
    saved = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, saved)


def variant(arch: str, shape: str, tag: str) -> Dict:
    """``run_one``'s keywords for hillclimb's variant ``tag`` of (arch,
    shape) (empty for the baseline, ``tag`` "")."""
    if not tag:
        return {}
    for a, s, gen in hillclimb.TARGETS.values():
        if (a, s) == (arch, shape):
            for v in gen():
                if v["tag"] == tag:
                    v = dict(v)
                    overrides = v.pop("rules_overrides", None)
                    if overrides:
                        v["rules"] = ShardingRules.default(overrides)
                    return v
    raise ValueError(f"hillclimb has no variant {tag!r} of {arch} {shape}")


def summary(rec) -> Dict:
    return {"tag": rec["tag"],
            "collectives": rec["collectives"]["bytes_by_op"],
            "total_bytes": rec["collectives"]["total_bytes"],
            "fallback_ops": rec["fallback_ops"],
            "fallback_collective_bytes": rec["fallback_collective_bytes"],
            "fallback_sites": rec["fallback_sites"],
            "flops_per_device": rec["cost"]["flops_per_device"],
            "peak_bytes_per_device": rec["memory"]["peak_bytes_per_device"]}


def run(arch: str, shape: str, tag: str, part: str, *,
        mesh=None, shape_transform=None,
        config_transform=None) -> Dict:
    """One record of (arch, shape, hillclimb tag) without ``part``."""
    kw = variant(arch, shape, tag)
    if config_transform is not None:
        inner = kw.get("config_transform")
        kw["config_transform"] = config_transform if inner is None else (
            lambda c: config_transform(inner(c)))
    with without(part):
        return dryrun.run_one(arch, shape, save=False, mesh=mesh,
                              shape_transform=shape_transform, **kw)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", default="", help="a hillclimb variant")
    ap.add_argument("--without", nargs="+", default=["none"],
                    choices=["none"] + sorted(PARTS))
    args = ap.parse_args(argv)
    try:
        for part in args.without:
            rec = run(args.arch, args.shape, args.tag, part)
            print(json.dumps(dict(without=part, torch=torch.__version__,
                                  **summary(rec))), flush=True)
    finally:
        mesh_lib.release()


if __name__ == "__main__":
    main()
