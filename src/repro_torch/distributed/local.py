"""Shard-local runs of the ops that DTensor shards badly.

Two places in the models work along an axis that the mesh splits into
pieces each device can handle alone: the dense KV cache's write along
``kv_seq`` (``models/attention.py``), where each shard writes the
columns it owns, and the MoE's grouped dispatch (``models/moe.py``),
whose sort, ranking, scatter and combine stay inside a group.  DTensor
has no sharding strategy for some of these ops (a scatter along a
sharded dimension; which others depends on torch's version), and
``comm_analysis.ReplicateFallback`` would then gather every input
whole.  These helpers run them on this rank's local tensors instead, as
``torch.distributed.tensor.experimental.local_map`` with
``redistribute_inputs`` does, in a form that torch 2.11 and 2.13 both
take: each input is redistributed to the placements the local op needs
(``localize``), the op runs on ``to_local()`` tensors (this rank's
shard; an in-place write lands in the DTensor's own storage), and a new
result is wrapped back with ``DTensor.from_local``.

``whole`` serves the kernels' plain versions, whose GQA head split
cannot keep a split finer than the KV heads: it gathers only the mesh
axes that split that dimension.

On plain tensors (one device, the card or the CPU) nothing here runs:
the callers test ``isinstance(x, DTensor)`` first.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate


def shard_span(t: DTensor, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's shard of ``t`` along tensor
    dimension ``dim``: the mesh axes that shard ``dim`` split it in
    placement order, the outer axis first, as ``distribute_tensor`` does.
    The dimension must divide evenly (the sharding rules' guard sees to
    that)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    index, pieces = 0, 1
    for mdim, p in enumerate(t.placements):
        if p.is_shard(dim):
            index = index * mesh.size(mdim) + coord[mdim]
            pieces *= mesh.size(mdim)
    size = t.shape[dim]
    if size % pieces:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"evenly into {pieces} shards")
    return index * (size // pieces), size // pieces


def localize(x, mesh, placements: Sequence[Placement]) -> torch.Tensor:
    """``x`` redistributed to ``placements`` on ``mesh``, as this rank's
    local tensor; a plain tensor counts as replicated."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, tuple(placements)).to_local()


def whole(x, dim: int):
    """``x`` with tensor dimension ``dim`` unsplit: on a DTensor, only the
    mesh axes that shard ``dim`` are gathered (a split of that dimension
    then needs nothing more, where ``ReplicateFallback`` would gather
    every axis); anything else is returned as it is."""
    if not isinstance(x, DTensor) or not any(p.is_shard(dim)
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim)
                                          else p for p in x.placements])
