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

The embedding lookup (``models/layers.py::embed_tokens``) runs here
too, as GSPMD partitions the reference's ``params["embed"][tokens]``
(``vocab_lookup``): each rank looks its tokens up in the rows it holds
and zeros the rest, so the result is a partial sum over the axes that
split the vocab, and neither the lookup nor its gradient gathers the
table.

A local op's gradient goes back through ``to_local``, which gives it the
placements of the forward unless told otherwise.  Where the local op
reads only part of what it was given (the combine reads the weights of
this rank's experts' pairs alone, the lookup's gradient covers this
rank's tokens alone), the local gradient is a partial sum over the mesh
axes that split that part, and ``localize`` is given ``Partial()`` there
(``grad_placements``); else DTensor would take one rank's share for the
whole gradient.

``complete`` ends each sub-block on the mesh: a projection back to the
residual stream (attention's ``wo``, the MLPs' ``down`` / ``fc2``, the
SSM's ``out_proj``, the MoE combine, the lookup) contracts a dimension
that "model" splits, so DTensor leaves it a partial sum over "model";
``complete`` all-reduces it there, as XLA completes the reference's, so
that the residual stream stays whole over "model" between sub-blocks.
Left partial, it goes to the residual add, where DTensor's propagator
chooses: torch 2.13 carries it partial into the next layer in a
microbatched step (and reduces it onto a split of the batch in one
step), so q and k reach the attention as partial sums that it
completes at the scores' size.

``whole`` serves the GQA head splits, which cannot keep a split finer
than the KV heads (the query split of the kernels' plain versions and of
``models/attention.py::_sdpa``, the model's k/v split): it gathers only
the mesh axes that split that dimension.

On plain tensors (one device, the card or the CPU) nothing here runs:
the callers test ``isinstance(x, DTensor)`` first.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)


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


def localize(x, mesh, placements: Sequence[Placement],
             grad_placements: Optional[Sequence[Placement]] = None
             ) -> torch.Tensor:
    """``x`` redistributed to ``placements`` on ``mesh``, as this rank's
    local tensor; a plain tensor counts as replicated.  The local
    tensor's gradient comes back with ``grad_placements`` (by default
    ``placements``): ``Partial()`` on each mesh axis over which the local
    op's gradient is a partial sum (see the module docstring)."""
    return _redistributed(x, mesh, placements).to_local(
        grad_placements=None if grad_placements is None
        else tuple(grad_placements))


def _redistributed(x, mesh, placements: Sequence[Placement]) -> DTensor:
    """``x`` on ``placements``; ``x`` itself where it has them, so that a
    gradient ``to_local`` leaves partial reaches ``x`` unreduced (a
    redistribution's backward would reduce it to ``x``'s placements)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, tuple(placements))


def vocab_lookup(table: DTensor, tokens) -> DTensor:
    """``table[tokens]`` for a DTensor ``table`` (V, d), shard-local, as
    XLA partitions the reference's lookup: on each mesh axis that splits
    the rows (the vocab), the tokens are whole (gathered where they were
    split there: they are small), this rank looks up ``clamp(tok -
    first, 0, n - 1)`` in its rows ``[first, first + n)`` and zeros the
    tokens outside them, and the result is ``Partial()`` there: one
    all-reduce (or a reduce-scatter) when the next op needs it whole,
    and no gather of the table.  On an axis that
    splits the width d, the result is split on its last dimension, unless
    the tokens are split there too: then the table is gathered on that
    axis, as an FSDP weight is.  Elsewhere the result keeps the tokens'
    placements.  The gradient is a local ``index_put`` into this rank's
    rows, a partial sum over the axes that split the tokens (each rank's
    covers its own tokens), reduced by DTensor where the table is
    whole."""
    mesh = table.device_mesh
    tok = tokens if isinstance(tokens, DTensor) else DTensor.from_local(
        tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    out_dim = tok.ndim
    tab_pl, grad_pl, tok_pl, out_pl = [], [], [], []
    for p, t in zip(table.placements, tok.placements):
        if p.is_partial() or (p.is_shard() and p.dim not in (0, 1)):
            raise ValueError(f"the embedding table must be split on its "
                             f"rows or its width only: {table.placements}")
        if p.is_shard(1) and t.is_shard():
            p = Replicate()                  # an FSDP table: gathered here
        tab_pl.append(p)
        if p.is_shard(0):
            tok_pl.append(Replicate())
            out_pl.append(Partial())
            grad_pl.append(p)
        elif p.is_shard(1):
            tok_pl.append(t)
            out_pl.append(Shard(out_dim))
            grad_pl.append(p)
        else:
            tok_pl.append(t)
            out_pl.append(t)
            grad_pl.append(Partial() if t.is_shard() else Replicate())
    tab = _redistributed(table, mesh, tab_pl)
    first, n = shard_span(tab, 0)
    rows = tab.to_local(grad_placements=tuple(grad_pl))
    ids = localize(tok, mesh, tok_pl).long() - first
    inside = (ids >= 0) & (ids < n)
    out = torch.where(inside[..., None], rows[ids.clamp(0, n - 1)], 0)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def complete(x):
    """``x`` with its partial sums completed: on a DTensor, each
    ``Partial`` placement becomes ``Replicate()`` (one all-reduce over
    those axes) and the others are kept; anything else is returned as it
    is.  Its gradient needs nothing: a whole gradient is a valid partial
    one."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


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
