"""Shard-local runs of the ops that DTensor shards badly.

Several places in the models work along an axis that the mesh splits
into pieces each device can handle alone: the dense KV cache's write
along ``kv_seq`` (``models/attention.py``), where each shard writes the
columns it owns; attention on a mesh (``models/attention.py::
_sdpa_local``), where each device attends its own query heads against
their KV heads, as XLA splits the reference's heads over KV heads and
groups at once; and the MoE (``models/moe.py``), whose router runs on
each device's tokens and whose grouped dispatch's sort, ranking, scatter
and combine stay inside a device's groups and experts.  DTensor has no
sharding strategy for some of these ops (a scatter along a sharded
dimension; which others depends on torch's version), or one that
gathers what XLA never does (a query cut from its KV head, the dispatch
buffer's gradient), and ``comm_analysis.ReplicateFallback`` would gather
every input of an op it cannot shard.  These helpers run them on this
rank's local tensors instead, as
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
this rank's experts' pairs alone and the dispatch its experts' rows,
attention a KV head for this rank's query heads alone, the lookup's
gradient covers this rank's tokens alone), the local gradient is a
partial sum over the mesh axes that split that part, and ``localize`` is
given ``Partial()`` there (``grad_placements``); else DTensor would take
one rank's share for the whole gradient.

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

``complete_grad`` is its counterpart in the backward: the projections
out of a sub-block's input leave that input's gradient a partial sum
over "model", which one all-reduce completes there, as XLA completes
the reference's, so that the residual stream's gradient stays whole
over "model" too.

``whole`` serves the splits that must gather a dimension: the GQA k/v
split, which cannot keep a split finer than the KV heads, and the query
split of the kernels' plain versions (it gathers only the mesh axes that
split that dimension); and a residual split on the sequence
(``shard_activations_seq``), gathered once at the top of each
sub-block (``models/transformer.py::_sub_block_input``).

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
    dimension ``dim`` (``span`` of its placements)."""
    return span(t.device_mesh, t.placements, dim, t.shape[dim])


def span(mesh, placements: Sequence[Placement], dim: int,
         size: int) -> Tuple[int, int]:
    """(first index, length) of this rank's shard along tensor dimension
    ``dim`` of length ``size`` on ``placements``: the mesh axes that
    shard ``dim`` split it in placement order, the outer axis first, as
    ``distribute_tensor`` does.  The dimension must divide evenly (the
    sharding rules' guard sees to that)."""
    coord = mesh.get_coordinate()
    index, pieces = 0, 1
    for mdim, p in enumerate(placements):
        if p.is_shard(dim):
            index = index * mesh.size(mdim) + coord[mdim]
            pieces *= mesh.size(mdim)
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
    op's gradient is a partial sum (see the module docstring); where
    ``x`` had the placements, in the memory layout of its local tensor
    (``_GradInLayout``)."""
    there = placed(x, mesh, placements)
    local = there.to_local(grad_placements=None if grad_placements is None
                           else tuple(grad_placements))
    return _GradInLayout.apply(local) if there is x else local


class _GradInLayout(torch.autograd.Function):
    """The identity, whose gradient comes back in its input's memory
    layout (copied where the local op left it in another, as attention's
    products leave k's): DTensor takes a DTensor's gradient to have the
    DTensor's layout, plans a view of it on that (the k projection's
    backward: a local view that then fails and falls back), and copies a
    ``Partial`` one into another layout by a reduce-scatter onto some
    dimension and a shuffle back.  (``localize`` applies it where it
    hands over the DTensor's own local tensor: a redistribution's output
    keeps no layout.)"""

    @staticmethod
    def forward(ctx, x):
        ctx.stride = x.stride()
        # its dimensions, outermost first
        ctx.order = sorted(range(x.ndim), key=lambda d: -x.stride(d))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if grad.stride() == ctx.stride:
            return grad
        return torch.empty_permuted(grad.shape, ctx.order, dtype=grad.dtype,
                                    device=grad.device).copy_(grad)


def placed(x, mesh, placements: Sequence[Placement]) -> DTensor:
    """``x`` on ``placements`` (a plain tensor counts as replicated);
    ``x`` itself where it has them, so that a partial gradient reaches
    ``x`` unreduced (a redistribution's backward, even to the same
    placements, would reduce it to ``x``'s)."""
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
    tab = placed(table, mesh, tab_pl)
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


def complete_grad(x):
    """``x``, whose gradient, where it comes back a partial sum, is
    completed by one all-reduce over those axes (the backward of a
    DTensor's redistribution to its own placements, a no-op forward);
    anything else is returned as it is.  ``complete``'s counterpart in
    the backward: each projection out of a sub-block's input leaves that
    input's gradient a partial sum over "model", which is completed
    there, as XLA completes the reference's, so that the residual
    stream's gradient stays whole over "model" too."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


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
