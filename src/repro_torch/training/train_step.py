"""Training step factory: loss, AdamW and (optionally) microbatch gradient
accumulation (PyTorch twin of ``src/repro/training/train_step.py``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.local import placed
from repro_torch.models.model_factory import Model
from repro_torch.training.optimizer import (AdamW, AdamWState, global_norm,
                                            tree_leaves, tree_unflatten)


def _rows(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of a batch leaf.  DTensor gathers a slice of a
    split dimension whole; on a DTensor split over its batch the slice is
    split back over the same axes (a local chunk of what every rank now
    holds), so that each microbatch runs data-parallel, as the reference's
    reshape into microbatches does under GSPMD."""
    part = v[lo:hi]
    if isinstance(v, DTensor) and part.placements != v.placements:
        part = part.redistribute(v.device_mesh, v.placements)
    return part


def _locals(leaves, like=None):
    """The local tensors of DTensor leaves, the plain ones as they are: an
    op on them keeps each leaf's placements, so that a gradient's partial
    sum over the microbatches stays partial, reduced once (``_reduced``);
    DTensor's own add reduces each microbatch's under some torch
    versions.  Each leaf must have the placements of its twin in
    ``like``."""
    for i, t in enumerate(leaves):
        if like is not None and isinstance(t, DTensor) \
                and t.placements != like[i].placements:
            raise ValueError(f"a microbatch's gradient came back on "
                             f"{t.placements}, the first's on "
                             f"{like[i].placements}")
    return [t.to_local() if isinstance(t, DTensor) else t for t in leaves]


def _reduced(grads, params):
    """Each DTensor gradient on its parameter's placements: its partial
    sums (over the batch's axes, and the axes that split what a local op
    read) reduced once, here, as XLA reduces the reference's, where the
    norm's and the optimizer's every use of a partial gradient would
    reduce it again.  Plain gradients are returned as they are."""
    leaves = tree_leaves(grads)
    if not any(isinstance(g, DTensor) for g in leaves):
        return grads
    return tree_unflatten(params, [
        placed(g, p.device_mesh, p.placements) if isinstance(g, DTensor)
        else g for g, p in zip(leaves, tree_leaves(params))])


def make_train_step(model: Model, opt: AdamW, *, microbatches: int = 1,
                    remat: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``batch`` is ``{"tokens": (B, S+1)}`` on the
    params' device, and ``metrics`` holds 0-dim tensors ``loss``,
    ``grad_norm`` (before clipping), ``ce`` and ``aux``.

    The params are updated in place (``AdamW.update``) and returned.  With
    ``microbatches > 1`` the batch is split on axis 0 and the mean of the
    microbatches' gradients is applied: the memory-vs-time knob of the
    reference.
    """

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = model.loss(params, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    def single(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]
               ) -> Tuple[object, AdamWState, Dict[str, torch.Tensor]]:
        loss, metrics, grads = value_and_grad(params, batch)
        grads = _reduced(grads, params)
        metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads))
        opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, metrics

    if microbatches == 1:
        return single

    def accumulated(params, opt_state: AdamWState,
                    batch: Dict[str, torch.Tensor]
                    ) -> Tuple[object, AdamWState, Dict[str, torch.Tensor]]:
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             f"microbatches")
        n = b // microbatches
        acc, loss_sum = None, 0.0
        for i in range(microbatches):
            mb = {k: _rows(v, i * n, (i + 1) * n) for k, v in batch.items()}
            loss, _, grads = value_and_grad(params, mb)
            if acc is None:
                acc = tree_leaves(grads)
            else:
                torch._foreach_add_(_locals(acc), _locals(
                    tree_leaves(grads), like=acc))
            loss_sum = loss_sum + loss
        torch._foreach_div_(_locals(acc), float(microbatches))
        grads = _reduced(tree_unflatten(params, acc), params)
        loss = loss_sum / microbatches
        metrics = {"loss": loss, "grad_norm": global_norm(grads), "ce": loss,
                   "aux": torch.zeros((), dtype=torch.float32,
                                      device=loss.device)}
        opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, metrics

    return accumulated
