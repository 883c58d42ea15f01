"""AdamW with global-norm gradient clipping, and the cosine schedule
(PyTorch twin of ``src/repro/training/optimizer.py``), over the port's
param trees: nested dicts and lists of tensors.

The arithmetic is the reference's: the clip scale is ``min(1, clip /
(norm + 1e-9))`` over all gradients; the bias corrections use the step
after this one; the update ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
is computed in f32 and stored in the param dtype, with weight decay on
every leaf.  ``torch.optim.AdamW`` clips and schedules otherwise, so it is
not used.

Where the reference returns updates that the train step adds into a new
copy of the params, ``AdamW.update`` writes params and moments in place,
leaf by leaf: at full width (granite-3-2b in f32 holds 10.1 GB of params,
as much again in gradients and twice that in moments) a tree of updates
and a second copy of the params would not fit beside them on an 80 GB
card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Union

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(tree, leaves: List[torch.Tensor]):
    """A tree of ``tree``'s structure holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        return AdamWState(step=0, mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params))

    def _lr(self, step: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return self.learning_rate

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params) -> AdamWState:
        """One step: params, ``state.mu`` and ``state.nu`` are updated in
        place; ``grads`` is left as it is.  Returns the state with the step
        counted."""
        step = state.step + 1
        scale = None
        if self.grad_clip_norm is not None:
            scale = torch.clamp(
                self.grad_clip_norm / (global_norm(grads) + 1e-9), max=1.0)
        b1c = 1 - self.b1 ** step
        b2c = 1 - self.b2 ** step
        lr = self._lr(step)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            if scale is not None:
                g = g * scale
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            mhat = m.float() / b1c
            vhat = v.float() / b2c
            u = -lr * (mhat / (torch.sqrt(vhat) + self.eps)
                       + self.weight_decay * p.float())
            p.add_(u.to(p.dtype))
        return AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree_leaves(tree)))


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``floor * peak_lr`` at ``total_steps``."""
    def lr(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        prog = min(max((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5
                          * (1 + math.cos(math.pi * prog)))
    return lr
