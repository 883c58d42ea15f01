"""Random weights from the seed, made by the benchmark and handed to both
sides: the port serves them, the family's reference reads the same
tensors once the window has closed.

A family's ``make_weights`` (``families/<family>.py``) draws them on the
device with one ``torch.Generator`` of that device (``generator``), one
call per kind of leaf over all layers at once (``draw``), in the dtype
they are served in, and lays them out as the port's parameter tree
(``models/transformer.py``: ``x @ w`` with ``w`` of shape (in, out), one
dict per layer; a layer's leaf is a view of the stacked draw).  Normal at
the port's initializer scales: ``1/sqrt(fan_in)`` for projections, 0.02
for the embedding, ones for the norms.
"""
from __future__ import annotations

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def draw(gen: torch.Generator, shape, std: float, dtype, device
         ) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(std)


def padded_vocab(vocab_size: int) -> int:
    """The embedding's rows: the vocabulary padded to a multiple of 256,
    as the port pads it (``ModelConfig.padded_vocab``); the padding's
    logits are masked, and the reference reads the real rows only."""
    return -(-vocab_size // 256) * 256
