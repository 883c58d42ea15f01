"""Model interface of the port (twin of ``src/repro/models/model_factory.py``
for ``arch_type == "dense"``: the training loss and the chunked serving
paths).

``build_model(cfg)`` returns a ``Model`` with:
  * ``init(gen, dtype, device)``  -> params (random, from ``gen``)
  * ``loss(params, batch, remat=True)`` -> (scalar, metrics)
  * ``init_cache(batch, max_seq, dtype, device)`` -> dense per-slot caches
  * ``prefill_chunk(params, cache, tokens, starts, valid)``
  * ``decode_step(params, cache, tokens, lengths)``
  * ``init_paged_cache(num_blocks, block_size, dtype, device)`` -> page pools
  * ``prefill_chunk_paged(params, cache, tokens, starts, valid, block_table)``
  * ``decode_step_paged(params, cache, tokens, lengths, block_table)``
Every serving path returns ``(logits, cache)`` and updates the cache in
place; ``cfg.kv_quant`` makes every cache int8 with per-row scales.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    init_cache: Callable
    prefill_chunk: Callable
    decode_step: Callable
    init_paged_cache: Callable
    prefill_chunk_paged: Callable
    decode_step_paged: Callable


def build_model(cfg: ModelConfig) -> Model:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"the port serves dense decoders only, got arch_type "
            f"{cfg.arch_type!r} ({cfg.name})")
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.float32, device="cuda":
            transformer.init_lm(gen, cfg, dtype, resolve_device(device)),
        loss=lambda params, batch, remat=True:
            transformer.loss_fn(params, cfg, batch, remat=remat),
        init_cache=lambda batch, max_seq, dtype=torch.float32, device="cuda":
            transformer.init_cache(cfg, batch, max_seq, dtype,
                                   resolve_device(device)),
        prefill_chunk=lambda params, cache, tokens, starts, valid:
            transformer.prefill_chunk(params, cfg, tokens, starts, valid,
                                      cache),
        decode_step=lambda params, cache, tokens, lengths:
            transformer.decode_step(params, cfg, tokens, lengths, cache),
        init_paged_cache=lambda num_blocks, block_size, dtype=torch.float32,
        device="cuda": transformer.init_paged_cache(
            cfg, num_blocks, block_size, dtype, resolve_device(device)),
        prefill_chunk_paged=lambda params, cache, tokens, starts, valid,
        block_table: transformer.prefill_chunk_paged(
            params, cfg, tokens, starts, valid, block_table, cache),
        decode_step_paged=lambda params, cache, tokens, lengths, block_table:
            transformer.decode_step_paged(params, cfg, tokens, lengths,
                                          block_table, cache),
    )
