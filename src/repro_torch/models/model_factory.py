"""Model interface of the port (twin of ``src/repro/models/model_factory.py``
for ``arch_type`` ``"dense"`` (the training loss and the chunked serving
paths) and ``"ssm"`` (mamba2: single-shot prefill and decode)).

``build_model(cfg)`` returns a ``Model`` with:
  * ``init(gen, dtype, device)``  -> params (random, from ``gen``)
  * ``loss(params, batch, remat=True)`` -> (scalar, metrics)
  * ``init_cache(batch, max_seq, dtype, device)`` -> dense per-slot caches
    (the SSM's conv and state)
  * ``decode_step(params, cache, tokens, lengths)``
  * ``prefill(params, batch, cache)`` -> (last logits, cache): single-shot
    prefill of ``batch["tokens"]`` into a dense per-slot cache
  * ``prefill_chunk(params, cache, tokens, starts, valid)``
  * ``init_paged_cache(num_blocks, block_size, dtype, device)`` -> page pools
  * ``prefill_chunk_paged(params, cache, tokens, starts, valid, block_table)``
  * ``decode_step_paged(params, cache, tokens, lengths, block_table)``
The last four are None for the SSM (its state carry needs single-shot
prefill; it has no pageable KV), as in the reference.  Every serving path
returns ``(logits, cache)`` and updates the cache in place;
``cfg.kv_quant`` makes every KV cache int8 with per-row scales.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm_lm, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    init_cache: Callable
    decode_step: Callable
    prefill: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    prefill_chunk_paged: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None


def build_model(cfg: ModelConfig) -> Model:
    if cfg.arch_type == "dense":
        return _build_transformer(cfg)
    if cfg.arch_type == "ssm":
        return _build_ssm(cfg)
    raise NotImplementedError(
        f"the port serves dense decoders and mamba2 only, got arch_type "
        f"{cfg.arch_type!r} ({cfg.name})")


def _build_transformer(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.float32, device="cuda":
            transformer.init_lm(gen, cfg, dtype, resolve_device(device)),
        loss=lambda params, batch, remat=True:
            transformer.loss_fn(params, cfg, batch, remat=remat),
        init_cache=lambda batch, max_seq, dtype=torch.float32, device="cuda":
            transformer.init_cache(cfg, batch, max_seq, dtype,
                                   resolve_device(device)),
        prefill=lambda params, batch, cache:
            transformer.prefill(params, cfg, batch["tokens"], cache),
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


def _build_ssm(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.float32, device="cuda":
            ssm_lm.init_ssm_lm(gen, cfg, dtype, resolve_device(device)),
        loss=lambda params, batch, remat=True:
            ssm_lm.loss_fn(params, cfg, batch, remat=remat),
        init_cache=lambda batch, max_seq, dtype=torch.float32, device="cuda":
            ssm_lm.init_state(cfg, batch, max_seq, dtype,
                              resolve_device(device)),
        decode_step=lambda params, cache, tokens, lengths:
            ssm_lm.decode_step(params, cfg, tokens, lengths, cache),
        prefill=lambda params, batch, cache:
            ssm_lm.prefill(params, cfg, batch["tokens"], cache),
    )
