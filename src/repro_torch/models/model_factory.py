"""Model interface of the port (twin of ``src/repro/models/model_factory.py``
for every ``arch_type``: ``"dense"``, ``"moe"`` and ``"vlm"`` (the
transformer: the training loss and every serving path), ``"ssm"``
(mamba2), ``"hybrid"`` (zamba2) and ``"audio"`` (the whisper
encoder-decoder), the last three with the training loss, single-shot
prefill and decode).

``build_model(cfg)`` returns a ``Model`` with:
  * ``init(gen, dtype, device)``  -> params (random, from ``gen``)
  * ``param_axes()`` -> the params' tree with a tuple of logical axis
    names at each leaf (``distributed/sharding.py``)
  * ``cache_axes()`` -> the same for ``init_cache``'s tree
  * ``eval_shape_params(dtype)`` -> the params as ``meta`` tensors: their
    shapes and dtypes, nothing allocated (the dry run's)
  * ``loss(params, batch, remat=True)`` -> (scalar, metrics)
  * ``init_cache(batch, max_seq, dtype, device)`` -> dense per-slot caches
    (the SSM's conv and state; the hybrid's also its sites' KV under
    ``"kv"``; the encoder-decoder's self caches under ``"self"`` and its
    cross K/V)
  * ``decode_step(params, cache, tokens, lengths)``
  * ``prefill(params, batch, cache)`` -> (last logits, cache): single-shot
    prefill of ``batch["tokens"]`` (after a VLM's ``batch["patch_embeds"]``;
    an encoder-decoder's decoder after its encoder over
    ``batch["frame_embeds"]``) into a dense per-slot cache
  * ``prefill_chunk(params, cache, tokens, starts, valid)``
  * ``init_paged_cache(num_blocks, block_size, dtype, device)`` -> page pools
  * ``prefill_chunk_paged(params, cache, tokens, starts, valid, block_table)``
  * ``decode_step_paged(params, cache, tokens, lengths, block_table)``,
    on CUDA tensors replayed from a CUDA graph captured on first use
    (``models/decode_graph.py``; ``.eager`` is the step run op by op)
The last four are None for the SSM and the hybrid (their state carry
needs single-shot prefill; they have no pageable KV) and for the
encoder-decoder (its cross-attention), as in the reference.  The loss of
a VLM takes ``batch["patch_embeds"]`` and that of an encoder-decoder
``batch["frame_embeds"]`` beside the tokens.  Every serving path
returns ``(logits, cache)`` and updates the cache in place;
``cfg.kv_quant`` makes every KV cache int8 with per-row scales.
``batch_struct`` / ``materialize_batch`` give one step's data inputs,
the modality stubs included, as shapes or as random tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models.decode_graph import DecodeGraphs


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    param_axes: Callable
    loss: Callable
    init_cache: Callable
    cache_axes: Callable
    decode_step: Callable
    prefill: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    prefill_chunk_paged: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None

    def eval_shape_params(self, dtype: torch.dtype = torch.float32):
        """The params on the ``meta`` device: shapes and dtypes without
        allocation (the reference's ``jax.eval_shape`` of ``init``)."""
        return self.init(torch.Generator(device="cpu"), dtype, "meta")


def _kv_cache_axes_tree(cfg):
    """Logical axes of a stacked dense KV cache, (layers, B, KVH, S, D),
    the reference's: ``kv_seq`` shards over "model" where S divides it."""
    ax = (None, "batch", "kv_heads", "kv_seq", None)
    tree = {"k": ax, "v": ax}
    if cfg.kv_quant:
        sax = (None, "batch", "kv_heads", "kv_seq")
        tree["k_scale"] = sax
        tree["v_scale"] = sax
    return tree


def _ssm_state_axes():
    return {"conv": (None, "batch", None, "ssm_inner"),
            "ssm": (None, "batch", "ssm_heads", None, None)}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.arch_type in ("dense", "moe", "vlm"):
        return _build_transformer(cfg)
    if cfg.arch_type == "ssm":
        return _build_ssm(cfg)
    if cfg.arch_type == "hybrid":
        return _build_hybrid(cfg)
    if cfg.arch_type == "audio":
        return _build_encdec(cfg)
    raise ValueError(f"unknown arch_type {cfg.arch_type}")


def _build_transformer(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.float32, device="cuda":
            transformer.init_lm(gen, cfg, dtype, resolve_device(device)),
        param_axes=lambda: transformer.lm_param_axes(cfg),
        cache_axes=lambda: _kv_cache_axes_tree(cfg),
        loss=lambda params, batch, remat=True:
            transformer.loss_fn(params, cfg, batch, remat=remat),
        init_cache=lambda batch, max_seq, dtype=torch.float32, device="cuda":
            transformer.init_cache(cfg, batch, max_seq, dtype,
                                   resolve_device(device)),
        prefill=lambda params, batch, cache:
            transformer.prefill(params, cfg, batch["tokens"], cache,
                                patch_embeds=batch.get("patch_embeds")),
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
        decode_step_paged=DecodeGraphs(
            lambda params, cache, tokens, lengths, block_table:
            transformer.decode_step_paged(params, cfg, tokens, lengths,
                                          block_table, cache)),
    )


def _build_ssm(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.float32, device="cuda":
            ssm_lm.init_ssm_lm(gen, cfg, dtype, resolve_device(device)),
        param_axes=lambda: ssm_lm.ssm_lm_param_axes(cfg),
        cache_axes=_ssm_state_axes,
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


def _build_hybrid(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.float32, device="cuda":
            hybrid.init_hybrid_lm(gen, cfg, dtype, resolve_device(device)),
        param_axes=lambda: hybrid.hybrid_param_axes(cfg),
        cache_axes=lambda: {**_ssm_state_axes(),
                            "kv": _kv_cache_axes_tree(cfg)},
        loss=lambda params, batch, remat=True:
            hybrid.loss_fn(params, cfg, batch, remat=remat),
        init_cache=lambda batch, max_seq, dtype=torch.float32, device="cuda":
            hybrid.init_state(cfg, batch, max_seq, dtype,
                              resolve_device(device)),
        decode_step=lambda params, cache, tokens, lengths:
            hybrid.decode_step(params, cfg, tokens, lengths, cache),
        prefill=lambda params, batch, cache:
            hybrid.prefill(params, cfg, batch["tokens"], cache),
    )


_CROSS_AXES = (None, "batch", "kv_heads", None, None)


def _build_encdec(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.float32, device="cuda":
            encdec.init_encdec_lm(gen, cfg, dtype, resolve_device(device)),
        param_axes=lambda: encdec.encdec_param_axes(cfg),
        cache_axes=lambda: {"self": _kv_cache_axes_tree(cfg),
                            "cross_k": _CROSS_AXES, "cross_v": _CROSS_AXES},
        loss=lambda params, batch, remat=True:
            encdec.loss_fn(params, cfg, batch, remat=remat),
        init_cache=lambda batch, max_seq, dtype=torch.float32, device="cuda":
            encdec.init_cache(cfg, batch, max_seq, dtype,
                              resolve_device(device)),
        decode_step=lambda params, cache, tokens, lengths:
            encdec.decode_step(params, cfg, tokens, lengths, cache),
        prefill=lambda params, batch, cache:
            encdec.prefill(params, cfg, batch["tokens"], cache,
                           batch.get("frame_embeds")),
    )


# ---------------------------------------------------------------------------
# modality stubs for one step's inputs
# ---------------------------------------------------------------------------

def batch_struct(cfg: ModelConfig, batch: int, seq: int, kind: str,
                 dtype: torch.dtype = torch.float32
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of one step's data inputs (``kind``:
    ``"train"``, ``"prefill"`` or ``"decode"``), the reference's
    ``batch_struct``; a VLM's prefill spends ``num_patch_tokens`` of
    ``seq`` on the patch prefix, and an encoder-decoder's step carries
    its ``num_frames`` frame embeddings beside the tokens."""
    def patches():
        return ((batch, cfg.vision.num_patch_tokens,
                 cfg.vision.patch_embed_dim or cfg.d_model), dtype)

    if kind in ("train", "prefill"):
        if kind == "train":
            out = {"tokens": ((batch, seq + 1), torch.int32)}
        else:
            n_text = seq
            if cfg.vision is not None:
                n_text = max(seq - cfg.vision.num_patch_tokens, 1)
            out = {"tokens": ((batch, n_text), torch.int32)}
        if cfg.vision is not None:
            out["patch_embeds"] = patches()
        if cfg.encoder is not None:
            out["frame_embeds"] = ((batch, cfg.encoder.num_frames,
                                    cfg.d_model), dtype)
        return out
    if kind == "decode":
        return {"tokens": ((batch,), torch.int32),
                "lengths": ((batch,), torch.int32)}
    raise ValueError(kind)


def materialize_batch(cfg: ModelConfig, batch: int, seq: int, kind: str,
                      gen: torch.Generator, dtype: torch.dtype = torch.float32,
                      device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """Random tensors of ``batch_struct``'s shapes on ``device``, drawn
    from ``gen`` (a generator of that device): token ids uniform over the
    vocab, ``lengths`` at ``seq - 1``, embeddings normal at 0.02."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, dt) in batch_struct(cfg, batch, seq, kind,
                                          dtype).items():
        if not dt.is_floating_point:
            if name == "lengths":
                out[name] = torch.full(shape, seq - 1, dtype=dt, device=dev)
            else:
                out[name] = torch.randint(0, cfg.vocab_size, shape,
                                          generator=gen, dtype=dt, device=dev)
        else:
            out[name] = (torch.randn(shape, generator=gen,
                                     dtype=torch.float32, device=dev)
                         * 0.02).to(dt)
    return out
