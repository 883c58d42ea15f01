"""Model / run configuration dataclasses.

Every assigned architecture gets a ``ModelConfig`` in its own module under
``repro.configs``; the full-size config is exercised only via the dry-run
(ShapeDtypeStruct lowering), while ``reduced()`` variants run on CPU in the
smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    # Capacity factor for dense (one-hot einsum) dispatch.  tokens_per_expert
    # capacity = ceil(tokens * experts_per_token / num_experts) * capacity_factor
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Aux load-balance loss weight (Switch-style).
    aux_loss_weight: float = 0.01
    # Beyond-paper perf lever (EXPERIMENTS §Perf H2): dispatch tokens in
    # data-shard-aligned groups so the scatter stays shard-local and the
    # combine lowers to one all-reduce instead of full-token all-gathers.
    # Set to the data-axis size (16) for the production mesh.
    dispatch_groups: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD configuration."""
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 64  # SSD chunked-scan block length
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) models.

    The modality frontend (mel-spectrogram + conv subsampling) is a STUB per
    the assignment: ``input_specs`` provides precomputed frame embeddings of
    shape (batch, num_frames, d_model).
    """
    num_layers: int
    num_frames: int = 1500  # whisper 30s @ 50Hz after conv stride-2


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Vision frontend stub for VLMs: precomputed patch embeddings.

    anyres tiling (llava-next): base 576 tokens + up to 4 tiles of 576.
    """
    num_patch_tokens: int = 2880  # 576 * (1 base + 4 tiles)
    patch_embed_dim: Optional[int] = None  # defaults to d_model (projector stub)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # SWA window, None = full attention
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # hybrid (zamba2): 1 shared attention block applied every
    # ``hybrid_attn_every`` mamba blocks.
    hybrid_attn_every: int = 6
    # max output tokens used by the RWT estimator's conservative decode bound
    max_output_tokens: int = 2048
    # ---- perf levers (EXPERIMENTS.md §Perf; defaults = paper-baseline) ----
    # q-chunked train attention: peak activation (B,KVH,G,chunk,L) instead of
    # the full (L,L) score matrix.  None = single-shot attention.
    train_attn_chunk: Optional[int] = None
    # apply a with_sharding_constraint sharding the seq dim of activations
    # over the "model" axis between transformer blocks (cuts residual memory
    # by the TP degree at the cost of boundary collectives).
    shard_activations_seq: bool = False
    # int8 KV cache with per-(seq,head) scales (beyond-paper §Perf H3):
    # halves the decode memory-roofline term; the Pallas decode kernel
    # dequantizes in VMEM, the XLA fallback dequantizes at use.
    kv_quant: bool = False
    # route attention through the Pallas kernels (flash prefill/train,
    # blocked decode incl. the fused-dequant int8 variant, paged decode /
    # prefill-chunk block-table kernels).  Default off: on CPU they execute
    # interpret=True (correct but slow); on TPU they compile via Mosaic.
    use_pallas_attention: bool = False
    # KV pages fetched per grid step by the paged Pallas kernels (decode
    # AND prefill-chunk): multi-page tiles keep MXU tiles full when
    # block_size is small.  None auto-derives from block_size
    # (kernels.paged_decode_attention.auto_pages_per_tile targets 128-row
    # tiles); engines expose it via EngineConfig.pages_per_tile.
    paged_pages_per_tile: Optional[int] = None
    # citation / provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the vocab axis shards over
        the 16-way model mesh axis (GSPMD rejects uneven input shardings);
        padded logits are masked to -inf in ``unembed``."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.num_heads == 0:  # attention-free (ssm)
            return 0
        return self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic decode: SSM state, hybrid, or sliding-window."""
        return self.arch_type in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper via its decoder)

    def num_attention_layers(self) -> int:
        if self.arch_type == "ssm":
            return 0
        if self.arch_type == "hybrid":
            return self.num_layers // self.hybrid_attn_every
        return self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (used for swap-time modeling + roofline)."""
        d, h = self.d_model, self.resolved_head_dim
        attn = d * (self.num_heads * h) + 2 * d * (self.num_kv_heads * h) + (self.num_heads * h) * d
        if self.moe is not None:
            ffn = self.moe.num_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.num_experts
        else:
            ffn = 3 * d * self.d_ff  # gated (SwiGLU) MLP
        if self.arch_type == "ssm":
            per_layer = self._ssm_layer_params()
        elif self.arch_type == "hybrid":
            n_attn = self.num_attention_layers()
            n_ssm = self.num_layers - n_attn
            per_layer = 0
            total = n_ssm * self._ssm_layer_params() + n_attn * (attn + 3 * d * self.d_ff)
            emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
            return total + emb + self.num_layers * 2 * d
        else:
            per_layer = attn + ffn
        total = self.num_layers * (per_layer + 2 * d)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder is not None:
            enc_per_layer = 4 * d * d + 3 * d * self.d_ff + 2 * d
            total += self.encoder.num_layers * enc_per_layer
            # decoder cross-attention adds another attn block per layer
            total += self.num_layers * (4 * d * d)
        return total + emb

    def _ssm_layer_params(self) -> int:
        assert self.ssm is not None
        d = self.d_model
        di = self.ssm.d_inner(d)
        nh = self.ssm.num_heads(d)
        ns = self.ssm.d_state
        in_proj = d * (2 * di + 2 * self.ssm.n_groups * ns + nh)
        conv = self.ssm.conv_width * (di + 2 * self.ssm.n_groups * ns)
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * nh + di

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        active_ffn = self.num_layers * self.moe.experts_per_token * 3 * d * self.moe.d_ff_expert
        return dense + active_ffn

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                num_heads: int = 4, num_kv_heads: Optional[int] = None,
                d_ff: Optional[int] = None, vocab_size: int = 512,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant of the SAME family (2 layers, d_model<=512,
        <=4 experts) runnable on CPU."""
        kv = num_kv_heads if num_kv_heads is not None else max(1, min(self.num_kv_heads, num_heads))
        if kv > num_heads:
            kv = num_heads
        ff = d_ff if d_ff is not None else d_model * 4
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, max_experts),
                experts_per_token=min(self.moe.experts_per_token, 2),
                d_ff_expert=d_model,
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=min(self.ssm.d_state, 16),
                                      head_dim=32, chunk_size=16)
        enc = None
        if self.encoder is not None:
            enc = dataclasses.replace(self.encoder, num_layers=num_layers, num_frames=16)
        vis = None
        if self.vision is not None:
            vis = dataclasses.replace(self.vision, num_patch_tokens=8)
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=num_layers,
            d_model=d_model, num_heads=num_heads, num_kv_heads=kv, d_ff=ff,
            vocab_size=vocab_size, head_dim=None, moe=moe, ssm=ssm,
            encoder=enc, vision=vis, hybrid_attn_every=2,
            sliding_window=(64 if self.sliding_window is not None else None),
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch) input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode"),
)

INPUT_SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
