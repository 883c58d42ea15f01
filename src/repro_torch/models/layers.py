"""Shared building blocks: initializers, norms (RMS and layer norm), RoPE,
the SwiGLU and GELU MLPs, sinusoidal positions, embedding, the
vocab-padding mask and the attention masks (PyTorch twins of
``src/repro/models/layers.py``); and the two pieces every model's
training loss shares, the remat boundary and the next-token
cross-entropy.

Model code is functional: ``init_*`` builds nested dicts of tensors and the
forward functions consume them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.local import complete, vocab_lookup


# ---------------------------------------------------------------------------
# initializers (same distributions and scales as the reference; the
# numbers differ, since torch's generator is not JAX's)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Truncated-normal fan-in init: std 1/sqrt(in_dim), cut at 2 std."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def init_swiglu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                    dtype: torch.dtype, device: torch.device):
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype, device),
        "up": dense_init(gen, d_model, d_ff, dtype, device),
        "down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype, device: torch.device):
    """Whisper-style two-matrix GELU MLP (with biases, zero at init)."""
    return {
        "fc1": dense_init(gen, d_model, d_ff, dtype, device),
        "b1": torch.zeros(d_ff, dtype=dtype, device=device),
        "fc2": dense_init(gen, d_ff, d_model, dtype, device),
        "b2": torch.zeros(d_model, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def mask_padded_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mask the vocab-padding tail (see ModelConfig.padded_vocab) to -1e30."""
    if logits.shape[-1] == vocab_size:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(idx >= vocab_size, -1e30)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in f32 with the population variance, as the reference's
    ``jnp.var``."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs        # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["gate"])
    return complete((gate * (x @ params["up"])) @ params["down"])


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, the default of the reference's
    ``jax.nn.gelu``."""
    h = F.gelu(x @ params["fc1"] + params["b1"], approximate="tanh")
    return complete(h @ params["fc2"]) + params["b2"]


def sinusoidal_positions(length: int, dim: int,
                         device=None) -> torch.Tensor:
    """(length, dim) fixed sinusoidal embeddings (whisper's encoder), f32."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2 * idx / dim))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    """``params["embed"][tokens]``, every model's lookup.  On a DTensor
    table (the dry run's mesh) it runs shard-local
    (``distributed/local.py::vocab_lookup``), with no gather of the
    vocab-split table forward or backward, and its partial sum is
    completed by one all-reduce of the output, as XLA lowers the
    reference's lookup: the activations then stay whole over "model", as
    the reference's rules keep them ("embed" on no axis)."""
    table = params["embed"]
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    return complete(vocab_lookup(table, tokens))


def unembed(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab; with ``tie_embeddings`` the output
    projection is the embedding's transpose."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mask_padded_logits(x @ w, cfg.vocab_size)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` under ``torch.utils.checkpoint``, which
    keeps only the inputs and reruns ``fn`` in the backward pass (the
    reference's ``jax.checkpoint``)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def next_token_ce(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross-entropy of f32 ``logits`` (B, L, V) against integer
    ``targets`` (B, L), a 0-dim tensor.  Both terms keep their (B, L, 1)
    shape up to the mean: on vocab-sharded DTensor logits (the dry run)
    the gathered gold logits are a masked partial sum, which DTensor can
    reduce only in the shape it was gathered in, and the normalizer is
    vocab-parallel, as XLA partitions the reference's ``logsumexp``: the
    shards' max and their sum of exponentials are each completed by one
    all-reduce of (B, L, 1) (``torch.logsumexp`` on such logits would
    gather them whole over the vocab)."""
    if isinstance(logits, DTensor):
        top = complete(logits.detach().amax(dim=-1, keepdim=True))
        logz = top + torch.log(complete(
            torch.exp(logits - top).sum(dim=-1, keepdim=True)))
    else:
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    gold = torch.gather(logits, -1, targets[..., None])
    return torch.mean(logz - gold)


def tied_lm_loss(params, cfg, hidden: torch.Tensor, targets: torch.Tensor):
    """The loss of an LM whose output projection is its embedding's
    transpose and which has no aux loss (mamba2, the hybrid, the
    encoder-decoder): (ce, {"ce", "aux": 0}), the logits f32 and masked to
    the real vocab."""
    logits = mask_padded_logits((hidden @ params["embed"].T).float(),
                                cfg.vocab_size)
    ce = next_token_ce(logits, targets)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


def causal_mask(q_len: int, kv_len: int, q_offset: int,
                device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask; True = attend.  q_offset = absolute
    position of the first query."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def sliding_window_mask(q_len: int, kv_len: int, q_offset: int, window: int,
                        device=None) -> torch.Tensor:
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos) & (kv_pos > q_pos - window)
