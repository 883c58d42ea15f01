"""Mamba2 (SSD, state-space duality) block (PyTorch twin of
``src/repro/models/ssm.py``).

Discretized recurrence, per head h with scalar decay A_h < 0:

    a_t = exp(dt_t * A)                       (scalar per head)
    h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t  (state: (N, P))
    y_t = C_t . h_t + D * x_t

Prefill and training use the chunked SSD algorithm, ``ssd_chunked``: on
CUDA tensors the hand-written CUDA kernel of ``kernels/ssd_scan.py``, on
CPU tensors its plain version (the reference's jnp ``ssd_chunked`` has
the Pallas kernel's contract, plus the initial and final state the
serving path carries); its gradient is the plain version's.  Decode uses the O(1) recurrent step ``ssd_step`` in plain
PyTorch, as the reference does in jnp.

Layout: x (B, L, H, P); B, C (B, L, G, N) with H/G heads per group;
state (B, H, N, P), always float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.local import complete
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_mamba_block(gen: torch.Generator, cfg, dtype: torch.dtype,
                     device: torch.device):
    """Random weights from ``gen`` with the reference's distributions
    (``src/repro/models/ssm.py::init_mamba_block``)."""
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.d_inner(d)
    nh = ssm.num_heads(d)
    G, N, W = ssm.n_groups, ssm.d_state, ssm.conv_width
    conv_dim = di + 2 * G * N
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = 0.1 * torch.randn((W, conv_dim), generator=gen, **f32)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((nh,), generator=gen, **f32) * (hi - lo) + lo
    return {
        "in_proj": layers.dense_init(gen, d, 2 * di + 2 * G * N + nh, dtype,
                                     device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)).to(dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": layers.dense_init(gen, di, d, dtype, device),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan through ``kernels.ssd_scan``.

    x: (B, L, H, P)  dt: (B, L, H)  A: (H,) negative
    Bm, Cm: (B, L, G, N)  init_state: (B, H, N, P) or None.
    Returns (y (B, L, H, P), final_state (B, H, N, P) f32).  L % chunk == 0.
    """
    return ssd_scan(x.contiguous(), dt.float().contiguous(),
                    A.float().contiguous(), Bm.contiguous(), Cm.contiguous(),
                    chunk, None if init_state is None
                    else init_state.float().contiguous(), return_state=True)


def mamba_param_axes(cfg) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical sharding axes of ``init_mamba_block``'s leaves (the
    reference's)."""
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "D": ("ssm_heads",),
        "norm_scale": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent decode step.

    x: (B, H, P), dt: (B, H), Bm/Cm: (B, G, N), state: (B, H, N, P).
    """
    rep = x.shape[1] // Bm.shape[1]
    Bf = Bm.float().repeat_interleave(rep, dim=1)         # (B, H, N)
    Cf = Cm.float().repeat_interleave(rep, dim=1)
    a = torch.exp(dt.float() * A[None, :])                # (B, H)
    dBx = torch.einsum("bhn,bhp->bhnp", Bf * dt.float()[..., None], x.float())
    new_state = a[:, :, None, None] * state.float() + dBx
    y = torch.einsum("bhn,bhnp->bhp", Cf, new_state)
    return y.to(x.dtype), new_state


def ssd_recurrent_reference(x, dt, A, Bm, Cm, init_state=None):
    """Naive per-token recurrence: oracle for ``ssd_chunked`` (tests)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(L):
        y, h = ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------

def _split_proj(cfg, proj: torch.Tensor):
    ssm = cfg.ssm
    di = ssm.d_inner(cfg.d_model)
    G, N = ssm.n_groups, ssm.d_state
    nh = ssm.num_heads(cfg.d_model)
    z, xBC, dt = torch.split(proj, [di, di + 2 * G * N, nh], dim=-1)
    return z, xBC, dt, di, G, N, nh


def init_conv_state(cfg, batch: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    ssm = cfg.ssm
    conv_dim = ssm.d_inner(cfg.d_model) + 2 * ssm.n_groups * ssm.d_state
    return torch.zeros((batch, ssm.conv_width - 1, conv_dim), dtype=dtype,
                       device=device)


def init_ssm_state(cfg, batch: int, device: torch.device) -> torch.Tensor:
    ssm = cfg.ssm
    nh = ssm.num_heads(cfg.d_model)
    return torch.zeros((batch, nh, ssm.d_state, ssm.head_dim),
                       dtype=torch.float32, device=device)


def _causal_conv_full(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      prev: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B, L, C); prev: (B, W-1, C) history.
    Returns (out (B, L, C), new_history)."""
    W = w.shape[0]
    B, L, C = xBC.shape
    hist = (torch.zeros((B, W - 1, C), dtype=xBC.dtype, device=xBC.device)
            if prev is None else prev.to(xBC.dtype))
    padded = torch.cat([hist, xBC], dim=1)                # (B, L+W-1, C)
    out = torch.zeros((B, L, C), dtype=torch.float32, device=xBC.device)
    for i in range(W):  # small fixed width: unrolled taps
        out = out + padded[:, i:i + L, :].float() * w[i].float()
    out = out + b.float()
    new_hist = padded[:, L:, :] if L >= W - 1 else padded[:, -(W - 1):, :]
    return F.silu(out).to(xBC.dtype), new_hist


def _gated_out(params, cfg, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = layers.rms_norm(y * F.silu(z.float()).to(y.dtype),
                        params["norm_scale"], cfg.rms_norm_eps)
    return complete(y @ params["out_proj"])


def mamba_block_full(params, cfg, u: torch.Tensor,
                     init_states: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence mamba2 block. u: (B, L, d) -> (out, states)."""
    ssm = cfg.ssm
    proj = u @ params["in_proj"]
    z, xBC, dt, di, G, N, nh = _split_proj(cfg, proj)
    prev_conv = init_states["conv"] if init_states else None
    xBC, conv_state = _causal_conv_full(xBC, params["conv_w"],
                                        params["conv_b"], prev_conv)
    x, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    Bsz, L, _ = u.shape
    P = ssm.head_dim
    x = x.reshape(Bsz, L, nh, P)
    Bm = Bm.reshape(Bsz, L, G, N)
    Cm = Cm.reshape(Bsz, L, G, N)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    prev_ssm = init_states["ssm"] if init_states else None
    # pad L to a multiple of the chunk, after the conv: padded rows have
    # dt = 0, so they neither decay nor change the state
    Q = ssm.chunk_size
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    y, ssm_state = ssd_chunked(x, dt, A, Bm, Cm, Q, prev_ssm)
    y = y[:, :L]
    x = x[:, :L]
    y = y + x * params["D"].to(y.dtype)[None, None, :, None]
    out = _gated_out(params, cfg, y.reshape(Bsz, L, di), z)
    return out, {"conv": conv_state, "ssm": ssm_state}


def mamba_block_step(params, cfg, u: torch.Tensor,
                     states: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. u: (B, 1, d); states: {"conv": (B, W-1, C),
    "ssm": (B, H, N, P)}."""
    ssm = cfg.ssm
    proj = u[:, 0] @ params["in_proj"]                    # (B, .)
    z, xBC, dt, di, G, N, nh = _split_proj(cfg, proj)
    window = torch.cat([states["conv"], xBC[:, None, :]], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            params["conv_w"].float()) \
        + params["conv_b"].float()
    xBC_c = F.silu(conv_out).to(u.dtype)
    new_hist = window[:, 1:, :]
    x, Bm, Cm = torch.split(xBC_c, [di, G * N, G * N], dim=-1)
    Bsz = u.shape[0]
    x = x.reshape(Bsz, nh, ssm.head_dim)
    Bm = Bm.reshape(Bsz, G, N)
    Cm = Cm.reshape(Bsz, G, N)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, new_state = ssd_step(x, dt, A, Bm, Cm, states["ssm"])
    y = y + x * params["D"].to(y.dtype)[None, :, None]
    out = _gated_out(params, cfg, y.reshape(Bsz, 1, di), z[:, None, :])
    return out, {"conv": new_hist, "ssm": new_state}
