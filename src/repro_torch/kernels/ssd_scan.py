"""Mamba2 SSD chunked scan: the state-space scan of the mamba2 prefill path
(``ssm_lm.prefill`` -> ``mamba_block_full`` -> ``ssd_chunked``).

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_scan``
with the hand-written CUDA kernel of ``csrc/ssd_scan.cu`` (``sm_90a``),
bound through ``ctypes``.

  x           (B, L, H, P)   float32 or bfloat16
  dt          (B, L, H)      float32 (softplus output)
  A           (H,)           float32, negative
  Bm/Cm       (B, L, G, N)   x's dtype; head h reads group h // (H // G)
  chunk       Q, with L % Q == 0
  init_state  (B, H, N, P)   float32, or None for a zero state
  returns     y (B, L, H, P) in x's dtype, and with ``return_state`` also
              the final state (B, H, N, P) in float32

Per chunk, with ``cum`` the inclusive cumsum of ``dt * A`` within the
chunk and ``h`` the state carried in:

  y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i h
  h'  = exp(cum_Q) h + sum_j B_j dt_j exp(cum_Q - cum_j) x_j

which is the reference's jnp ``ssd_chunked`` (``src/repro/models/ssm.py``)
and, with ``init_state=None`` and ``return_state=False``, exactly the
Pallas kernel's contract; the Pallas kernel carries the state across its
sequential chunk axis but neither takes one in nor returns it, which the
serving path needs.  All sums are f32 and every product f32-accurate;
the kernel sums its products in the tensor cores' f32 accumulators,
which do not round to nearest, so its f32 error grows faster with the
number of chunks than the plain version's.

What bounds the kernel on the H100 is the bytes it moves: x, y, B, C and
dt once, and the two f32 states; at the serving prefill (one chunk) the
latency of one CTA's chain of steps sets its pace.  The CTAs split P into
slices of 16 columns (plan: ``common.ssd_plan``): one CTA per (slice,
head, sequence) walks the chunks in order, its slice of the state in
shared memory, the next chunk's x, B, C and dt in flight by
``cp.async``, and the four products on the tensor cores (``mma.sync``)
in f32 accuracy (``csrc/ssd_scan.cu``).  It takes chunks of up to 128
rows, and any d_state whose chunk inputs fit a CTA's shared memory once
(``ssd_plan`` says which).

On CPU tensors ``ssd_scan`` runs ``ssd_scan_plain``, the same function in
plain PyTorch; on CUDA tensors it launches the kernel or raises.  It is
differentiable in x, dt, A, Bm, Cm and ``init_state`` (``SSDScan``): the
backward recomputes ``ssd_scan_plain`` from the saved inputs and
differentiates that, as flash attention's does.  The reference has no
backward kernel (its training path runs the jnp ``ssd_chunked``, and its
Pallas kernel has no VJP), so the port has none either.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.common import (check_cuda_inputs, launch, on_cpu,
                                       ssd_plan)

# launches of the CUDA kernel in this process (the plain version does not
# count); reset by whoever reads it
launches = 0

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None,
                   return_state: bool = False) -> Result:
    """Plain PyTorch version of the kernel (same contract), in f32, or in
    f64 for f64 inputs (a reference for the kernel's f32 error)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, Q, rep = L // chunk, chunk, H // G
    xc = x.to(acc).reshape(Bsz, nc, Q, H, P)
    dtc = dt.to(acc).reshape(Bsz, nc, Q, H)
    Bc = Bm.to(acc).repeat_interleave(rep, dim=2).reshape(Bsz, nc, Q, H, N)
    Cc = Cm.to(acc).repeat_interleave(rep, dim=2).reshape(Bsz, nc, Q, H, N)

    cum = torch.cumsum(dtc * A.to(acc), dim=2)            # (B, nc, Q, H)
    # exp only where j <= i: -inf elsewhere gives exactly 0
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, Q, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
    cb = torch.einsum("bnihs,bnjhs->bnijh", Cc, Bc)
    att = cb * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bnijh,bnjhp->bnihp", att, xc)

    # each chunk's own contribution to the state, then the recurrence
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B, nc, Q, H)
    states = torch.einsum("bnjhs,bnjhp->bnhsp", Bc,
                          xc * (dtc * decay_to_end)[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B, nc, H)
    h = (torch.zeros((Bsz, H, N, P), dtype=acc, device=x.device)
         if init_state is None else init_state.to(acc))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prev = torch.stack(entering, dim=1)                 # (B, nc, H, N, P)
    y = y + torch.einsum("bnihs,bnhsp->bnihp",
                         Cc * torch.exp(cum)[..., None], h_prev)
    y = y.reshape(Bsz, L, H, P).to(x.dtype)
    return (y, h) if return_state else y


def _check_shapes(x, dt, A, Bm, Cm, chunk, init_state) -> None:
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, L, H, P) and Bm/Cm "
                         f"(B, L, G, N), got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bsz, L, H) or A.shape != (H,)
            or Bm.shape[:2] != (Bsz, L) or Cm.shape != Bm.shape
            or G < 1 or H % G):
        raise ValueError(f"ssd_scan: shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if chunk < 1 or L % chunk:
        raise ValueError(f"ssd_scan: L ({L}) must be a multiple of the "
                         f"chunk ({chunk})")
    if init_state is not None and init_state.shape != (Bsz, H, N, P):
        raise ValueError(f"ssd_scan: init_state must be {(Bsz, H, N, P)}, "
                         f"got {tuple(init_state.shape)}")


def _launch(x, dt, A, Bm, Cm, chunk, init_state, return_state) -> Result:
    global launches
    dtype = check_cuda_inputs("ssd_scan", {"x": x, "Bm": Bm, "Cm": Cm}, {})
    f32 = {"dt": dt, "A": A}
    if init_state is not None:
        f32["init_state"] = init_state
    for k, t in f32.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"ssd_scan: {k} must be contiguous float32, got "
                            f"{t.dtype}")
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    plan = ssd_plan(Bsz, L, H, P, G, N, chunk, x.dtype)
    y = torch.empty_like(x)
    final = (torch.empty((Bsz, H, N, P), dtype=torch.float32,
                         device=x.device) if return_state else None)
    launch("ssd_scan", "ssd_scan", x.device,
           [x, dt, A, Bm, Cm, init_state, y, final],
           [Bsz, L, H, G, N, P, chunk, dtype, plan.slice_p, plan.stages,
            plan.smem_bytes])
    launches += 1
    return (y, final) if return_state else y


class SSDScan(torch.autograd.Function):
    """Forward: the kernel (CUDA tensors) or the plain version (CPU
    tensors).  Backward: autograd through the plain version, recomputed
    from the saved inputs alone, so a block recomputed under remat needs
    nothing of the first forward.  The final state may get no gradient
    (training discards it): its cotangent is then left out."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk, return_state):
        ctx.chunk, ctx.return_state = chunk, return_state
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        tensors = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
        if init_state is not None:
            tensors["init_state"] = init_state
        if on_cpu(tensors):
            return ssd_scan_plain(x, dt, A, Bm, Cm, chunk, init_state,
                                  return_state)
        return _launch(x, dt, A, Bm, Cm, chunk, init_state, return_state)

    @staticmethod
    def backward(ctx, *grad_outs):
        saved = ctx.saved_tensors
        wanted = [i for i, t in enumerate(saved)
                  if t is not None and ctx.needs_input_grad[i]]
        inputs = [t if t is None else t.detach().requires_grad_(i in wanted)
                  for i, t in enumerate(saved)]
        with torch.enable_grad():
            outs = ssd_scan_plain(*inputs[:5], ctx.chunk, inputs[5],
                                  ctx.return_state)
        outs = outs if ctx.return_state else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outs) if g is not None]
        found = torch.autograd.grad([o for o, _ in pairs],
                                    [inputs[i] for i in wanted],
                                    [g for _, g in pairs], allow_unused=True)
        grads = [None] * 8
        for i, g in zip(wanted, found):
            grads[i] = g
        return tuple(grads)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False) -> Result:
    """The SSD scan (contract in the module docstring): the kernel on CUDA
    tensors, the plain version on CPU tensors; differentiable in every
    tensor argument."""
    _check_shapes(x, dt, A, Bm, Cm, chunk, init_state)
    return SSDScan.apply(x, dt, A, Bm, Cm, init_state, chunk, return_state)
