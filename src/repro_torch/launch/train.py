"""Training entry point: ``--arch <id>`` end-to-end LM training of any family
(PyTorch twin of ``src/repro/launch/train.py``).

Runs reduced configs by default (``--reduced``; ``--full`` for the
published widths), f32 weights and AdamW state as the reference, on the
card (``--device cuda``, the default) or on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch granite-3-2b --steps 3

Each step's batch is the synthetic stream's tokens plus the modality
extras of ``materialize_batch`` (a VLM's patch embeddings, an
encoder-decoder's frame embeddings), the same at every step, as the
reference's.  The attention route is the config's, as in the reference:
``use_pallas_attention`` sends ``attend_train`` through the CUDA flash
kernel (its plain version on the CPU).  The CLI has no flag for it; call
``train(cfg, args)`` with such a config.  mamba2's and the hybrid's scans
run the CUDA SSD kernel on the card whatever the config says.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.model_factory import materialize_batch
from repro_torch.training import (AdamW, SyntheticLMDataset, cosine_schedule,
                                  make_train_step, save_checkpoint)
from repro_torch.training.optimizer import tree_leaves


def train(cfg, args, params=None, extras=None) -> dict:
    """Train ``cfg`` as ``args`` (the CLI's flags) say.  Weights come from
    a ``torch.Generator`` of the device seeded with ``args.seed``, unless
    ``params`` are given; either way they are updated in place.  The
    modality extras come from one seeded with ``args.seed + 1``, unless
    ``extras`` (name -> tensor on the device) are given: generators of two
    devices draw different numbers, so a run on the card is held against
    one on the CPU by giving both the same extras, and that is what the
    argument is for.  Returns the
    reference's ``first_loss`` / ``last_loss`` / ``min_loss`` plus each
    step's ``losses``, ``grad_norms`` and wall ``step_s`` (host clock, the
    step's loss read back), and ``n_params``."""
    dev = resolve_device(args.device)
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        params = model.init(gen, torch.float32, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M "
          f"({cfg.arch_type}, {cfg.num_layers}L d={cfg.d_model}) on {dev}")

    opt = AdamW(learning_rate=cosine_schedule(args.lr, args.steps // 10,
                                              args.steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)

    # the modality extras (VLM patches, audio frames) beside the tokens:
    # the reference draws them at every step from one unsplit key, so every
    # step gets the same ones; here they are drawn once, from a generator
    # of the device seeded with seed + 1
    if extras is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1)
        extras = {k: v for k, v in materialize_batch(
            cfg, args.batch, args.seq, "train", gen, device=dev).items()
            if k != "tokens"}
    it = iter(SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                                 seed=args.seed))
    losses, grad_norms, step_s = [], [], []
    t0 = time.monotonic()
    for step in range(args.steps):
        batch = {"tokens": torch.as_tensor(next(it)["tokens"], device=dev),
                 **extras}
        ts = time.monotonic()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.monotonic() - ts)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = ((step + 1) * args.batch * args.seq
                     / (time.monotonic() - t0))
            print(f"step {step:5d} loss {loss:.4f} "
                  f"grad_norm {grad_norms[-1]:.3f} tok/s {tok_s:.0f}")
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}: {loss}")

    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, opt_state, args.steps,
                        {"arch": cfg.name})
        print(f"checkpoint -> {args.checkpoint}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(improved {losses[0] - losses[-1]:.4f})")
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "min_loss": min(losses), "losses": losses,
            "grad_norms": grad_norms, "step_s": step_s,
            "n_params": n_params}


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=args.layers, d_model=args.d_model)
    return train(cfg, args)


if __name__ == "__main__":
    main()
