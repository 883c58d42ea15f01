"""End-to-end training check (twin of ``examples/train_tiny.py``): train a
~100M-param model for a few hundred steps on the synthetic structured LM
stream and assert that the loss drops.  ``--small`` is a tiny config for a
fast functional check; ``--arch`` takes any family, its modality extras
drawn by ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train_tiny [--steps 300] \
      [--small] [--arch granite-3-2b] [--device cpu]

The default ~100M config (8 layers x d_model 768) writes its checkpoint
under the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

from repro_torch.launch.train import main as train_main


def train_argv(args: argparse.Namespace) -> List[str]:
    """``launch/train.py``'s flags for ``args``, the reference's sizes."""
    argv = ["--arch", args.arch, "--steps", str(args.steps),
            "--device", args.device]
    if args.small:
        return argv + ["--batch", "8", "--seq", "64", "--layers", "2",
                       "--d-model", "128", "--lr", "3e-3"]
    # ~100M params: 8 layers x d_model 768 + 512-vocab head
    return argv + ["--batch", "8", "--seq", "128", "--layers", "8",
                   "--d-model", "768", "--lr", "1e-3", "--checkpoint",
                   os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_tiny_ckpt")]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--small", action="store_true",
                    help="tiny config for a fast functional check")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    result = train_main(train_argv(args))
    if not result["last_loss"] < result["first_loss"]:
        raise AssertionError("training must reduce the loss")
    print("OK: loss decreased")
    return result


if __name__ == "__main__":
    main()
