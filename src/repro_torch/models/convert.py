"""Carry weights between the reference's layout and the port's.

``from_jax_params`` takes the params of the JAX ``Model.init``
(``src/repro/models/transformer.py::init_lm``) as nested dicts of numpy
arrays — every per-layer leaf stacked on a leading ``layers`` axis for
``lax.scan`` — and returns the port's params: the same names, with
``"blocks"`` unstacked into one dict per layer; the same for the mamba2
tree of ``src/repro/models/ssm_lm.py::init_ssm_lm`` (``{"embed",
"blocks": {"norm", "mamba": {...}}, "final_norm"}``).  An MoE block's
``"moe"`` leaves (the router and the (layers, E, d, F) experts) unstack
like any other, and a VLM's top-level ``"vision_proj"`` goes across as
it is.  Parity tests load
their weights through it, so both frameworks run identical numbers.
``to_jax_layout`` is its inverse, for any tree of the params' structure
(params, gradients, optimizer moments): tests compare gradients through
it, and checkpoints write the reference's files with it.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax_params(params: Mapping[str, Any], cfg,
                    device: Union[str, torch.device] = "cuda",
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    n = stacked_layers(params)
    if n != cfg.num_layers:
        raise ValueError(f"params hold {n} stacked layers, cfg "
                         f"{cfg.name} has {cfg.num_layers}")
    return unstack_layers(params, resolve_device(device), dtype)


def stacked_layers(params: Mapping[str, Any]) -> int:
    """The length of the leading ``layers`` axis of the reference-layout
    ``params["blocks"]`` (read from its first leaf)."""
    leaf = params["blocks"]
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return len(np.asarray(leaf))


def unstack_layers(params: Mapping[str, Any], device: torch.device,
                   dtype: torch.dtype) -> Dict[str, Any]:
    """Reference-layout params (numpy) as the port's tensors on
    ``device``, ``"blocks"`` split into one dict per layer."""
    def leaf(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    def layer(tree, i: int):
        return {k: layer(v, i) if isinstance(v, Mapping) else leaf(v[i])
                for k, v in tree.items()}

    out = {k: leaf(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [layer(params["blocks"], i)
                     for i in range(stacked_layers(params))]
    return out


def to_jax_layout(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's params (or a tree of their structure) in the reference's
    names and stacked shapes, as numpy arrays on the host (bfloat16 leaves
    as float32: numpy has no bfloat16)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stack(layers):
        first = layers[0]
        return {k: stack([l[k] for l in layers]) if isinstance(v, Mapping)
                else np.stack([leaf(l[k]) for l in layers])
                for k, v in first.items()}

    out = {k: leaf(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = stack(tree["blocks"])
    return out
