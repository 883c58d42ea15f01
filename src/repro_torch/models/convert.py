"""Carry weights between the reference's layout and the port's.

``from_jax_params`` takes the params of the JAX ``Model.init`` as nested
dicts of numpy arrays, every per-layer leaf stacked on a leading
``layers`` axis for ``lax.scan``, and returns the port's params: the same
names, each stacked tree (``STACKED``) unstacked into a list of one dict
per layer, every other entry (a leaf or a tree) carried across whole.
That covers each family's tree: the transformer's ``"blocks"``
(``src/repro/models/transformer.py::init_lm``; an MoE block's router and
(layers, E, d, F) experts unstack like any other leaf, a VLM's
``"vision_proj"`` goes across as it is), mamba2's ``"blocks": {"norm",
"mamba": {...}}`` (``ssm_lm.py::init_ssm_lm``), the hybrid's mamba
``"blocks"`` beside its ``"shared_attn"`` block, stored once and not
stacked (``hybrid.py::init_hybrid_lm``), and the encoder-decoder's
``"enc_blocks"`` (``cfg.encoder.num_layers`` of them) and
``"dec_blocks"`` (``cfg.num_layers``) with its top-level norms
(``encdec.py::init_encdec_lm``).  Parity tests load their weights through
it, so both frameworks run identical numbers.  ``to_jax_layout`` is its
inverse, for any tree of the params' structure (params, gradients,
optimizer moments): tests compare gradients through it, and checkpoints
write the reference's files with it.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


# the trees stacked on a leading layers axis in the reference's layout
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _map_leaves(fn, v):
    """``fn`` over every leaf of ``v`` (a leaf or a nested mapping), in
    ``v``'s structure."""
    if isinstance(v, Mapping):
        return {k: _map_leaves(fn, x) for k, x in v.items()}
    return fn(v)


def from_jax_params(params: Mapping[str, Any], cfg,
                    device: Union[str, torch.device] = "cuda",
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    for name in STACKED:
        if name not in params:
            continue
        n = stacked_layers(params, name)
        want = cfg.encoder.num_layers if name == "enc_blocks" \
            else cfg.num_layers
        if n != want:
            raise ValueError(f"params hold {n} stacked layers in {name!r}, "
                             f"cfg {cfg.name} has {want}")
    return unstack_layers(params, resolve_device(device), dtype)


def stacked_layers(params: Mapping[str, Any], name: str = "blocks") -> int:
    """The length of the leading ``layers`` axis of the reference-layout
    ``params[name]`` (read from its first leaf)."""
    leaf = params[name]
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return len(np.asarray(leaf))


def unstack_layers(params: Mapping[str, Any], device: torch.device,
                   dtype: torch.dtype) -> Dict[str, Any]:
    """Reference-layout params (numpy) as the port's tensors on
    ``device``, each stacked tree split into one dict per layer."""
    def leaf(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    def layer(tree, i: int):
        return {k: layer(v, i) if isinstance(v, Mapping) else leaf(v[i])
                for k, v in tree.items()}

    return {k: [layer(v, i) for i in range(stacked_layers(params, k))]
            if k in STACKED else _map_leaves(leaf, v)
            for k, v in params.items()}


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

    return {k: stack(v) if k in STACKED else _map_leaves(leaf, v)
            for k, v in tree.items()}
