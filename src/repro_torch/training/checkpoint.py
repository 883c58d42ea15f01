"""npz + JSON-manifest checkpoints of params and optimizer state, in the
reference's files (PyTorch twin of ``src/repro/training/checkpoint.py``).

A checkpoint is a directory of ``params.npz``, ``opt_state.npz`` (when an
optimizer state is given) and ``manifest.json`` (``{"step", "metadata"}``).
Arrays carry the reference's keys and stacked shapes: ``embed``,
``blocks/attn/wq`` of shape (layers, d, H * hd), ...; the optimizer state
``.step``, ``.mu/<param key>`` and ``.nu/<param key>`` (the names JAX gives
the fields of its ``AdamWState``).  The port's per-layer params go through
``models.convert.to_jax_layout`` on the way out and are unstacked on the
way in, so a checkpoint moves between the two packages either way.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.models.convert import (stacked_layers, to_jax_layout,
                                        unstack_layers)
from repro_torch.training.optimizer import AdamWState, tree_leaves


def _flatten(tree: Mapping[str, Any],
             prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = np.asarray(v)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    return tree


def _param_keys(params) -> set:
    """The reference's keys for the port's params, without copying them."""
    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}"
    return {k for k in params if k != "blocks"} \
        | set(walk(params["blocks"][0], "blocks/"))


def save_checkpoint(path: str, params, opt_state: Optional[AdamWState] = None,
                    step: int = 0,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"),
             **_flatten(to_jax_layout(params)))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_state.npz"),
                 **{".step": np.asarray(opt_state.step, np.int32)},
                 **_flatten(to_jax_layout(opt_state.mu), ".mu/"),
                 **_flatten(to_jax_layout(opt_state.nu), ".nu/"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "metadata": metadata or {}}, f)


def restore_checkpoint(path: str, params_template) -> Tuple[Any, int]:
    """The params of the checkpoint at ``path`` in the port's layout, on
    the device and in the dtype of ``params_template``, and its step."""
    with np.load(os.path.join(path, "params.npz")) as data:
        flat = {k: data[k] for k in data.files}
    want = _param_keys(params_template)
    if set(flat) != want:
        raise ValueError(f"checkpoint/template mismatch: "
                         f"{sorted(set(flat) ^ want)}")
    tree = _unflatten(flat)
    n = len(params_template["blocks"])
    if stacked_layers(tree) != n:
        raise ValueError(f"checkpoint holds {stacked_layers(tree)} layers, "
                         f"the template {n}")
    first = tree_leaves(params_template)[0]
    params = unstack_layers(tree, first.device, first.dtype)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return params, manifest["step"]
