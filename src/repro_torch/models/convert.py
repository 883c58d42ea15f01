"""Carry reference weights into the port.

``from_jax_params`` takes the params of the JAX ``Model.init``
(``src/repro/models/transformer.py::init_lm``) as nested dicts of numpy
arrays — every per-layer leaf stacked on a leading ``layers`` axis for
``lax.scan`` — and returns the port's params: the same names, with
``"blocks"`` unstacked into one dict per layer.  Parity tests load their
weights through it, so both frameworks run identical numbers.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax_params(params: Mapping[str, Any], cfg,
                    device: Union[str, torch.device] = "cuda",
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    dev = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=dev)

    def layer(tree, i: int):
        return {k: layer(v, i) if isinstance(v, Mapping) else leaf(v[i])
                for k, v in tree.items()}

    blocks = params["blocks"]
    n = len(np.asarray(blocks["attn_norm"]))
    if n != cfg.num_layers:
        raise ValueError(f"params hold {n} stacked layers, cfg "
                         f"{cfg.name} has {cfg.num_layers}")
    out = {k: leaf(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [layer(blocks, i) for i in range(n)]
    return out
