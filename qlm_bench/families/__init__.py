"""Architecture families, found by name: ``families/<family>.py`` for a
configuration whose ``"family"`` is ``<family>``, as ``metrics/<name>.py``
is found for a metric.  A family is plain PyTorch, imports nothing of the
port and no JAX, and provides:

  * ``accepts(cfg)``: raises ``ValueError`` for whatever its reference does
    not compute (``cfg`` is the port's ModelConfig as served);
  * ``make_weights(model, seed, dtype, device)``: the parameter tree the
    port serves, drawn from the seed on the device;
  * ``logits(model, weights, tokens, first=0, precision="f32")``: the
    float32 forward pass, or ``precision="fp8"``, the control;
  * ``attention_layers(model)``: ``(count, H, KVH, D, window)`` groups of
    the attention layers, ``window`` None for full attention, from which
    ``counting.py`` counts the rooflines and ``mfu``.

``model`` is a configuration's ``"model"`` sizes.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def load(name: str, bench: Path = BENCH):
    """The module ``families/<name>.py`` under ``bench``."""
    path = bench / "families" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"qlm_bench_family_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def of(config: dict, bench: Path = BENCH):
    """The family module that ``config`` names."""
    if "family" not in config:
        raise ValueError(f"{config.get('name')}: no \"family\" key: name "
                         f"the architecture family, a module under "
                         f"families/")
    return load(config["family"], bench)
