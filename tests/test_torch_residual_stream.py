"""The residual stream on a mesh: whole over "model" between sub-blocks,
as XLA keeps the reference's.

Each sub-block's projection back to the residual stream (attention's
``wo``, the MLPs' ``down`` / ``fc2``, the SSM's ``out_proj``, the MoE
combine) contracts a dimension that "model" splits, so DTensor leaves a
partial sum over "model"; ``distributed/local.py::complete`` all-reduces
it at the projection.  Left partial, torch 2.13 carried the partial sum
into the next layer in a microbatched step (and reduced it onto a split
of the batch in one step), and the attention completed q and k at the
scores' size: the microbatched
qwen3-moe train_4k record carried 19.8x the collective bytes of the same
step without microbatches, and 188 view fallbacks.

  * ``test_microbatching_keeps_the_collectives_of_one_step``: qwen3-moe
    train_4k at full width on the fake 16 x 16 mesh, cut to 2 layers
    (the drift starts after the first): with 4 microbatches the record's
    collective bytes are at most 2x those of one, and no op falls back;
  * ``test_no_sub_block_hands_the_residual_a_partial_sum``: one train
    step of a reduced config of each family on a fake 2 x 2 mesh: every
    sub-block output added into the residual carries no ``Partial``, and
    the residual between blocks no ``Shard`` of its last dimension (a
    sequence split where ``shard_activations_seq`` asks for one);
  * ``test_the_references_step_scatters_nothing``: the yardstick, XLA's
    compiled train step of a reduced qwen3-moe on 8 CPU devices (a 2 x 4
    mesh), with and without 2 microbatches, has no reduce-scatter and no
    collective of a score-shaped (..., L, L) operand or result.
    ``python tests/test_torch_residual_stream.py`` prints its
    collectives.
"""
import dataclasses
import os
import re
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, encdec, layers, moe, ssm


@pytest.fixture
def released():
    yield
    mesh_lib.release()


def _groups(n):
    return lambda c: dataclasses.replace(
        c, num_layers=2, moe=dataclasses.replace(c.moe, dispatch_groups=n))


def test_microbatching_keeps_the_collectives_of_one_step(released):
    recs = {mb: dryrun.run_one("qwen3-moe-30b-a3b", "train_4k",
                               microbatches=mb, config_transform=_groups(16),
                               save=False)
            for mb in (1, 4)}
    one, four = (recs[mb]["collectives"]["total_bytes"] for mb in (1, 4))
    assert 0 < four <= 2 * one, (one, four)
    for rec in recs.values():
        assert rec["fallback_ops"] == {}


# ---------------------------------------------------------------------------
# every family's sub-blocks on a fake 2 x 2 mesh
# ---------------------------------------------------------------------------

FAMILIES = {
    "dense": ("granite-3-2b", {}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    "moe-seqshard": ("qwen3-moe-30b-a3b", {"shard_activations_seq": True}),
    "ssm": ("mamba2-130m", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "encdec": ("whisper-medium", {}),
}

# the functions whose outputs are added into the residual, by module
SUB_BLOCKS = [(attention, "attend_train"), (layers, "swiglu_mlp"),
              (layers, "gelu_mlp"), (moe, "apply_moe"),
              (ssm, "mamba_block_full"), (encdec, "cross_attend")]


def _recorded(fn, name, seen):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        seen.append((name, first.placements))
        return out
    return wrapped


@pytest.mark.parametrize("family", list(FAMILIES))
def test_no_sub_block_hands_the_residual_a_partial_sum(released, monkeypatch,
                                                       family):
    arch, extra = FAMILIES[family]
    sub_blocks, residual = [], []
    for module, name in SUB_BLOCKS:
        monkeypatch.setattr(module, name,
                            _recorded(getattr(module, name), name,
                                      sub_blocks))
    remat = layers.remat_call
    monkeypatch.setattr(layers, "remat_call", lambda r, fn, *args: _recorded(
        lambda *a: remat(r, fn, *a), fn.__name__, residual)(*args))
    mesh = mesh_lib.make_debug_mesh(2, 2)
    rec = dryrun.run_one(
        arch, "train_4k", mesh=mesh, save=False,
        shape_transform=lambda s: dataclasses.replace(s, global_batch=4,
                                                      seq_len=32),
        config_transform=lambda c: dataclasses.replace(
            c.reduced(num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2), **extra))
    assert rec["fallback_ops"] == {}
    assert len(sub_blocks) >= 2 and len(residual) >= 2
    for name, placements in sub_blocks:
        assert not any(p.is_partial() for p in placements), (name, placements)
    model = mesh.mesh_dim_names.index("model")
    for name, placements in residual:
        assert not any(p.is_shard(2) for p in placements), (name, placements)
        if extra:
            assert placements[model].is_shard(1), (name, placements)


# ---------------------------------------------------------------------------
# the reference's compiled step, the yardstick
# ---------------------------------------------------------------------------

SEQ = 64
LOWERING = f"""
import dataclasses
import os
import re
import repro.launch.dryrun as dryrun       # sets 512 host devices
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get_arch, get_shape

mesh = jax.make_mesh((2, 4), ("data", "model"))
cfg = get_arch("qwen3-moe-30b-a3b").reduced(num_layers=2, d_model=256,
                                            num_heads=8, num_kv_heads=2)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                       dispatch_groups=2))
shape = dataclasses.replace(get_shape("train_4k"), seq_len={SEQ},
                            global_batch=8)
define = re.compile(r"^\\s*(?:ROOT )?%?([\\w.\\-]+) = (\\S+) ([\\w\\-]+)\\((.*)$",
                    re.MULTILINE)
for mb in (1, 2):
    with mesh:
        fn, args, _ = dryrun.build_lowerable(cfg, shape, mesh,
                                             microbatches=mb)
        text = fn.lower(*args).compile().as_text()
    types = {{m.group(1): m.group(2) for m in define.finditer(text)}}
    for m in define.finditer(text):
        op = m.group(3).removesuffix("-start")
        if op in ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute"):
            operands = re.findall(r"%([\\w.\\-]+)", m.group(4).split(")")[0])
            print(mb, op, m.group(2),
                  " ".join(types.get(o, "?") for o in operands))
"""


def jax_train_step_collectives() -> str:
    """One line per collective XLA compiles for the reference's train
    step of qwen3-moe reduced to 2 layers of width 256 (8 query heads on
    2 KV heads, 4 experts in 2 dispatch groups), a batch of 8 x 64 on a
    2 x 4 ("data", "model") mesh of 8 CPU devices, with 1 and 2
    microbatches: the microbatches, the op, its result type, its
    operands' types (a process of its own: the device count is fixed
    when JAX starts)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", LOWERING], env=env,
                          check=True, capture_output=True, text=True,
                          timeout=600).stdout


def _dims(type_str):
    return [[int(d) for d in dims.split(",") if d]
            for dims in re.findall(r"\w+\[([0-9,]*)\]", type_str)]


def test_the_references_step_scatters_nothing():
    lines = jax_train_step_collectives().splitlines()
    ops = [line.split()[1] for line in lines]
    for mb in ("1", "2"):
        assert any(line.startswith(mb + " ") for line in lines), mb
    assert "all-reduce" in ops
    assert "reduce-scatter" not in ops
    for line in lines:
        for dims in _dims(" ".join(line.split()[2:])):
            assert dims[-2:] != [SEQ, SEQ], line


if __name__ == "__main__":
    print(jax_train_step_collectives(), end="")
