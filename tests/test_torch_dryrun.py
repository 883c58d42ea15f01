"""The port's dry run (``repro_torch.launch.dryrun``) and its collective
counts (``launch/comm_analysis.py``): twins of
``tests/test_dryrun_support.py`` (``batch_struct`` shapes, the input
shapes exact); ``shape_applicable`` and the skip reason for every (arch,
shape) pair against the reference's registry; the collectives and flops
of tiny DTensor programs on a fake 2 x 2 mesh, with known bytes; and
``run_one`` on reduced models on fake 1 x 2 and 2 x 2 meshes (the
reference's record keys, argument bytes equal to their analytic sum), and
the CLI at full width on the production mesh.  Each world size's fake
process group is destroyed after its tests."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.configs import ARCHITECTURES as JAX_ARCHS
from repro.configs import applicable_pairs as jax_applicable_pairs
from repro.configs import get_shape as jax_get_shape
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models.model_factory import batch_struct as jax_batch_struct
from repro_torch.configs import (ARCHITECTURES, INPUT_SHAPES, applicable_pairs,
                                 get_arch, get_shape, shape_applicable)
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.distributed.local import whole
from repro_torch.launch.comm_analysis import (COLLECTIVE_OPS, DeviceCounter,
                                              ReplicateFallback,
                                              collective_stats)
from repro_torch.models.model_factory import batch_struct, build_model


def _shapes(struct):
    return {k: tuple(v[0]) for k, v in struct.items()}


def _jax_shapes(struct):
    return {k: tuple(v.shape) for k, v in struct.items()}


def test_batch_struct_train_shapes():
    cfg = get_arch("granite-3-2b")
    b = batch_struct(cfg, 256, 4096, "train")
    assert b["tokens"][0] == (256, 4097)


def test_batch_struct_vlm_includes_patches():
    cfg = get_arch("llava-next-34b")
    b = batch_struct(cfg, 32, 32768, "prefill")
    assert "patch_embeds" in b
    assert b["patch_embeds"][0] == (32, 2880, 7168)
    assert b["tokens"][0][1] + 2880 == 32768


def test_batch_struct_audio_includes_frames():
    cfg = get_arch("whisper-medium")
    b = batch_struct(cfg, 256, 4096, "train")
    assert b["frame_embeds"][0] == (256, 1500, 1024)


def test_batch_struct_decode():
    cfg = get_arch("deepseek-67b")
    b = batch_struct(cfg, 128, 32768, "decode")
    assert b["tokens"][0] == (128,)
    assert b["lengths"][0] == (128,)


def test_assigned_shapes_exact():
    names = {(s.name, s.seq_len, s.global_batch, s.kind)
             for s in INPUT_SHAPES}
    assert names == {
        ("train_4k", 4096, 256, "train"),
        ("prefill_32k", 32768, 32, "prefill"),
        ("decode_32k", 32768, 128, "decode"),
        ("long_500k", 524288, 1, "decode"),
    }


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_input_specs_equal_the_references(arch):
    for s in INPUT_SHAPES:
        got = _shapes(dryrun.input_specs(arch, s.name))
        jcfg = JAX_ARCHS[arch]
        if s.name == "long_500k" and jcfg.arch_type == "hybrid":
            jcfg = dataclasses.replace(jcfg, sliding_window=4096)
        want = _jax_shapes(jax_batch_struct(jcfg, s.global_batch, s.seq_len,
                                            s.kind))
        assert got == want, (arch, s.name)


@pytest.mark.parametrize("shape", [s.name for s in INPUT_SHAPES])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_applicability_and_skip_reason_equal_the_references(arch, shape):
    ok = shape_applicable(get_arch(arch), get_shape(shape))
    assert ok == jax_shape_applicable(JAX_ARCHS[arch], jax_get_shape(shape))
    if not ok:
        rec = dryrun.run_one(arch, shape, save=False)
        assert rec == {
            "arch": arch, "shape": shape, "mesh": "pod16x16", "tag": "",
            "applicable": False,
            "skip_reason": ("long_500k needs sub-quadratic decode; "
                            f"{arch} is full-attention (DESIGN.md §4)")}


def test_applicable_pairs_equal_the_references():
    got = [(c.name, s.name, ok) for c, s, ok in applicable_pairs()]
    want = [(c.name, s.name, ok) for c, s, ok in jax_applicable_pairs()]
    assert got == want


def test_the_hybrid_takes_a_window_at_long_500k():
    cfg = get_arch("zamba2-1.2b")
    assert dryrun.adapt_config_for_shape(
        cfg, get_shape("long_500k")).sliding_window == 4096
    assert dryrun.adapt_config_for_shape(
        cfg, get_shape("decode_32k")).sliding_window is None


# ---------------------------------------------------------------------------
# collectives and flops on a fake 2 x 2 mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2x2():
    mesh_lib.release()
    yield mesh_lib.make_debug_mesh(2, 2)
    mesh_lib.release()


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_row_parallel_product_all_reduces_its_output(mesh2x2):
    x = distribute_tensor(_meta(8, 64), mesh2x2, [Shard(0), Shard(1)])
    w = distribute_tensor(_meta(64, 32), mesh2x2, [Replicate(), Shard(0)])
    st = collective_stats(lambda: (x @ w).redistribute(
        mesh2x2, [Shard(0), Replicate()]))
    assert st.count_by_op == {"all-reduce": 1}
    assert st.bytes_by_op == {"all-reduce": 4 * 32 * 4}   # local (4, 32) f32
    assert set(st.to_dict()) == {"bytes_by_op", "count_by_op",
                                 "total_bytes", "total_count"}
    assert set(st.bytes_by_op) <= set(COLLECTIVE_OPS)


def test_gathering_a_column_sharded_weight_all_gathers_it(mesh2x2):
    w = distribute_tensor(_meta(64, 32), mesh2x2, [Replicate(), Shard(1)])
    st = collective_stats(lambda: w.redistribute(
        mesh2x2, [Replicate(), Replicate()]))
    assert st.count_by_op == {"all-gather": 1}
    assert st.total_bytes == 64 * 32 * 4 and st.total_count == 1


def test_flops_are_counted_per_device(mesh2x2):
    x = distribute_tensor(_meta(8, 64), mesh2x2, [Shard(0), Replicate()])
    w = distribute_tensor(_meta(64, 32), mesh2x2, [Replicate(), Shard(1)])
    with DeviceCounter() as counter:
        y = x @ w
    assert y.placements == (Shard(0), Shard(1))
    assert counter.flops == 2 * 8 * 64 * 32 // 4
    assert counter.collectives().total_count == 0


def test_fallback_bytes_are_attributed_to_the_op(mesh2x2):
    """``searchsorted`` has no DTensor strategy: its fallback gathers both
    sharded arguments, and ``collective_bytes`` puts those bytes, all of
    the counter's, on that op; an op that shards adds none."""
    a = distribute_tensor(_meta(8, 16), mesh2x2, [Shard(0), Shard(1)])
    b = distribute_tensor(_meta(8, 4), mesh2x2, [Shard(0), Replicate()])
    w = distribute_tensor(_meta(16, 4), mesh2x2, [Replicate(), Shard(1)])
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    with counter, fallback:
        torch.searchsorted(a, b)
        a @ w
    name = "aten.searchsorted.Tensor"
    assert fallback.fallbacks == {name: 1}
    # f32: a over "model" (its 4 rows whole), then over "data"; b over
    # "data"
    gathered = (4 * 16 + 8 * 16 + 8 * 4) * 4
    assert fallback.collective_bytes == {name: gathered}
    # called from no function of the port
    assert fallback.sites == {name: {"outside the package": 1}}
    assert counter.collectives().bytes_by_op["all-gather"] >= gathered


def test_whole_gathers_only_the_axes_that_split_the_dim(mesh2x2):
    """``whole(x, 1)`` of an (8, 16) tensor split (data, model) gathers
    over "model" alone: this rank's 4 rows, every column."""
    x = distribute_tensor(_meta(8, 16), mesh2x2, [Shard(0), Shard(1)])
    st = collective_stats(lambda: whole(x, 1))
    assert st.bytes_by_op == {"all-gather": 4 * 16 * 4}
    assert whole(x, 1).placements == (Shard(0), Replicate())
    assert whole(x, 0).placements == (Replicate(), Shard(1))
    y = torch.zeros(3)
    assert whole(y, 0) is y


# ---------------------------------------------------------------------------
# run_one on reduced models
# ---------------------------------------------------------------------------

# the reference's record keys (``lower_s`` / ``compile_s`` are
# ``trace_s`` here)
REF_KEYS = {"arch", "shape", "mesh", "tag", "applicable", "n_chips",
            "trace_s", "memory", "cost", "collectives", "dropped_shardings",
            "model_params", "model_active_params", "tokens_per_step",
            "microbatches"}
MEMORY_KEYS = {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "alias_bytes_per_device",
               "peak_bytes_per_device"}
RUNS = [("granite-3-2b", "train_4k"), ("qwen3-moe-30b-a3b", "prefill_32k"),
        ("mamba2-130m", "decode_32k"), ("zamba2-1.2b", "long_500k"),
        ("whisper-medium", "decode_32k")]


def _small(shape):
    return dataclasses.replace(shape, global_batch=4, seq_len=32)


def _local_bytes(shape, dtype, spec, sizes) -> int:
    local = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else entry
            local[d] //= int(np.prod([sizes[a] for a in axes]))
    return int(np.prod(local)) * torch.empty((), dtype=dtype).element_size()


def _analytic_argument_bytes(arch, shape_name, mesh) -> int:
    """Every argument leaf's shard bytes, from its spec and shape."""
    cfg = get_arch(arch).reduced()
    shape = _small(get_shape(shape_name))
    cfg = dryrun.adapt_config_for_shape(cfg, shape)
    model = build_model(cfg)
    sizes = sh.mesh_sizes(mesh)
    rules = sh.ShardingRules.default()
    total = 0

    def add(tree, axes, copies=1):
        nonlocal total
        specs = sh.spec_tree(mesh, tree, axes, rules)

        def one(_, t, spec):
            nonlocal total
            total += copies * _local_bytes(sh._shape(t), t[1] if isinstance(
                t, tuple) else t.dtype, spec, sizes)
        sh.map_leaves(one, tree, specs)

    params = model.eval_shape_params(dryrun.DTYPE)
    data = batch_struct(cfg, shape.global_batch, shape.seq_len, shape.kind,
                        dryrun.DTYPE)
    add(params, model.param_axes(), 3 if shape.kind == "train" else 1)
    add(data, sh.batch_axes_tree(data))
    if shape.kind != "train":
        add(model.init_cache(shape.global_batch, shape.seq_len, dryrun.DTYPE,
                             "meta"), model.cache_axes())
    return total


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_run_one_on_reduced_models(dims):
    mesh_lib.release()
    try:
        mesh = mesh_lib.make_debug_mesh(*dims)
        for arch, shape in RUNS:
            rec = dryrun.run_one(arch, shape, mesh=mesh, save=False,
                                 config_transform=lambda c: c.reduced(),
                                 shape_transform=_small)
            assert REF_KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
            assert rec["mesh"] == f"mesh{dims[0]}x{dims[1]}"
            assert rec["n_chips"] == dims[0] * dims[1]
            assert rec["applicable"] and rec["trace_s"] >= 0
            mem = rec["memory"]
            assert mem["argument_bytes_per_device"] == \
                _analytic_argument_bytes(arch, shape, mesh), (arch, shape)
            # the step updates its cache / params and moments in place
            assert 0 < mem["alias_bytes_per_device"] <= \
                mem["output_bytes_per_device"]
            assert mem["peak_bytes_per_device"] >= \
                mem["argument_bytes_per_device"]
            assert rec["cost"]["flops_per_device"] > 0
            # every argument is read at least once
            assert rec["cost"]["bytes_accessed_per_device"] >= \
                mem["argument_bytes_per_device"]
            assert set(rec["collectives"]["bytes_by_op"]) <= \
                set(COLLECTIVE_OPS)
            assert set(rec["fallback_collective_bytes"]) \
                == set(rec["fallback_ops"])
            assert sum(rec["fallback_collective_bytes"].values()) \
                <= rec["collectives"]["total_bytes"]
            # the reference's S cache columns shard, and the MoE ranks its
            # pairs by counts, with no searchsorted
            assert not any("kv_seq" in d for d in rec["dropped_shardings"])
            assert "aten.searchsorted.Tensor" not in rec["fallback_ops"]
    finally:
        mesh_lib.release()


def test_the_cli_writes_a_record_at_full_width(tmp_path, monkeypatch,
                                               capsys):
    """granite-3-2b decode_32k on the fake 16 x 16 mesh, and a skip."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    mesh_lib.release()
    try:
        dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k"])
        dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k"])
    finally:
        mesh_lib.release()
    out = capsys.readouterr().out
    assert "[ ok ] granite-3-2b" in out and "[n/a ] granite-3-2b" in out
    rec = json.loads((tmp_path / "granite-3-2b__decode_32k__pod16x16.json")
                     .read_text())
    assert REF_KEYS <= set(rec) and rec["n_chips"] == 256
    cfg = get_arch("granite-3-2b")
    # 40 layers of (128 / 16) rows of 8 KV heads x (32768 / 16) columns x
    # 64, k and v, bf16: batch over "data", "kv_seq" over "model"
    cache = cfg.num_layers * 2 * (128 // 16) * 8 * (32768 // 16) * 64 * 2
    assert rec["memory"]["alias_bytes_per_device"] == cache
    assert rec["memory"]["argument_bytes_per_device"] > cache
    assert rec["dropped_shardings"] == []
    # the dense write, the lookup and the k/v split run shard-local or
    # gather one axis: nothing falls back
    assert rec["fallback_ops"] == {} and rec["fallback_sites"] == {}
    # the lookup gathers no table: no all-gather as large as one
    # device's rows of it
    table = cfg.padded_vocab // 16 * cfg.d_model * 2
    assert rec["collectives"]["bytes_by_op"].get("all-gather", 0) < table
    skip = json.loads((tmp_path / "granite-3-2b__long_500k__pod16x16.json")
                      .read_text())
    assert skip["applicable"] is False
