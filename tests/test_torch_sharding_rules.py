"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's: every case of ``tests/test_sharding_rules.py`` on both
(``spec_for`` only reads ``mesh.shape``, so no device is needed); every
param and cache leaf of the ten registry archs at full width, shapes
from ``eval_shape_params`` (the ``meta`` device: nothing is allocated),
against the reference's ``PartitionSpec`` with its stacked leading
entries removed, on the 1-pod and 2-pod meshes, with the dropped axes
agreeing; and on a fake 2 x 2 mesh, each distributed leaf's local shape
(full width, meta tensors) against the shard shape computed in numpy."""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ARCHITECTURES as JAX_ARCHS
from repro.distributed.sharding import DEFAULT_RULES as JAX_RULES
from repro.distributed.sharding import ShardingRules as JaxRules
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHITECTURES
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model

MESH = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
MESH_1POD = SimpleNamespace(shape={"data": 16, "model": 16})


def _both(mesh, shape, logical, rules=None, name=""):
    """(port spec, its dropped, reference spec, its dropped)."""
    port = sh.ShardingRules.default(rules)
    ref = JaxRules.default(rules)
    got = port.spec_for(mesh, shape, logical, name)
    want = ref.spec_for(mesh, shape, logical, name)
    return got, port.dropped, want, ref.dropped


def test_default_rules_are_the_references():
    assert sh.DEFAULT_RULES == JAX_RULES


def test_right_alignment_pads_stacked_dims():
    got, _, want, _ = _both(MESH_1POD, (40, 2048, 8192), ("embed", "ff"))
    assert PartitionSpec(*got) == want == PartitionSpec(None, None, "model")


def test_divisibility_guard_drops_axis():
    got, dropped, want, ref_dropped = _both(MESH_1POD, (49155, 2048),
                                            ("vocab", "embed"), name="embed")
    assert PartitionSpec(*got) == want == PartitionSpec(None, None)
    assert dropped == ref_dropped and any("vocab" in d for d in dropped)
    # padded vocab shards fine
    got, dropped, want, _ = _both(MESH_1POD, (49408, 2048),
                                  ("vocab", "embed"))
    assert PartitionSpec(*got) == want == PartitionSpec("model", None)
    assert not dropped


def test_batch_uses_pod_and_data():
    got, _, want, _ = _both(MESH, (256, 4097), ("batch", None))
    assert PartitionSpec(*got) == want == PartitionSpec(("pod", "data"),
                                                        None)
    # single-pod mesh: "pod" filtered out
    got, _, want, _ = _both(MESH_1POD, (256, 4097), ("batch", None))
    assert PartitionSpec(*got) == want == PartitionSpec("data", None)


def test_batch_one_replicates():
    got, _, want, _ = _both(MESH, (1,), ("batch",))
    assert PartitionSpec(*got) == want == PartitionSpec(None)


def test_no_duplicate_mesh_axes():
    port = sh.ShardingRules({"a": "model", "b": "model"})
    got = port.spec_for(MESH_1POD, (32, 32), ("a", "b"))
    want = JaxRules({"a": "model", "b": "model"}).spec_for(
        MESH_1POD, (32, 32), ("a", "b"))
    assert PartitionSpec(*got) == want
    assert [x for x in got if x is not None].count("model") == 1


def test_overrides():
    got, _, want, _ = _both(MESH_1POD, (4096, 8192), ("embed", "ff"),
                            {"embed": "data"})
    assert PartitionSpec(*got) == want == PartitionSpec("data", "model")


def test_default_rules_cover_all_logical_axes_used_by_models():
    used = set()
    for cfg in ARCHITECTURES.values():
        m = build_model(cfg.reduced())
        for t in (m.param_axes(), m.cache_axes()):
            sh.map_leaves(lambda _, ax: used.update(a for a in ax
                                                    if a is not None), t)
    missing = used - set(sh.DEFAULT_RULES)
    assert not missing, missing


# ---------------------------------------------------------------------------
# every leaf of every registry arch, at full width
# ---------------------------------------------------------------------------

# (B, S) of the caches compared; S is under every sliding window (4096),
# so a rolling cache has S columns too.
CACHE_B, CACHE_S = 128, 2048


def _ref_leaves(tree, axes):
    """reference leaf path (its stacked layout) -> (shape, logical axes)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_axes = jax.tree_util.tree_leaves(
        axes, is_leaf=lambda x: isinstance(x, tuple))
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            (tuple(leaf.shape), ax) for (path, leaf), ax in zip(flat,
                                                                flat_axes)}


def _port_name(path: str) -> str:
    """The reference's name of a port leaf: a per-layer list index goes
    (the reference stacks the layers)."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


def _suffixes(dropped):
    return {d.split(":", 1)[1] for d in dropped}


@pytest.mark.parametrize("mesh", [MESH_1POD, MESH], ids=["pod16x16",
                                                         "pod2x16x16"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_every_leaf_spec_equals_the_references(arch, mesh):
    jmodel = jax_build_model(JAX_ARCHS[arch])
    model = build_model(ARCHITECTURES[arch])
    jparams = jmodel.eval_shape_params()
    jcache = jax.eval_shape(lambda: jmodel.init_cache(CACHE_B, CACHE_S))
    trees = (("params", model.eval_shape_params(), model.param_axes(),
              _ref_leaves(jparams, jmodel.param_axes())),
             ("cache", model.init_cache(CACHE_B, CACHE_S,
                                        torch.float32, "meta"),
              model.cache_axes(),
              _ref_leaves(jcache, jmodel.cache_axes())))
    for label, tree, axes, ref in trees:
        port_rules, ref_rules = sh.ShardingRules.default(), JaxRules.default()
        seen = set()

        def check(path, leaf, ax):
            name = _port_name(path)
            ref_shape, ref_ax = ref[name]
            assert ax == ref_ax, (label, name)
            want = ref_rules.spec_for(mesh, ref_shape, ref_ax, name)
            got = port_rules.spec_for(mesh, tuple(leaf.shape), ax, name)
            # the reference's stacked leading entries, replicated
            stacked = len(ref_shape) - len(leaf.shape)
            assert all(e is None for e in tuple(want)[:stacked]), name
            assert PartitionSpec(*got) == PartitionSpec(
                *tuple(want)[stacked:]), (label, name)
            seen.add(name)

        sh.map_leaves(check, tree, axes)
        assert seen == set(ref), (label, set(ref) ^ seen)
        assert _suffixes(port_rules.dropped) == _suffixes(ref_rules.dropped)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_the_dense_cache_shards_kv_seq(quant):
    """The cache holds the reference's S columns, so ``kv_seq`` shards over
    "model" at S = 2048 on 16, k/v and the int8 scales, and nothing is
    dropped."""
    cfg = dataclasses.replace(ARCHITECTURES["granite-3-2b"], kv_quant=quant)
    model = build_model(cfg)
    rules = sh.ShardingRules.default()
    cache = model.init_cache(CACHE_B, CACHE_S, torch.float32, "meta")
    assert cache["k"].shape[3] == CACHE_S
    specs = sh.spec_tree(MESH_1POD, cache, model.cache_axes(), rules)
    assert specs["k"] == specs["v"] == (None, "data", None, "model", None)
    if quant:
        assert specs["k_scale"] == (None, "data", None, "model")
    assert rules.dropped == []


# ---------------------------------------------------------------------------
# placements on a fake 2 x 2 mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2x2():
    mesh_lib.release()
    yield mesh_lib.make_debug_mesh(2, 2)
    mesh_lib.release()


def _shard_shape(shape, spec, sizes):
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        out[d] //= int(np.prod([sizes[a] for a in axes]))
    return tuple(out)


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_distributed_local_shapes_match_numpy(mesh2x2, arch):
    model = build_model(ARCHITECTURES[arch])
    sizes = sh.mesh_sizes(mesh2x2)
    for tree, axes in ((model.eval_shape_params(), model.param_axes()),
                       (model.init_cache(4, 64, torch.float32, "meta"),
                        model.cache_axes())):
        rules = sh.ShardingRules.default()
        specs = sh.spec_tree(mesh2x2, tree, axes, rules)
        placed = sh.distribute(mesh2x2, tree, sh.build_shardings(
            mesh2x2, tree, axes, rules))

        def check(path, t, d, spec):
            assert tuple(d.to_local().shape) == _shard_shape(t.shape, spec,
                                                             sizes), path
            assert d.to_local().is_meta

        sh.map_leaves(check, tree, placed, specs)


def test_placements_put_the_outer_axis_first(mesh2x2):
    assert sh.placements(mesh2x2, (("data", "model"), None)) == (
        torch.distributed.tensor.Shard(0), torch.distributed.tensor.Shard(0))
    with pytest.raises(ValueError, match="outer axis"):
        sh.placements(mesh2x2, (("model", "data"),))
