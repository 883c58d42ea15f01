"""The port's twins of the README's examples against the JAX examples, and
the sharding pieces that run for real: ``launch/quickstart.py`` against
``examples/quickstart.py`` (every request's tokens and the attainment,
f32 on the CPU, the example's own params converted),
``launch/multi_model_serving.py`` against
``examples/multi_model_serving.py`` (``model_swaps`` in both orders);
``shard_activations_seq`` on a one-rank gloo mesh (loss and gradients
equal those with the flag off); and ``serve.shard_registry``'s placement
(each leaf as ``spec_for`` gives it, the served tokens unchanged)."""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.core.request import Request
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import multi_model_serving, quickstart, serve
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.training.optimizer import tree_leaves

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _converted(arch, **reduce):
    """The port's model and the JAX example's params (``init`` on
    ``jax.random.key(0)``), converted, f32 on the CPU."""
    jcfg = jax_get_arch(arch).reduced(**reduce)
    params = jax.tree.map(np.asarray,
                          jax_build_model(jcfg).init(jax.random.key(0)))
    cfg = get_arch(arch).reduced(**reduce)
    return cfg, from_jax_params(params, cfg, device="cpu")


def test_quickstart_matches_the_jax_example(monkeypatch):
    ex = _load("quickstart")
    made = []

    def recording(*args, **kwargs):
        made.append(ex_make_request(*args, **kwargs))
        return made[-1]

    ex_make_request = ex.make_request
    monkeypatch.setattr(ex, "make_request", recording)
    ex.main()
    cfg, params = _converted("granite-3-2b", num_layers=2, d_model=128)
    assert cfg == quickstart.reduced_config()
    got = quickstart.run(cfg, device="cpu", params=params)
    assert len(made) == len(got["requests"]) == 12
    assert [r.output_tokens for r in got["requests"]] == \
        [r.output_tokens for r in made]
    assert [r.slo_class for r in got["requests"]] == \
        [r.slo_class for r in made]
    assert all(r.finished() and r.ttft() is not None
               for r in got["requests"])
    assert got["attainment"] == 1.0
    assert got["groups"] == 3


@pytest.fixture(scope="module")
def jax_multi_model():
    ex = _load("multi_model_serving")
    registry = {}
    for name in multi_model_serving.MODELS:
        cfg, params = _converted(name, num_layers=2, d_model=128)
        registry[name] = (build_model(cfg), params)
    return ex, registry


@pytest.mark.parametrize("grouping", [False, True], ids=["per-request", "qlm"])
def test_multi_model_swaps_match_the_jax_example(jax_multi_model, grouping):
    ex, registry = jax_multi_model
    want = ex.serve(ex.make_requests(), use_qlm_grouping=grouping)
    reqs = multi_model_serving.make_requests()
    got = multi_model_serving.serve(reqs, grouping, registry)
    assert got.model_swaps == want.model_swaps
    assert got.tokens_generated == want.tokens_generated
    assert all(r.finished() for r in reqs)


def test_multi_model_main_asserts_the_insight(jax_multi_model, capsys):
    out = multi_model_serving.main(["--device", "cpu"],
                                   registry=jax_multi_model[1])
    assert out["qlm"].model_swaps < out["interleaved"].model_swaps
    assert "amortize model swapping" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# one-rank meshes
# ---------------------------------------------------------------------------

def _loss_and_grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    full = [g.full_tensor() if hasattr(g, "full_tensor") else g
            for g in grads]
    return loss, full


def test_shard_activations_seq_on_a_one_rank_mesh():
    cfg, params = _converted("granite-3-2b", num_layers=2, d_model=64)
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 17)), dtype=torch.int32)
    want_loss, want_grads = _loss_and_grads(build_model(cfg), params,
                                            {"tokens": tokens})
    sharded = build_model(dataclasses.replace(cfg,
                                              shard_activations_seq=True))
    mesh_lib.release()
    try:
        mesh = mesh_lib.make_local_mesh("cpu", ("data", "model"))
        placed = sh.distribute(mesh, params, sh.build_shardings(
            mesh, params, sharded.param_axes(), sh.ShardingRules.default()))
        batch = sh.distribute(mesh, {"tokens": tokens},
                              sh.replicated(mesh, {"tokens": tokens}))
        # the model's own index tensors (positions, masks) stay plain
        with implicit_replication():
            loss, grads = _loss_and_grads(sharded, placed, batch)
    finally:
        mesh_lib.release()
    torch.testing.assert_close(loss.full_tensor(), want_loss, atol=1e-6,
                               rtol=1e-6)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_shard_registry_places_by_the_rules_and_changes_no_token():
    """Each leaf on the one-device mesh as ``spec_for`` gives it (every
    mesh axis of size 1, so replicated or a whole shard); the engine's
    tokens with the placed params equal those without, bit for bit; the
    process group ends with the placement."""
    cfg, params = _converted("granite-3-2b", num_layers=2, d_model=64)
    model = build_model(cfg)
    registry = {"granite-3-2b": (model, params)}
    mesh_lib.release()
    try:
        mesh = mesh_lib.make_local_mesh("cpu")
        placed = serve.placed_registry(registry, mesh)["granite-3-2b"][1]
        rules = sh.ShardingRules.default()
        want = sh.build_shardings(mesh, params, model.param_axes(), rules)
        sh.map_leaves(lambda path, d, pl: (
            d.placements == tuple(pl)) or pytest.fail(path), placed, want)
    finally:
        mesh_lib.release()
    sharded = serve.shard_registry(registry)
    assert not torch.distributed.is_initialized()

    def tokens(p):
        eng = ContinuousBatchingEngine(model, p, EngineConfig(
            max_slots=4, max_seq_len=64, device="cpu",
            attention_backend="cuda"), model_name="m")
        rng = np.random.default_rng(1)
        reqs = [Request(prompt_tokens=rng.integers(0, 100, n).tolist(),
                        model="m", slo=1e9, max_new_tokens=8)
                for n in (5, 12, 3, 9)]
        for r in reqs:
            assert eng.admit(r)
        while not all(r.finished() for r in reqs):
            eng.steps()
        return [r.output_tokens for r in reqs]

    assert tokens(sharded["granite-3-2b"][1]) == tokens(params)
