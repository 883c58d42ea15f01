"""The port's training path (``repro_torch.training``, ``Model.loss``,
``launch/train.py``) against the JAX reference on the CPU, same weights
(``models/convert.py``) and same data: the loss with each attention route
(``_sdpa``, ``train_attn_chunk``, the flash kernel's plain version under
``use_pallas_attention``), its gradients, three AdamW steps with cosine
warmup and clipping (single and with two microbatches), the synthetic data
pipeline, and checkpoints moved between the packages in both directions.

The reference cannot differentiate through its Pallas flash kernel (the
``pallas_call`` has no VJP), so every gradient and train step of the port,
flash route included, is held against the reference with
``use_pallas_attention`` off: both compute the same function.

Tolerance: float32, 1e-4 on losses, gradients and parameters (matmul sums,
RoPE's sin/cos and the reductions round differently in the frameworks);
exact on data batches and checkpoint round trips.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import build_model as jax_build_model
from repro.training import AdamW as JaxAdamW
from repro.training import SyntheticLMDataset as JaxDataset
from repro.training import cosine_schedule as jax_cosine
from repro.training import make_train_step as jax_make_train_step
from repro.training import restore_checkpoint as jax_restore
from repro.training import save_checkpoint as jax_save
from repro_torch.configs import get_arch
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.training import (AdamW, SyntheticLMDataset, cosine_schedule,
                                  global_norm, make_train_step,
                                  restore_checkpoint, save_checkpoint)
from repro_torch.training.optimizer import tree_leaves, tree_unflatten

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
KW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2)
# granite at 32 tokens; h2o-danube at 96, past its reduced 64-token window
SEQ = {"granite-3-2b": 32, "h2o-danube-1.8b": 96}
ROUTES = {"sdpa": {}, "flash": {"use_pallas_attention": True},
          "chunked": {"train_attn_chunk": 16}}


def _cfgs(arch, **flags):
    jcfg = dataclasses.replace(ARCHITECTURES[arch].reduced(**KW), **flags)
    tcfg = dataclasses.replace(get_arch(arch).reduced(**KW), **flags)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


_PARAMS = {}


def _jax_params(arch):
    """Reference ``Model.init`` weights of the reduced ``arch`` (numpy)."""
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        _PARAMS[arch] = jax.tree.map(
            np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    return _PARAMS[arch]


def _tokens(arch, batch=2, seed=0):
    vocab = ARCHITECTURES[arch].reduced(**KW).vocab_size
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, SEQ[arch] + 1)).astype(np.int32)


def _port(arch, **flags):
    _, tcfg = _cfgs(arch, **flags)
    return build_model(tcfg), from_jax_params(_jax_params(arch), tcfg,
                                              device="cpu")


def _assert_tree_close(got, want, **tol):
    got, want = jax.tree_util.tree_leaves_with_path(got), \
        jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", list(SEQ))
@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_matches_jax(arch, route):
    """Each route of ``attend_train`` against the reference's same route,
    the flash kernel's (interpret mode) included."""
    jcfg, _ = _cfgs(arch, **ROUTES[route])
    tokens = _tokens(arch)
    want, wm = jax_build_model(jcfg).loss(_jax_params(arch),
                                          {"tokens": jnp.asarray(tokens)})
    model, params = _port(arch, **ROUTES[route])
    got, gm = model.loss(params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), **TOL)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("arch", list(SEQ))
@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_gradients_match_jax_grad_with_the_flag_off(arch, route):
    jcfg, _ = _cfgs(arch)
    tokens = _tokens(arch, seed=1)
    jmodel = jax_build_model(jcfg)
    want = jax.grad(lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens)}
                                          )[0])(_jax_params(arch))
    model, params = _port(arch, **ROUTES[route])
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss(params, {"tokens": torch.tensor(tokens)})
    grads = torch.autograd.grad(loss, leaves)
    got = to_jax_layout(tree_unflatten(params, list(grads)))
    _assert_tree_close(got, jax.tree.map(np.asarray, want), **TOL)


def test_remat_changes_nothing_and_sharding_raises():
    model, params = _port("granite-3-2b", use_pallas_attention=True)
    batch = {"tokens": torch.tensor(_tokens("granite-3-2b", seed=2))}
    out = []
    for remat in (True, False):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params, batch, remat=remat)
        out.append([loss.detach()] + list(torch.autograd.grad(loss, leaves)))
        for p in leaves:
            p.requires_grad_(False)
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    sharded, _ = _port("granite-3-2b", shard_activations_seq=True)
    with pytest.raises(RuntimeError, match="requires a non-empty mesh"):
        sharded.loss(params, batch)


_JAX_RUNS = {}


def _jax_run(arch, microbatches, steps=3, batch=4):
    """Losses, grad norms and final params of ``steps`` reference train
    steps (flag off): AdamW, cosine schedule with 2 warmup steps, clip 1."""
    key = (arch, microbatches)
    if key not in _JAX_RUNS:
        jcfg, _ = _cfgs(arch)
        opt = JaxAdamW(learning_rate=jax_cosine(1e-3, 2, steps))
        step = jax.jit(jax_make_train_step(jax_build_model(jcfg), opt,
                                           microbatches=microbatches))
        params = jax.tree.map(jnp.asarray, _jax_params(arch))
        state = opt.init(params)
        it = iter(JaxDataset(jcfg.vocab_size, SEQ[arch], batch, seed=3))
        metrics = []
        for _ in range(steps):
            params, state, m = step(params, state, next(it))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        _JAX_RUNS[key] = (metrics, jax.tree.map(np.asarray, params),
                          jax.tree.map(np.asarray, state.mu),
                          jax.tree.map(np.asarray, state.nu))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("arch,microbatches,route", [
    ("granite-3-2b", 1, "sdpa"), ("granite-3-2b", 1, "flash"),
    ("granite-3-2b", 2, "sdpa"), ("granite-3-2b", 2, "flash"),
    ("h2o-danube-1.8b", 1, "flash")])
def test_three_adamw_steps_match_jax(arch, microbatches, route):
    want_metrics, want_params, want_mu, want_nu = _jax_run(arch, microbatches)
    model, params = _port(arch, **ROUTES[route])
    opt = AdamW(learning_rate=cosine_schedule(1e-3, 2, 3))
    state = opt.init(params)
    step = make_train_step(model, opt, microbatches=microbatches)
    it = iter(SyntheticLMDataset(model.cfg.vocab_size, SEQ[arch], 4, seed=3))
    for want_loss, want_norm in want_metrics:
        params, state, m = step(params, state,
                                {"tokens": torch.tensor(next(it)["tokens"])})
        assert set(m) == {"loss", "grad_norm", "ce", "aux"}
        np.testing.assert_allclose(float(m["loss"]), want_loss, **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), want_norm, **TOL)
        assert want_norm > 1.0                  # the clip is engaged
    assert state.step == 3
    _assert_tree_close(to_jax_layout(params), want_params, **TOL)
    _assert_tree_close(to_jax_layout(state.mu), want_mu, **TOL)
    _assert_tree_close(to_jax_layout(state.nu), want_nu, atol=1e-6, rtol=1e-4)
    assert all(not p.requires_grad for p in tree_leaves(params))


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7, 10, 11])
def test_cosine_schedule_matches_jax(step):
    want = jax_cosine(3e-4, 3, 10)(jnp.int32(step))
    np.testing.assert_allclose(cosine_schedule(3e-4, 3, 10)(step),
                               float(want), rtol=1e-6)


def test_global_norm_counts_every_leaf():
    tree = {"a": torch.full((3,), 2.0), "blocks": [{"b": torch.ones(4, 2)}]}
    assert float(global_norm(tree)) == pytest.approx(np.sqrt(12 + 8))


def test_synthetic_batches_are_identical():
    mine = iter(SyntheticLMDataset(512, 40, 3, seed=5))
    ref = iter(JaxDataset(512, 40, 3, seed=5))
    for _ in range(3):
        a, b = next(mine)["tokens"], next(ref)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_to_jax_layout_inverts_from_jax_params():
    _, params = _port("granite-3-2b")
    _assert_tree_close(to_jax_layout(params), _jax_params("granite-3-2b"),
                       atol=0, rtol=0)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, _ = _cfgs("granite-3-2b")
    model, params = _port("granite-3-2b")
    opt = AdamW()
    state = opt.init(params)
    step = make_train_step(model, opt)
    params, state, _ = step(params, state, {
        "tokens": torch.tensor(_tokens("granite-3-2b", seed=4))})
    save_checkpoint(str(tmp_path), params, state, 7, {"arch": jcfg.name})
    template = jax_build_model(jcfg).init(jax.random.key(9))
    restored, at = jax_restore(str(tmp_path), template)
    assert at == 7
    _assert_tree_close(restored, to_jax_layout(params), atol=0, rtol=0)
    # the optimizer state carries the reference's keys and shapes
    jax_dir = tmp_path / "jax"
    jax_save(str(jax_dir), template, JaxAdamW().init(template), 7)
    mine = np.load(tmp_path / "opt_state.npz")
    theirs = np.load(jax_dir / "opt_state.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    assert all(mine[k].shape == theirs[k].shape
               and mine[k].dtype == theirs[k].dtype for k in mine.files)
    assert int(mine[".step"]) == 1
    np.testing.assert_array_equal(mine[".mu/embed"],
                                  to_jax_layout(state.mu)["embed"])


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jcfg, tcfg = _cfgs("h2o-danube-1.8b")
    jparams = jax_build_model(jcfg).init(jax.random.key(5))
    jax_save(str(tmp_path), jparams, None, 11, {"arch": jcfg.name})
    gen = torch.Generator()
    gen.manual_seed(0)
    template = build_model(tcfg).init(gen, torch.float32, "cpu")
    restored, at = restore_checkpoint(str(tmp_path), template)
    assert at == 11
    assert len(restored["blocks"]) == tcfg.num_layers
    _assert_tree_close(to_jax_layout(restored),
                       jax.tree.map(np.asarray, jparams), atol=0, rtol=0)
    bad = dict(template, extra=torch.zeros(1))
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(str(tmp_path), bad)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    out = train_cli.main(["--device", "cpu", "--arch", "granite-3-2b",
                          "--reduced", "--steps", "3", "--layers", "1",
                          "--d-model", "64", "--batch", "2", "--seq", "16",
                          "--log-every", "1", "--checkpoint",
                          str(tmp_path / "ckpt")])
    assert len(out["losses"]) == len(out["step_s"]) == 3
    assert np.isfinite(out["losses"]).all()
    assert out["first_loss"] == out["losses"][0]
    assert out["last_loss"] == out["losses"][-1]
    assert out["min_loss"] == min(out["losses"])
    assert (tmp_path / "ckpt" / "params.npz").exists()
    assert "step     2" in capsys.readouterr().out


def test_train_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "granite-3-2b", "--steps", "1"])
