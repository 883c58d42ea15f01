"""Training the SSM (mamba2), the hybrid (zamba2) and the encoder-decoder
(whisper) in the port against the JAX reference on the CPU, same weights
(``models/convert.py``) and same data, and ``launch/train.py``'s modality
extras:

  * ``SSDScan`` (``kernels/ssd_scan.py``): ``gradcheck`` in float64, with
    and without an initial state and the final state; its gradients
    against ``jax.grad`` of the reference's ``ssd_chunked``; rows past the
    sequence (dt = 0, as ``mamba_block_full`` pads them) get none;
  * each family's loss and ``to_jax_layout`` of its gradients against the
    reference's ``loss_fn`` and ``jax.grad``, with remat on and off, at a
    sequence that fills the reduced chunk (16) and one that does not;
    zamba2 and whisper with ``use_pallas_attention`` off and on (the flash
    kernel's plain version; the reference with the flag off, since its
    Pallas kernel has no VJP: both compute the same function); whisper's
    frame embeddings passed across as numpy;
  * three AdamW steps of ``make_train_step`` against the reference's
    jitted train step on the same batches;
  * ``launch/train.py``: a VLM's patch embeddings and an encoder-decoder's
    frame embeddings ride along with every step's tokens, of
    ``batch_struct``'s shapes and the same at every step;
    ``launch/train_tiny.py --small`` trains and the loss falls.

Tolerance: float32, 1e-4 on losses, gradients and parameters, as
``tests/test_torch_training.py`` (sums in another order, and the SSD's
exp of cumulative sums, round differently in the frameworks); float64
for ``gradcheck``'s finite differences at its default tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.training import AdamW as JaxAdamW
from repro.training import SyntheticLMDataset as JaxDataset
from repro.training import cosine_schedule as jax_cosine
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_tiny
from repro_torch.models import build_model
from repro_torch.models import model_factory as port_factory
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.training import AdamW, cosine_schedule, make_train_step
from repro_torch.training.optimizer import tree_leaves, tree_unflatten

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
KW = dict(num_layers=2, d_model=64)
MAMBA, ZAMBA, WHISPER = "mamba2-130m", "zamba2-1.2b", "whisper-medium"
# 32 tokens fill two reduced chunks of 16; 21 pad to 32
SEQS = (32, 21)
# the attention route of each family's cases: mamba2 has no attention
ROUTES = {MAMBA: ("plain",), ZAMBA: ("plain", "flash"),
          WHISPER: ("plain", "flash")}
FLAGS = {"plain": {}, "flash": {"use_pallas_attention": True}}
CASES = [(arch, route) for arch, routes in ROUTES.items()
         for route in routes]


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


def _batch(arch, seq, batch=2, seed=0):
    """numpy tokens (batch, seq + 1) and, for whisper, unit-scale frame
    embeddings (at ``materialize_batch``'s 0.02 the tiny decoder's loss hardly
    depends on the encoder)."""
    cfg = ARCHITECTURES[arch].reduced(**KW)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, seq + 1))
           .astype(np.int32)}
    if cfg.encoder is not None:
        out["frame_embeds"] = rng.standard_normal(
            (batch, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return out


def _port(arch, route="plain"):
    _, tcfg = _cfgs(arch, **FLAGS[route])
    return build_model(tcfg), from_jax_params(_jax_params(arch), tcfg,
                                              device="cpu")


def _assert_tree_close(got, want, **tol):
    got, want = jax.tree_util.tree_leaves_with_path(got), \
        jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _port_grads(model, params, batch, remat):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


# ---------------------------------------------------------------------------
# SSDScan
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, B=2, L=32, H=4, P=8, G=2, N=4, dtype=np.float32):
    """numpy x, dt, A, Bm, Cm and a state: dt a small softplus output, as
    the model's, A negative."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(dtype)
    return (r(B, L, H, P), np.log1p(np.exp(r(B, L, H) - 2)).astype(dtype),
            -np.exp(r(H)).astype(dtype), r(B, L, G, N), r(B, L, G, N),
            r(B, H, N, P))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_scan_passes_gradcheck_in_f64(with_state, return_state):
    arrays = _ssd_inputs(1, B=1, L=12, H=2, P=3, G=1, N=2, dtype=np.float64)
    inputs = [torch.tensor(a, requires_grad=True) for a in arrays]
    if not with_state:
        inputs[5] = None

    def fn(x, dt, A, Bm, Cm, *state):
        return ss.ssd_scan(x, dt, A, Bm, Cm, 4, state[0] if state else None,
                           return_state=return_state)

    assert torch.autograd.gradcheck(
        fn, tuple(t for t in inputs if t is not None))


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_gradients_match_jax_ssd_chunked(with_state):
    """Cotangents on y and on the final state, every input's gradient."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2)
    rng = np.random.default_rng(3)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gh = rng.standard_normal(h0.shape).astype(np.float32)
    n_in = 6 if with_state else 5

    def jfn(*a):
        y, h = jax_ssm.ssd_chunked(*a[:5], 16, a[5] if with_state else None)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want = jax.grad(jfn, argnums=tuple(range(n_in)))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm, h0)))
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, dt, A, Bm, Cm, h0)[:n_in]]
    y, h = ss.ssd_scan(*ts[:5], 16, ts[5] if with_state else None,
                       return_state=True)
    got = torch.autograd.grad((y * torch.tensor(gy)).sum()
                              + (h * torch.tensor(gh)).sum(), ts)
    for name, g, w in zip("x dt A Bm Cm init_state".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_padded_rows_get_no_gradient():
    """Rows past the sequence as ``mamba_block_full`` pads them (x, dt, B
    and C zero; no cotangent on their y, none on the final state) get a
    zero gradient in every input, and the live rows' gradient equals that
    of the unpadded scan."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(4, L=24)
    pad = [(0, 0), (0, 8)]

    def padded(a):
        return np.pad(a, pad + [(0, 0)] * (a.ndim - 2))

    rng = np.random.default_rng(5)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    grads = []
    for arrays, L in (((x, dt, A, Bm, Cm), 24),
                      ((padded(x), padded(dt), A, padded(Bm), padded(Cm)),
                       32)):
        ts = [torch.tensor(a, requires_grad=True) for a in arrays]
        y = ss.ssd_scan(*ts, 8 if L == 24 else 16)
        grads.append(torch.autograd.grad(
            (y[:, :24] * torch.tensor(gy)).sum(), ts))
    # chunk 8 unpadded against chunk 16 padded: one function, two chunkings
    for name, live, full in zip("x dt A Bm Cm".split(), *grads):
        if name != "A":
            assert torch.count_nonzero(full[:, 24:]) == 0, name
            full = full[:, :24]
        torch.testing.assert_close(full, live, **TOL, msg=name)


# ---------------------------------------------------------------------------
# each family's loss and gradients
# ---------------------------------------------------------------------------

def _jax_loss(arch, batch, remat):
    jcfg, _ = _cfgs(arch)
    jmodel = jax_build_model(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return jmodel.loss(p, jbatch, remat=remat)

    (value, metrics), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree.map(jnp.asarray, _jax_params(arch)))
    return float(value), metrics, jax.tree.map(np.asarray, grads)


_JAX_GRADS = {}


def _jax_grads(arch, seq, remat):
    key = (arch, seq, remat)
    if key not in _JAX_GRADS:
        _JAX_GRADS[key] = _jax_loss(arch, _batch(arch, seq, seed=seq), remat)
    return _JAX_GRADS[key]


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("arch,route", CASES)
def test_loss_matches_jax(arch, route, seq):
    want, wm, _ = _jax_grads(arch, seq, True)
    model, params = _port(arch, route)
    batch = {k: torch.tensor(v) for k, v in _batch(arch, seq, seed=seq)
             .items()}
    with torch.no_grad():
        got, gm = model.loss(params, batch)
    np.testing.assert_allclose(float(got), want, **TOL)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), **TOL)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    assert np.isfinite(want) and want > 1.0


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("arch,route", CASES)
def test_gradients_match_jax_grad(arch, route, seq, remat):
    want_loss, _, want = _jax_grads(arch, seq, remat)
    model, params = _port(arch, route)
    batch = {k: torch.tensor(v) for k, v in _batch(arch, seq, seed=seq)
             .items()}
    loss, _, grads = _port_grads(model, params, batch, remat)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    _assert_tree_close(to_jax_layout(grads), want, **TOL)


def test_the_shared_block_sums_its_sites():
    """zamba2 at 4 layers runs the shared block at 2 sites (at the other
    cases' 2 layers, at one): its gradient is the sum over both, as
    ``jax.grad``'s."""
    jcfg, tcfg = (dataclasses.replace(c, num_layers=4)
                  for c in _cfgs(ZAMBA))
    jparams = jax_build_model(jcfg).init(jax.random.key(1))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tokens = _batch(ZAMBA, 16, seed=7)["tokens"]
    want = jax.jit(jax.grad(lambda p: jax_build_model(jcfg).loss(
        p, {"tokens": jnp.asarray(tokens)})[0]))(jparams)
    _, _, grads = _port_grads(build_model(tcfg), tparams,
                              {"tokens": torch.tensor(tokens)}, True)
    _assert_tree_close(to_jax_layout(grads)["shared_attn"],
                       jax.tree.map(np.asarray, want["shared_attn"]), **TOL)


# ---------------------------------------------------------------------------
# three AdamW steps
# ---------------------------------------------------------------------------

STEP_CASES = [(MAMBA, "plain"), (ZAMBA, "flash"), (WHISPER, "flash")]


def _step_batches(arch, n=3, batch=4, seq=24):
    cfg = ARCHITECTURES[arch].reduced(**KW)
    it = iter(JaxDataset(cfg.vocab_size, seq, batch, seed=3))
    extras = {k: v for k, v in _batch(arch, seq, batch, seed=9).items()
              if k != "tokens"}
    return [{"tokens": next(it)["tokens"], **extras} for _ in range(n)]


@pytest.mark.parametrize("arch,route", STEP_CASES)
def test_three_adamw_steps_match_jax(arch, route):
    jcfg, _ = _cfgs(arch)
    batches = _step_batches(arch)
    opt = JaxAdamW(learning_rate=jax_cosine(1e-3, 2, 3))
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg), opt))
    jparams = jax.tree.map(jnp.asarray, _jax_params(arch))
    jstate = opt.init(jparams)
    want = []
    for b in batches:
        jparams, jstate, m = step(jparams, jstate,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))

    model, params = _port(arch, route)
    topt = AdamW(learning_rate=cosine_schedule(1e-3, 2, 3))
    state = topt.init(params)
    tstep = make_train_step(model, topt)
    for b, (want_loss, want_norm) in zip(batches, want):
        params, state, m = tstep(params, state,
                                 {k: torch.tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), want_loss, **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), want_norm, **TOL)
    assert state.step == 3
    _assert_tree_close(to_jax_layout(params),
                       jax.tree.map(np.asarray, jparams), **TOL)
    _assert_tree_close(to_jax_layout(state.mu),
                       jax.tree.map(np.asarray, jstate.mu), **TOL)


# ---------------------------------------------------------------------------
# launch/train.py's modality extras, and train_tiny
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,extra", [("llava-next-34b", "patch_embeds"),
                                        (WHISPER, "frame_embeds")])
def test_train_feeds_the_modality_extras(monkeypatch, arch, extra):
    args = train_cli.parse_args(["--arch", arch, "--device", "cpu",
                                 "--steps", "3", "--batch", "2", "--seq",
                                 "16", "--layers", "1", "--d-model", "64",
                                 "--log-every", "1"])
    cfg = get_arch(arch).reduced(num_layers=1, d_model=64)
    seen = []
    real = port_factory.build_model

    def recording(c):
        model = real(c)

        def loss(params, batch, remat=True):
            seen.append({k: v.clone() for k, v in batch.items()})
            return model.loss(params, batch, remat=remat)
        return dataclasses.replace(model, loss=loss)

    monkeypatch.setattr(train_cli, "build_model", recording)
    out = train_cli.train(cfg, args)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 3
    want = port_factory.batch_struct(cfg, 2, 16, "train")
    assert len(seen) == 3
    for batch in seen:
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} \
            == want
        assert torch.equal(batch[extra], seen[0][extra])
    assert not torch.equal(seen[0]["tokens"], seen[1]["tokens"])
    assert float(seen[0][extra].std()) == pytest.approx(0.02, rel=0.2)


@pytest.mark.parametrize("arch", ["granite-3-2b", MAMBA, WHISPER])
def test_train_tiny_small_lowers_the_loss(capsys, arch):
    out = train_tiny.main(["--small", "--steps", "4", "--arch", arch,
                           "--device", "cpu"])
    assert out["last_loss"] < out["first_loss"]
    assert "OK: loss decreased" in capsys.readouterr().out
