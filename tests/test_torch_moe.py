"""The port's MoE layer and the MoE / VLM transformer
(``repro_torch.models.moe``, ``models/transformer.py``) on the CPU against
the JAX package's, on the same weights (drawn by ``jax.random.key``,
carried across by ``models/convert.py``) and the same numpy-seeded
inputs:

  * ``_topk_routing`` (ties broken to the lower expert index, as
    ``jax.lax.top_k`` does, under a zero router), ``_dispatch_slots``
    (which pairs the capacity drops) and ``apply_moe``: capacity drops
    (``capacity_factor`` 0.5), fine-grained experts (E 16, k 4),
    ``dispatch_groups`` 4;
  * the serving paths ``prefill_chunk_paged``, ``decode_step_paged``,
    ``prefill`` and ``decode_step`` of reduced qwen3-moe-30b-a3b and
    dbrx-132b; llava-next-34b's ``prefill`` with ``patch_embeds`` and its
    decode from ``L + num_patch_tokens``;
  * ``loss_fn`` (aux loss included) and its gradients against
    ``jax.grad``, remat on and off.

Tolerances (f32): 1e-5 on MoE outputs and the aux loss, 2e-3 on logits
(the reference's consistency test), 1e-4 on losses and gradients (the
port's training tests); routing ids, drops and slots exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.comm_analysis import DeviceCounter, ReplicateFallback
from repro_torch.models import build_model, moe
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.models.model_factory import batch_struct, materialize_batch
from repro_torch.training.optimizer import tree_leaves, tree_unflatten

torch.set_num_threads(2)
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
QWEN3, DBRX, LLAVA = "qwen3-moe-30b-a3b", "dbrx-132b", "llava-next-34b"
# the card's GQA groups (8, 6, 7) at head_dim 16
REDUCED = {QWEN3: dict(num_layers=2, d_model=128, num_heads=8, num_kv_heads=1),
           DBRX: dict(num_layers=2, d_model=96, num_heads=6, num_kv_heads=1),
           LLAVA: dict(num_layers=2, d_model=112, num_heads=7,
                       num_kv_heads=1)}
N, BS, NB = 16, 8, 6


def _cfgs(arch, **moe_over):
    jcfg = ARCHITECTURES[arch].reduced(**REDUCED[arch])
    tcfg = get_arch(arch).reduced(**REDUCED[arch])
    if moe_over:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_over))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_over))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _pair(arch, **moe_over):
    jcfg, tcfg = _cfgs(arch, **moe_over)
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    return (jmodel, jax.tree.map(jnp.asarray, jparams), build_model(tcfg),
            from_jax_params(jparams, tcfg, device="cpu"), jparams)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, **moe_over):
        key = (arch,) + tuple(sorted(moe_over.items()))
        if key not in cache:
            cache[key] = _pair(arch, **moe_over)
        return cache[key]
    return get


def _layer0(jparams):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), jparams["blocks"]["moe"])


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_topk_routing_breaks_ties_as_jax(k):
    """A zero router ties all 16 experts on every token; bf16-rounded
    logits tie some.  Ids equal, weights and aux loss within 1e-5."""
    rng = np.random.default_rng(k)
    ties = np.round(rng.standard_normal((24, 16)) * 2) / 2
    ids = []
    for logits in (np.zeros((24, 16), np.float32),
                   ties.astype(np.float32)):
        jw, ji, ja = jax_moe._topk_routing(jnp.asarray(logits), k)
        tw, ti, ta = moe._topk_routing(torch.tensor(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **MOE_TOL)
        np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)
        ids.append(ti)
    assert (ids[0] == torch.arange(k)).all()       # all tied: 0..k-1


@pytest.mark.parametrize("n,E,capacity", [(32, 4, 5), (64, 16, 3),
                                          (17, 8, 1), (40, 4, 40)])
def test_dispatch_slots_match_jax(n, E, capacity):
    """keep and slot exact: the capacity drops the same (token, choice)
    pairs, in pair order within each expert."""
    ids = np.random.default_rng(n).integers(0, E, size=n)
    jk, js = jax_moe._dispatch_slots(jnp.asarray(ids, jnp.int32), capacity, E)
    tk, ts = moe._dispatch_slots(torch.tensor(ids), capacity, E)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (capacity < n // E) == (not tk.all())


@pytest.mark.parametrize("G,n,E,capacity", [(4, 24, 4, 3), (3, 40, 16, 2),
                                            (2, 17, 8, 17)])
def test_batched_dispatch_slots_match_jax_per_group(G, n, E, capacity):
    """``_dispatch_slots`` on (G, N) ids ranks each row on its own: keep
    and slot exact against the reference's on each group."""
    ids = np.random.default_rng(G * n).integers(0, E, size=(G, n))
    tk, ts = moe._dispatch_slots(torch.tensor(ids), capacity, E)
    for g in range(G):
        jk, js = jax_moe._dispatch_slots(jnp.asarray(ids[g], jnp.int32),
                                         capacity, E)
        np.testing.assert_array_equal(tk[g].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ts[g].numpy(), np.asarray(js))


CASES = {"qwen3": (QWEN3, {}),
         "drops": (QWEN3, {"capacity_factor": 0.5}),
         "fine": (QWEN3, {"num_experts": 16, "experts_per_token": 4}),
         "groups": (QWEN3, {"dispatch_groups": 4}),
         "groups16": (QWEN3, {"dispatch_groups": 16,
                              "capacity_factor": 0.5}),
         "dbrx": (DBRX, {})}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", [(2, 5), (8, 1), (4, 16)])
def test_apply_moe_matches_jax(pairs, case, shape):
    arch, over = CASES[case]
    jmodel, _, tmodel, tparams, jparams = pairs(arch, **over)
    cfg = tmodel.cfg
    x = np.random.default_rng(sum(shape)).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    jo, ja = jax_moe.apply_moe(_layer0(jparams), jmodel.cfg, jnp.asarray(x))
    to, ta = moe.apply_moe(tparams["blocks"][0]["moe"], cfg, torch.tensor(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MOE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)
    assert ta.dtype == torch.float32 and to.shape == x.shape


def test_capacity_drops_are_exercised(pairs):
    """At capacity_factor 0.5 some pairs drop, and the dropped tokens'
    outputs still match (only their kept choices contribute)."""
    _, _, tmodel, tparams, _ = pairs(QWEN3, capacity_factor=0.5)
    cfg = tmodel.cfg
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (32, cfg.d_model)).astype(np.float32))
    _, ids, _ = moe._topk_routing(x @ tparams["blocks"][0]["moe"]["router"],
                                  cfg.moe.experts_per_token)
    T, k, E = 32, cfg.moe.experts_per_token, cfg.moe.num_experts
    cap = max(int(np.ceil(T * k / E * 0.5)), k)
    keep, _ = moe._dispatch_slots(ids.reshape(-1), cap, E)
    assert 0 < int((~keep).sum()) < T * k


def test_zero_router_routes_alike_and_matches_jax(pairs):
    """Every token ties over every expert: all take experts 0..k-1 and the
    capacity drops the later tokens' pairs, on both sides."""
    jmodel, _, tmodel, tparams, jparams = pairs(QWEN3)
    jp = dict(_layer0(jparams))
    jp["router"] = jnp.zeros_like(jp["router"])
    tp = dict(tparams["blocks"][0]["moe"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = np.random.default_rng(5).standard_normal(
        (2, 8, tmodel.cfg.d_model)).astype(np.float32)
    jo, ja = jax_moe.apply_moe(jp, jmodel.cfg, jnp.asarray(x))
    to, ta = moe.apply_moe(tp, tmodel.cfg, torch.tensor(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MOE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)
    # past the capacity the last tokens keep nothing and output zeros
    assert not to.reshape(16, -1)[-1].any()


def test_bf16_combine_is_ordered_and_repeatable(pairs, monkeypatch):
    """In bf16 the combine adds each token's k outputs in choice order with
    plain adds, no scatter-add (whose atomics add in no fixed order on a
    card): every call gives the same bits."""
    _, _, tmodel, tparams, _ = pairs(QWEN3, num_experts=16,
                                     experts_per_token=4)
    cfg = tmodel.cfg
    p = {k: v.bfloat16() for k, v in tparams["blocks"][0]["moe"].items()}
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)).bfloat16()

    def unordered(*_, **__):
        raise AssertionError("scatter-add in the combine")

    with monkeypatch.context() as m:
        for name in ("index_add_", "index_add", "scatter_add_",
                     "scatter_add", "scatter_reduce_", "put_"):
            m.setattr(torch.Tensor, name, unordered)
        a, _ = moe.apply_moe(p, cfg, x)
        b, _ = moe.apply_moe(p, cfg, x)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    f32, _ = moe.apply_moe(tparams["blocks"][0]["moe"], cfg, x.float())
    torch.testing.assert_close(a.float(), f32, atol=3e-2, rtol=3e-2)


def test_grouped_dispatch_runs_shard_local_on_a_mesh():
    """On a fake 2 x 2 mesh (batch on "data", experts on "model"), the
    grouped dispatch's sort, ranking, scatter and combine run on each
    device's own groups, forward and backward: no op falls back, the only
    forward collectives are the router softmax's gather of this device's
    logits and the aux loss's all-reduce, and the output is a partial sum
    over "model" until the combine's all-reduce, which leaves it split
    over "data" alone."""
    cfg = get_arch(QWEN3).reduced(num_layers=1, d_model=64)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=4))
    model = build_model(cfg)
    mesh_lib.release()
    try:
        mesh = mesh_lib.make_debug_mesh(2, 2)
        tree = model.eval_shape_params(torch.float32)
        params = sh.distribute(mesh, tree, sh.build_shardings(
            mesh, tree, model.param_axes(), sh.ShardingRules.default()))
        p = params["blocks"][0]["moe"]
        assert p["gate"].placements == (Replicate(), Shard(0))
        for leaf in p.values():
            leaf.requires_grad_(True)
        x = distribute_tensor(torch.zeros(4, 8, cfg.d_model, device="meta",
                                          requires_grad=True), mesh,
                              [Shard(0), Replicate()])
        counter = DeviceCounter()
        fallback = ReplicateFallback(counter)
        with counter, fallback, implicit_replication():
            out, aux = moe.apply_moe(p, cfg, x)
            forward = counter.collectives()
            (out.float().sum() + aux).backward()
        assert not fallback.fallbacks
        assert out.placements == (Shard(0), Replicate())
        E = cfg.moe.num_experts
        logits = (4 // 2) * 8 * E * 4          # this device's tokens, f32
        assert forward.bytes_by_op.get("all-gather", 0) <= logits
        assert set(forward.bytes_by_op) <= {"all-gather", "all-reduce"}
        # each data shard's part of the experts' gradient, still split
        # over "model"
        assert p["gate"].grad.placements == (Partial(), Shard(0))
    finally:
        mesh_lib.release()


@pytest.mark.parametrize("coord", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_grouped_partial_on_a_mesh_equals_the_plain_on_its_experts(coord):
    """On a fake 2 x 2 mesh with real CPU values, this process (rank 0,
    placed at mesh coordinate ``coord`` = (data, model)) holds groups
    [2 data, 2 data + 2) and experts [2 model, 2 model + 2) of 4.  Its
    local partial from ``_moe_groups`` equals the plain ``_moe_groups``
    of the same groups with the other experts' down projection zeroed
    (their pairs then add exact zeros): a wrong expert offset or a
    dropped owned pair shows.  No op falls back and nothing is
    communicated.  Tolerance 1e-6."""
    cfg = get_arch(QWEN3).reduced(num_layers=1, d_model=64)
    E, k, G, Tg, C = cfg.moe.num_experts, cfg.moe.experts_per_token, 4, 8, 3
    rng = np.random.default_rng(7)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                     torch.device("cpu"))
    xg = torch.tensor(rng.standard_normal((G, Tg, cfg.d_model)),
                      dtype=torch.float32)
    wg, eg, _ = moe._topk_routing(torch.tensor(
        rng.standard_normal((G * Tg, E)), dtype=torch.float32), k)
    wg, eg = wg.reshape(G, Tg, k), eg.reshape(G, Tg, k)
    keep, _ = moe._dispatch_slots(eg.reshape(G, Tg * k), C, E)
    assert not keep.all()                      # the capacity drops pairs
    g0, e0 = 2 * coord[0], 2 * coord[1]
    plain_p = dict(p, down=p["down"].clone())
    plain_p["down"][[e for e in range(E) if not e0 <= e < e0 + 2]] = 0
    want = moe._moe_groups(plain_p, xg, wg, eg, C, E)[g0:g0 + 2]
    assert want.abs().sum() > 0
    # rank 0 at ``coord``: a layout of its own, so that no sharding
    # cached for another layout (and its coordinate) is reused
    ranks = np.arange(4).reshape(2, 2)
    ranks[coord], ranks[0, 0] = 0, ranks[coord]
    mesh_lib.release()
    try:
        mesh_lib.make_debug_mesh(2, 2)
        mesh = DeviceMesh("cpu", torch.tensor(ranks),
                          mesh_dim_names=("data", "model"))
        assert tuple(mesh.get_coordinate()) == coord
        groups = [Shard(0), Replicate()]
        xd, wd, ed = (DTensor.from_local(t[g0:g0 + 2], mesh, groups,
                                         run_check=False)
                      for t in (xg, wg, eg))
        pd = {name: DTensor.from_local(
                  w if name == "router" else w[e0:e0 + 2], mesh,
                  [Replicate(), Replicate() if name == "router"
                   else Shard(0)], run_check=False)
              for name, w in p.items()}
        counter = DeviceCounter()
        fallback = ReplicateFallback(counter)
        with counter, fallback:
            out = moe._moe_groups(pd, xd, wd, ed, C, E)
        assert not fallback.fallbacks
        assert counter.collectives().total_count == 0
        assert out.placements == (Shard(0), Partial())
        torch.testing.assert_close(out.to_local(), want, atol=1e-6,
                                   rtol=1e-6)
    finally:
        mesh_lib.release()


def test_init_moe_shapes_and_scales():
    cfg = get_arch(QWEN3).reduced(d_model=256, max_experts=8)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32, torch.device("cpu"))
    E, d, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert p["router"].shape == (d, E)
    assert p["gate"].shape == p["up"].shape == (E, d, F)
    assert p["down"].shape == (E, F, d)
    # a unit normal cut at 2 std has std 0.8796
    for name, fan_in in (("gate", d), ("up", d), ("down", F)):
        w = p[name]
        assert abs(float(w.std()) * np.sqrt(fan_in) - 0.8796) < 0.01
        assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) + 1e-6


def test_apply_moe_makes_no_host_sync(pairs, monkeypatch):
    """No ``.item()``, ``.cpu()``, ``.tolist()``, ``nonzero`` or
    ``bool(tensor)`` inside ``apply_moe``: its shapes come from the
    config and the input's shape alone."""
    _, _, tmodel, tparams, _ = pairs(QWEN3, capacity_factor=0.5)

    def host_sync(*_, **__):
        raise AssertionError("host sync inside apply_moe")

    x = torch.randn(4, 3, tmodel.cfg.d_model)
    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist", "nonzero", "__bool__"):
            m.setattr(torch.Tensor, name, host_sync)
        out, aux = moe.apply_moe(tparams["blocks"][0]["moe"], tmodel.cfg, x)
    assert torch.isfinite(out).all() and torch.isfinite(aux)


# ---------------------------------------------------------------------------
# the serving paths
# ---------------------------------------------------------------------------

def _prefill_batch(cfg, tokens, seed, as_torch):
    batch = {"tokens": tokens}
    if cfg.vision is not None:
        pe = (0.02 * np.random.default_rng(seed).standard_normal(
            (tokens.shape[0], cfg.vision.num_patch_tokens, cfg.d_model))
              ).astype(np.float32)
        batch["patch_embeds"] = torch.tensor(pe) if as_torch \
            else jnp.asarray(pe)
    return batch


@pytest.mark.parametrize("arch", [QWEN3, DBRX])
def test_paged_chunks_and_decode_match_jax(pairs, arch):
    """The page pool: a 30-token prompt over scattered pages in two
    chunks, a 9-token prompt, an empty slot (its padding rows count
    toward the capacity on both sides); then three decode steps."""
    jmodel, jparams, tmodel, tparams, _ = pairs(arch)
    rng = np.random.default_rng(2)
    bt = np.full((3, NB), N, np.int32)
    bt[0, :5] = [3, 7, 1, 12, 5]
    bt[1, :2] = [9, 2]
    prompts = [rng.integers(0, 500, size=30), rng.integers(0, 500, size=9)]
    jcache = jmodel.init_paged_cache(N, BS)
    tcache = tmodel.init_paged_cache(N, BS, torch.float32, "cpu")
    tbt = torch.tensor(bt)
    for starts, valid in ((np.array([0, 0, 0], np.int32),
                           np.array([16, 9, 0], np.int32)),
                          (np.array([16, 9, 0], np.int32),
                           np.array([14, 0, 0], np.int32))):
        tokens = np.zeros((3, 16), np.int32)
        for b, p in enumerate(prompts):
            tokens[b, :valid[b]] = p[starts[b]:starts[b] + valid[b]]
        jl, jcache = jmodel.prefill_chunk_paged(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(starts),
            jnp.asarray(valid), jnp.asarray(bt))
        tl, tcache = tmodel.prefill_chunk_paged(
            tparams, tcache, torch.tensor(tokens), torch.tensor(starts),
            torch.tensor(valid), tbt)
        live = valid > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGIT_TOL)
    lengths = np.array([30, 9, 0], np.int32)
    tokens = np.array([prompts[0][-1], prompts[1][-1], 0], np.int32)
    for _ in range(3):
        jl, jcache = jmodel.decode_step_paged(
            jparams, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
            jnp.asarray(bt))
        tl, tcache = tmodel.decode_step_paged(
            tparams, tcache, torch.tensor(tokens), torch.tensor(lengths), tbt)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **LOGIT_TOL)
        tokens = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tokens[:2],
                                      np.asarray(jl).argmax(-1)[:2])
        lengths = lengths + np.array([1, 1, 0], np.int32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, :N].numpy(),
                                   np.asarray(jcache[name]), **LOGIT_TOL)


@pytest.mark.parametrize("arch", [QWEN3, DBRX, LLAVA])
def test_single_shot_prefill_and_decode_match_jax(pairs, arch):
    """``prefill`` of two prompts into the dense per-slot cache (llava:
    after its patch prefix), then three decode steps from ``L`` plus the
    patch tokens, as the reference's consistency test decodes."""
    jmodel, jparams, tmodel, tparams, _ = pairs(arch)
    cfg = tmodel.cfg
    B, L, S = 2, 11, 48
    tokens = np.random.default_rng(3).integers(0, 500, size=(B, L),
                                               dtype=np.int32)
    jl, jcache = jmodel.prefill(
        jparams, _prefill_batch(cfg, jnp.asarray(tokens), 4, False),
        jmodel.init_cache(B, S))
    tl, tcache = tmodel.prefill(
        tparams, _prefill_batch(cfg, torch.tensor(tokens), 4, True),
        tmodel.init_cache(B, S, torch.float32, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    plen = L + (cfg.vision.num_patch_tokens if cfg.vision else 0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, :, :, :plen].numpy(),
                                   np.asarray(jcache[name])[:, :, :, :plen],
                                   **LOGIT_TOL)
    lengths = np.full(B, plen, np.int32)
    nxt = tl.argmax(-1).to(torch.int32).numpy()
    for _ in range(3):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt),
                                        jnp.asarray(lengths))
        tl, tcache = tmodel.decode_step(tparams, tcache, torch.tensor(nxt),
                                        torch.tensor(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        nxt = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(nxt, np.asarray(jl).argmax(-1))
        lengths = lengths + 1


def test_decode_from_the_patch_prefix_matches_teacher_forcing(pairs):
    """The port alone, as the reference's ``test_decode_matches_prefill``:
    prefill L tokens then decode 3 teacher-forced ones from ``L +
    num_patch_tokens`` gives the logits of prefilling all L + 3.  (Not for
    MoE, as there: the capacity depends on how many tokens a call routes,
    so a drop in the long prefill need not happen in decode.)"""
    _, _, tmodel, tparams, _ = pairs(LLAVA)
    cfg = tmodel.cfg
    B, L, S = 2, 10, 32
    tokens = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(B, L + 3), dtype=np.int32))
    want, _ = tmodel.prefill(tparams, _prefill_batch(cfg, tokens, 7, True),
                             tmodel.init_cache(B, S, torch.float32, "cpu"))
    got, cache = tmodel.prefill(
        tparams, _prefill_batch(cfg, tokens[:, :L], 7, True),
        tmodel.init_cache(B, S, torch.float32, "cpu"))
    lengths = torch.full((B,), L + (cfg.vision.num_patch_tokens
                                    if cfg.vision else 0), dtype=torch.int32)
    for t in range(3):
        got, cache = tmodel.decode_step(tparams, cache, tokens[:, L + t],
                                        lengths)
        lengths = lengths + 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)


def test_vlm_prefill_needs_patch_embeds(pairs):
    _, _, tmodel, tparams, _ = pairs(LLAVA)
    with pytest.raises(ValueError, match="patch_embeds"):
        tmodel.prefill(tparams, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                       tmodel.init_cache(1, 32, torch.float32, "cpu"))


# ---------------------------------------------------------------------------
# training: loss, aux and gradients
# ---------------------------------------------------------------------------

def _train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 17)
                                    ).astype(np.int32)}
    if cfg.vision is not None:
        batch["patch_embeds"] = (0.02 * rng.standard_normal(
            (2, cfg.vision.num_patch_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _assert_tree_close(got, want, **tol):
    got, want = jax.tree_util.tree_leaves_with_path(got), \
        jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", [QWEN3, LLAVA])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax_grad(pairs, arch, remat):
    jmodel, jparams, tmodel, tparams, _ = pairs(arch)
    batch = _train_batch(tmodel.cfg, 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wm), wgrad = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, remat=remat), has_aux=True)(jparams)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tparams)]
    params = tree_unflatten(tparams, leaves)
    got, gm = tmodel.loss(params, {k: torch.tensor(v)
                                   for k, v in batch.items()}, remat=remat)
    np.testing.assert_allclose(float(got.detach()), float(want), **GRAD_TOL)
    np.testing.assert_allclose(float(gm["ce"].detach()), float(wm["ce"]),
                               **GRAD_TOL)
    aux = float(gm["aux"].detach())
    np.testing.assert_allclose(aux, float(wm["aux"]), **MOE_TOL)
    if tmodel.cfg.moe is not None:
        assert aux > 0 and float(got.detach()) != float(gm["ce"].detach())
    grads = torch.autograd.grad(got, leaves)
    _assert_tree_close(to_jax_layout(tree_unflatten(tparams, list(grads))),
                       jax.tree.map(np.asarray, wgrad), **GRAD_TOL)


def test_convert_carries_experts_router_and_vision_proj(pairs):
    """Stacked (layers, E, d, F) experts, the router and the top-level
    vision projection go across and back unchanged."""
    for arch in (QWEN3, LLAVA):
        *_, tparams, jparams = pairs(arch)
        back = to_jax_layout(tparams)
        _assert_tree_close(back, jparams, atol=0, rtol=0)
    assert tparams["vision_proj"].shape == (112, 112)
    q = pairs(QWEN3)[3]["blocks"][1]["moe"]
    assert q["gate"].shape == (4, 128, 128) and "mlp" not in \
        pairs(QWEN3)[3]["blocks"][1]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_struct_matches_jax(kind):
    """The modality stubs: shapes and dtypes of the reference's
    ``batch_struct``, and ``materialize_batch`` draws them."""
    from repro.models import model_factory as jax_factory
    for arch in (QWEN3, LLAVA):
        jcfg, tcfg = _cfgs(arch)
        want = jax_factory.batch_struct(jcfg, 2, 12, kind)
        got = batch_struct(tcfg, 2, 12, kind)
        assert {k: tuple(v.shape) for k, v in want.items()} \
            == {k: shape for k, (shape, _) in got.items()}
        gen = torch.Generator().manual_seed(0)
        data = materialize_batch(tcfg, 2, 12, kind, gen, device="cpu")
        for name, (shape, dt) in got.items():
            assert data[name].shape == shape and data[name].dtype == dt
        if kind == "decode":
            assert (data["lengths"] == 11).all()
        if kind == "train" and tcfg.vision is not None:
            loss, _ = build_model(tcfg).loss(
                build_model(tcfg).init(gen, torch.float32, "cpu"), data)
            assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the padding rows an MoE layer routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 16, 100, 128, 129, 192, 256, 384, 510, 521])
def test_reference_q_tile_is_the_pallas_kernels(C):
    from repro.kernels import paged_prefill_attention as jax_ppa
    from repro_torch.kernels import paged_prefill_attention as ppa
    assert ppa.reference_q_tile(C) == jax_ppa.auto_q_tile(C)


@pytest.mark.parametrize("C,valid", [(16, [16, 5, 0, 1]),
                                     (256, [256, 100, 0, 129])])
def test_prefill_padding_rows_match_the_pallas_kernel(C, valid):
    """Every row, padding rows past ``valid`` included, equals the JAX
    Pallas kernel's (interpret mode): within a live q tile they follow
    the causal rule, a q tile past ``valid`` is zero.  A chunk round of an
    MoE model routes these rows through its experts, where they use
    capacity, so a kernel that left them at other values would change
    which real tokens drop."""
    from repro.kernels import ops
    from repro_torch.kernels import paged_prefill_attention as ppa
    rng = np.random.default_rng(C)
    B, H, KVH, D, bs = len(valid), 4, 1, 32, 8
    nb = (24 + C + bs - 1) // bs
    N = 4 * B * nb
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, C, D), (N, KVH, bs, D), (N, KVH, bs, D), (B, KVH, C, D),
        (B, KVH, C, D))]
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    st = np.array([24, 0, 8, 16][:B], np.int32)
    vd = np.array(valid, np.int32)
    want = np.asarray(ops.paged_prefill_attention(*arrays, bt, st, vd))
    got = ppa.paged_prefill_attention(*[torch.from_numpy(a) for a in
                                        (*arrays, bt, st, vd)]).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    live = ppa.live_rows(C, torch.tensor(vd)).tolist()
    for b in range(B):
        assert not got[b, :, live[b]:].any()
    assert live == ([16, 16, 0, 16] if C == 16 else [256, 128, 0, 256])
