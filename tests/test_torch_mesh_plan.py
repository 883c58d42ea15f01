"""The port's sharded plan against the reference's XLA plan: the places
where the dry run paid for collectives that XLA does not, repaired to
run shard-local, each held per mesh coordinate against the plain version
on real values (a fake 2 x 2 mesh, ``launch/mesh.py``: this process is
rank 0, placed at a coordinate of its choice; the fake group's
all-gather hands every rank rank 0's shard and its all-reduce returns
rank 0's own, so a value gathered along an axis is made periodic there,
and a completed partial sum is this rank's share).

  * ``_sdpa`` on a mesh whose "model" shards cut a KV head's group of
    query heads (``models/attention.py::_sdpa_local``): each shard
    attends its own query heads against their KV head's k and v, as XLA
    splits the heads over KV heads and groups at once; no collective
    forward or backward, the output split as q, k's and v's gradients
    partial sums over "model";
  * the grouped MoE dispatch (``models/moe.py::_moe_groups``): each
    device dispatches its own groups' tokens into its own experts' rows,
    so the dispatch buffer's gradient never leaves it and the tokens'
    gradient comes back ``Partial()`` over the experts' axis; no
    collective forward or backward;
  * a sequence-split residual (``shard_activations_seq``) gathered once
    per sub-block (``models/transformer.py::_sub_block_input``), not by
    each projection;
  * the MoE router (``models/moe.py::_topk_routing_local``): the logits'
    expert axis gathered once, the sort and its backward local, the aux
    loss's two (E,) sums completed by one all-reduce each;
  * the microbatched step's gradients (``training/train_step.py``) stay
    in the placements of a single step's, partial sums partial, and each
    is reduced once before the norm and the optimizer.

The yardstick is the reference's own compile: ``test_xla_*`` compile its
train step of a reduced qwen3-moe with XLA on 8 CPU devices (a 2 x 4
mesh, 8 query heads on 2 KV heads, 4 experts in 2 dispatch groups), with
and without 2 microbatches, and hold XLA's plan to what the port now
does.  ``python tests/test_torch_mesh_plan.py`` prints its collectives.

Tolerance: 1e-6 (f32; the local and the plain computations take the
same products in the same order but for the batching of heads).
"""
import dataclasses
import functools
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_arch
from repro_torch.launch import comm_analysis, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.comm_analysis import DeviceCounter, ReplicateFallback
from repro_torch.models import attention, moe, transformer
from repro_torch.training import train_step
from repro_torch.training.optimizer import AdamW, tree_leaves

COORDS = [(0, 0), (0, 1), (1, 0), (1, 1)]
TOL = dict(atol=1e-6, rtol=1e-6)


def _mesh_at(coord):
    """A fake 2 x 2 ("data", "model") mesh with this process (rank 0) at
    ``coord``."""
    mesh_lib.release()
    mesh_lib.make_debug_mesh(2, 2)
    ranks = np.arange(4).reshape(2, 2)
    ranks[coord], ranks[0, 0] = 0, ranks[coord]
    mesh = DeviceMesh("cpu", torch.tensor(ranks),
                      mesh_dim_names=("data", "model"))
    assert tuple(mesh.get_coordinate()) == coord
    return mesh


@pytest.fixture
def released():
    yield
    mesh_lib.release()


def _half(i, n):
    return slice(i * n, (i + 1) * n)


# ---------------------------------------------------------------------------
# the query heads split over KV heads and groups at once
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("kvh,H", [(1, 4), (3, 6)])
def test_sdpa_splits_the_query_heads_over_kv_heads_and_groups(
        released, kvh, H, coord):
    """(B, H, L, D) queries split over "data" (batch) and "model" (heads),
    where 2 "model" shards cut a KV head's group (1 KV head: each shard
    holds half of its group; 3: a shard's heads span two KV heads), k and
    v whole over "model": the forward and the backward issue no
    collective (no query gather, no reduction of the output's gradient)
    and nothing falls back; rank 0's output is the plain attention's at
    its rows and heads, its query gradient the plain one's, and its k and
    v gradients (``Partial()`` over "model") the plain ones from its own
    query heads alone."""
    B, L, hd = 4, 5, 4
    rng = np.random.default_rng(kvh)
    q, w = (rng.standard_normal((B, H, L, hd)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((B, kvh, L, hd)).astype(np.float32)
            for _ in range(2))
    mask = torch.tensor(np.tril(np.ones((L, L), bool)))[None, None]
    rows, heads = _half(coord[0], B // 2), _half(coord[1], H // 2)
    own = np.zeros_like(w)
    own[rows, heads] = w[rows, heads]          # rank 0's cotangent, zero-padded
    plain = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    want = attention._sdpa(*plain, mask)
    (want * torch.tensor(own)).sum().backward()

    mesh = _mesh_at(coord)
    split = [Shard(0), Shard(1)]
    batch = [Shard(0), Replicate()]
    qd = DTensor.from_local(torch.tensor(q[rows, heads]), mesh, split,
                            run_check=False).requires_grad_(True)
    kd, vd = (DTensor.from_local(torch.tensor(t[rows]), mesh, batch,
                                 run_check=False).requires_grad_(True)
              for t in (k, v))
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    with counter, fallback, implicit_replication():   # the plain mask
        out = attention._sdpa(qd, kd, vd, mask)
        assert counter.collectives().bytes_by_op == {}
        (out.to_local() * torch.tensor(w[rows, heads])).sum().backward()
    assert not fallback.fallbacks
    assert counter.collectives().bytes_by_op == {}
    assert out.placements == tuple(split)
    torch.testing.assert_close(out.to_local(), want[rows, heads], **TOL)
    torch.testing.assert_close(qd.grad.to_local(),
                               plain[0].grad[rows, heads], **TOL)
    for got, ref in ((kd, plain[1]), (vd, plain[2])):
        assert got.grad.placements == (Shard(0), Partial())
        torch.testing.assert_close(got.grad.to_local(), ref.grad[rows],
                                   **TOL)


# ---------------------------------------------------------------------------
# the grouped MoE dispatch's gradient, a partial sum over the experts
# ---------------------------------------------------------------------------

def _moe_case(seed):
    cfg = get_arch("qwen3-moe-30b-a3b").reduced(num_layers=1, d_model=64)
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    G, Tg, C = 4, 8, 3
    rng = np.random.default_rng(seed)
    p = moe.init_moe(torch.Generator().manual_seed(seed), cfg, torch.float32,
                     torch.device("cpu"))
    xg = torch.tensor(rng.standard_normal((G, Tg, cfg.d_model)),
                      dtype=torch.float32)
    wg, eg, _ = moe._topk_routing(torch.tensor(
        rng.standard_normal((G * Tg, E)), dtype=torch.float32), k)
    cot = torch.tensor(rng.standard_normal((G, Tg, cfg.d_model)),
                       dtype=torch.float32)
    return (p, xg, wg.reshape(G, Tg, k), eg.reshape(G, Tg, k), cot, C, E)


@pytest.mark.parametrize("coord", COORDS)
def test_the_dispatch_gradient_stays_on_its_device(released, coord):
    """Rank 0 at ``coord`` = (data, model) holds groups [2 data, 2 data +
    2) and experts [2 model, 2 model + 2) of 4: it dispatches its groups'
    tokens into its experts' rows alone.  The forward and the backward
    issue no collective (no gather of the (G, E * C, d) dispatch buffer
    or of its gradient) and nothing falls back.  Its combine is the plain
    one's with the other experts' down projection zeroed, and so is the
    tokens' gradient, which comes back ``Partial()`` over "model" (one
    all-reduce of the tokens' gradient completes it, where the block
    needs it whole); its experts' weight gradients are the plain ones
    from its own groups, ``Partial()`` over "data"."""
    p, xg, wg, eg, cot, C, E = _moe_case(7)
    g = slice(2 * coord[0], 2 * coord[0] + 2)
    e = slice(2 * coord[1], 2 * coord[1] + 2)
    others = dict(p, down=p["down"].clone())
    others["down"][[i for i in range(E) if i not in range(E)[e]]] = 0
    x_plain = xg[g].clone().requires_grad_(True)
    want = moe._moe_groups(others, x_plain, wg[g], eg[g], C, E)
    (want * cot[g]).sum().backward()
    weights = {name: w.clone().requires_grad_(True) for name, w in p.items()
               if name != "router"}
    (moe._moe_groups(weights, xg[g], wg[g], eg[g], C, E) * cot[g]
     ).sum().backward()

    mesh = _mesh_at(coord)
    groups = [Shard(0), Replicate()]
    xd = DTensor.from_local(xg[g].clone(), mesh, groups,
                            run_check=False).requires_grad_(True)
    wd, ed = (DTensor.from_local(t[g], mesh, groups, run_check=False)
              for t in (wg, eg))
    pd = {name: DTensor.from_local(w[e].clone(), mesh,
                                   [Replicate(), Shard(0)],
                                   run_check=False).requires_grad_(True)
          for name, w in p.items() if name != "router"}
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    with counter, fallback:
        out = moe._moe_groups(pd, xd, wd, ed, C, E)
        (out.to_local() * cot[g]).sum().backward()
    assert not fallback.fallbacks
    assert counter.collectives().bytes_by_op == {}
    assert out.placements == (Shard(0), Partial())
    torch.testing.assert_close(out.to_local(), want, **TOL)
    assert xd.grad.placements == (Shard(0), Partial())
    torch.testing.assert_close(xd.grad.to_local(), x_plain.grad, **TOL)
    for name, w in pd.items():
        assert w.grad.placements == (Partial(), Shard(0)), name
        torch.testing.assert_close(w.grad.to_local(),
                                   weights[name].grad[e], **TOL)


# ---------------------------------------------------------------------------
# the router, shard-local
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coord", COORDS)
def test_the_router_runs_on_each_devices_tokens(released, coord):
    """(T, E) logits split over "data" (tokens) and "model" (experts),
    rank 0 at ``coord`` holding rows [4 data, 4 data + 4) and experts [2
    model, 2 model + 2) of 4 (the logits are periodic over the experts,
    so the fake gather gives the real values).  The forward issues one
    all-gather of the logits' expert axis and an all-reduce of each of
    the aux loss's two (E,) sums, and nothing else on a (T, E) operand;
    the backward issues nothing and nothing falls back.  The weights and
    experts are the plain router's on rank 0's tokens (ties to the lower
    expert, as ``jax.lax.top_k``), split as the tokens are; the aux loss
    and the logits' gradient are the plain ones with the completed sums
    rank 0's own (the fake all-reduce's)."""
    T, E, k = 8, 4, 2
    rng = np.random.default_rng(3)
    half = rng.standard_normal((T, E // 2)).astype(np.float32)
    logits = np.concatenate([half, half], axis=1)
    cot = rng.standard_normal((T // 2, k)).astype(np.float32)
    rows = slice(4 * coord[0], 4 * coord[0] + 4)
    cols = slice(2 * coord[1], 2 * coord[1] + 2)
    plain = torch.tensor(logits[rows], requires_grad=True)
    top_p, top_ids, _ = moe._topk_routing(plain, k)
    aux = E * torch.sum(F.one_hot(top_ids, E).sum(dim=(0, 1)) / (T * k)
                        * (torch.softmax(plain, dim=-1).sum(dim=0) / T))
    ((top_p * torch.tensor(cot)).sum() + 0.5 * aux).backward()

    mesh = _mesh_at(coord)
    split = [Shard(0), Shard(1)]
    ld = DTensor.from_local(torch.tensor(logits[rows, cols]), mesh, split,
                            run_check=False).requires_grad_(True)
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    with counter, fallback:
        weights, ids, got_aux = moe._topk_routing(ld, k)
        forward = counter.collectives()
        ((weights.to_local() * torch.tensor(cot)).sum()
         + 0.5 * got_aux.to_local()).backward()
    assert not fallback.fallbacks
    assert forward.count_by_op == {"all-gather": 1, "all-reduce": 2}
    assert forward.bytes_by_op == {"all-gather": T // 2 * E * 4,
                                   "all-reduce": 2 * E * 4}
    assert counter.collectives().total_count == forward.total_count
    assert weights.placements == ids.placements == (Shard(0), Replicate())
    torch.testing.assert_close(weights.to_local(), top_p, **TOL)
    assert torch.equal(ids.to_local(), top_ids)
    torch.testing.assert_close(got_aux.to_local(), aux, **TOL)
    assert ld.grad.placements == tuple(split)
    torch.testing.assert_close(ld.grad.to_local(), plain.grad[:, cols],
                               **TOL)


# ---------------------------------------------------------------------------
# a sequence-split residual, and the microbatched step's gradients
# ---------------------------------------------------------------------------

def _small(seq=False, layers=2):
    """qwen3-moe cut to ``layers`` layers of width 64, 4 query heads on 2
    KV heads (whole on 2 "model" shards), 4 experts in 2 dispatch groups,
    batch 4 x 32."""
    return dict(
        shape_transform=lambda s: dataclasses.replace(s, global_batch=4,
                                                      seq_len=32),
        config_transform=lambda c: dataclasses.replace(
            c.reduced(num_layers=layers, d_model=64, num_heads=4,
                      num_kv_heads=2), shard_activations_seq=seq,
            moe=dataclasses.replace(c.moe, dispatch_groups=2)))


def _model_frame() -> str:
    """The function of the innermost frame in ``repro_torch/models``."""
    frame = sys._getframe(1)
    while frame is not None:
        if f"repro_torch{os.sep}models{os.sep}" in frame.f_code.co_filename:
            return frame.f_code.co_name
        frame = frame.f_back
    return ""


def test_a_sequence_split_block_gathers_each_sub_block_input_once(
        released, monkeypatch):
    """One train step of a reduced qwen3-moe with
    ``shard_activations_seq`` on a fake 2 x 2 mesh: no projection gathers
    its input (no all-gather issued from ``_project_qkv`` or
    ``apply_moe``, where the (B, L) fold of a residual split over the
    batch and the sequence gathered it once per projection); the
    sequence is gathered once a sub-block and once for the unembedding,
    forward and in remat's rerun; nothing falls back."""
    sites = []
    dispatch = DeviceCounter.__torch_dispatch__

    def recorded(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        if comm_analysis._COLLECTIVES.get(func._overloadpacket) \
                == "all-gather":
            sites.append(_model_frame())
        return out

    monkeypatch.setattr(DeviceCounter, "__torch_dispatch__", recorded)
    gathered = []
    whole = transformer.whole

    def counted(x, dim):
        if isinstance(x, DTensor) and any(p.is_shard(dim)
                                          for p in x.placements):
            gathered.append(dim)
        return whole(x, dim)

    monkeypatch.setattr(transformer, "whole", counted, raising=False)
    layers = 2
    rec = dryrun.run_one("qwen3-moe-30b-a3b", "train_4k", save=False,
                         mesh=mesh_lib.make_debug_mesh(2, 2),
                         **_small(seq=True, layers=layers))
    assert rec["fallback_ops"] == {}
    assert not {"_project_qkv", "apply_moe", "_moe_groups"} & set(sites)
    # two sub-blocks a layer, forward and rerun, and the unembedding's
    assert gathered == [1] * (2 * 2 * layers + 1)


@pytest.mark.parametrize("seq", [False, True])
def test_microbatched_gradients_reach_the_optimizer_as_one_steps(
        released, monkeypatch, seq):
    """The gradients of 2 microbatches, summed, have the placements of
    one step's (some of them ``Partial``: a partial sum stays partial
    through the accumulation), and are reduced once, onto their
    parameters' placements, before the norm and the optimizer see them
    (``training/train_step.py::_reduced``); neither step falls back."""
    summed, seen = [], []
    reduced, update = train_step._reduced, AdamW.update

    def before(grads, params):
        summed.append([g.placements for g in tree_leaves(grads)])
        return reduced(grads, params)

    def recorded(self, grads, state, params):
        seen.append(([g.placements for g in tree_leaves(grads)],
                     [p.placements for p in tree_leaves(params)]))
        return update(self, grads, state, params)

    monkeypatch.setattr(train_step, "_reduced", before, raising=False)
    monkeypatch.setattr(AdamW, "update", recorded)
    for mb in (1, 2):
        rec = dryrun.run_one("qwen3-moe-30b-a3b", "train_4k", save=False,
                             microbatches=mb,
                             mesh=mesh_lib.make_debug_mesh(2, 2),
                             **_small(seq=seq, layers=1))
        assert rec["fallback_ops"] == {}
    assert len(summed) == 2 and summed[0] == summed[1]
    assert any(p.is_partial() for pl in summed[0] for p in pl)
    for grads, params in seen:
        assert grads == params


# ---------------------------------------------------------------------------
# the reference's compiled step, the yardstick
# ---------------------------------------------------------------------------

SEQ, BATCH, GROUPS = 64, 8, 2
LOWERING = f"""
import dataclasses
import os
import re
import repro.launch.dryrun as dryrun       # sets 512 host devices
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.configs import get_arch, get_shape

cfg = get_arch("qwen3-moe-30b-a3b").reduced(num_layers=2, d_model=256,
                                            num_heads=8, num_kv_heads=2)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, dispatch_groups={GROUPS}))
shape = dataclasses.replace(get_shape("train_4k"), seq_len={SEQ},
                            global_batch={BATCH})
collective = re.compile(r"= (.*?) (all-reduce|all-gather|reduce-scatter|"
                        r"all-to-all|collective-permute)(?:-start)?\\(")
for case, mb, seq in (("step", 1, False), ("step", 2, False),
                      ("seqshard", 1, True)):
    if seq:    # the reference's own mesh (Explicit axes) refuses it
        mesh = jax.make_mesh((2, 4), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
    else:
        mesh = jax.make_mesh((2, 4), ("data", "model"))
    c = dataclasses.replace(cfg, shard_activations_seq=seq)
    with mesh:
        fn, args, _ = dryrun.build_lowerable(c, shape, mesh,
                                             microbatches=mb)
        text = fn.lower(*args).compile().as_text()
    for line in text.splitlines():
        m = collective.search(line)
        if m:
            print(case, mb, m.group(2), m.group(1).replace(" ", ""))
"""


@functools.lru_cache(maxsize=1)
def jax_collectives() -> str:
    """One line per collective XLA compiles for the reference's train
    step of qwen3-moe reduced to 2 layers of width 256 (8 query heads of
    32 on 2 KV heads, 4 experts choosing 2 in 2 dispatch groups), a batch
    of 8 x 64 on a 2 x 4 ("data", "model") mesh of 8 CPU devices: the
    case (``step``, or ``seqshard`` on a mesh of Auto axes), the
    microbatches, the op and its result type, a tuple's too (a process of
    its own: the device count is fixed when JAX starts)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", LOWERING], env=env,
                          check=True, capture_output=True, text=True,
                          timeout=900).stdout


def _collectives(case, mb):
    out = []
    for line in jax_collectives().splitlines():
        c, m, op, result = line.split()
        if (c, int(m)) == (case, mb):
            out.append((op, [sorted(int(d) for d in dims.split(",")
                                    if d and int(d) > 1)
                             for dims in re.findall(r"\w+\[([0-9,]*)\]",
                                                    result)]))
    assert out, (case, mb)
    return out


def _step_sizes(mb):
    """The rows a device may hold of a microbatch (split over "data", or
    whole where the reference's reshape into microbatches puts "data" on
    the microbatch axis), and the grouped dispatch's experts, capacity
    and pairs a group, as the reference computes them."""
    cfg = get_arch("qwen3-moe-30b-a3b").reduced(num_layers=2, d_model=256)
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    Tg = BATCH // mb * SEQ // GROUPS
    C = max(int(math.ceil(Tg * k / E * cfg.moe.capacity_factor)), k)
    return {BATCH // mb // 2, BATCH // mb}, E, C, Tg * k


@pytest.mark.parametrize("mb", [1, 2])
def test_xla_gathers_no_query(mb):
    """(a) No all-gather's result has a query's shape, (B_local, L, 8
    heads x 32) in any split of the heads (whole, or 2 KV heads x 4):
    XLA splits the heads over KV heads and groups at once, and gathers k
    and v only."""
    rows, _, _, _ = _step_sizes(mb)
    queries = [sorted(s) for b in rows for s in (
        [b, SEQ, 8, 32], [b, SEQ, 256], [b, SEQ, 2, 4, 32])]
    gathers = [s for op, shapes in _collectives("step", mb)
               if op == "all-gather" for s in shapes]
    assert gathers
    assert not [s for s in gathers if s in queries], gathers


@pytest.mark.parametrize("mb", [1, 2])
def test_xla_gathers_no_dispatch_buffer(mb):
    """(b) No all-gather's result is the (G, E * C, d) dispatch buffer
    or its gradient, whole or by expert (no dimension of C or E * C
    rows)."""
    _, E, C, _ = _step_sizes(mb)
    gathers = [s for op, shapes in _collectives("step", mb)
               if op == "all-gather" for s in shapes]
    assert not [s for s in gathers if {C, E * C} & set(s)], gathers


@pytest.mark.parametrize("mb", [1, 2])
def test_xla_completes_the_partial_sums_by_all_reduces(mb):
    """(c) The token-sized partial sums are completed by all-reduces:
    (B_local, L, d) ones (the projections' inputs' gradients, the
    attention output's projection) and the MoE's per pair (a group's
    T_g * k pairs of width d: XLA's combine and dispatch gradient reduce
    each pair's row, where the port adds a token's k pairs first and
    reduces the token's); and nothing is reduce-scattered, with the
    residual whole over "model" and split over the sequence alike."""
    rows, _, _, pairs = _step_sizes(mb)
    ops = _collectives("step", mb)
    reduced = [s for op, shapes in ops if op == "all-reduce" for s in shapes]
    assert any(sorted([b, SEQ, 256]) in reduced for b in rows), reduced
    assert any(pairs in s and 256 in s for s in reduced), reduced
    for case, m in (("step", mb), ("seqshard", 1)):
        assert "reduce-scatter" not in {op for op, _ in _collectives(case,
                                                                     m)}


if __name__ == "__main__":
    print(jax_collectives(), end="")
