"""The model code's shard-local ops on a fake 2 x 2 mesh
(``launch/mesh.py``; "data" splits the batch, "model" the vocab, the
heads and the experts), with real CPU values: this process is rank 0,
placed at a mesh coordinate of its choice, and holds that rank's shard.
The fake group's all-gather gives every rank rank 0's shard, so a value
gathered along an axis is made periodic along it where a test reads it
back whole.

  * the vocab-parallel embedding lookup (``distributed/local.py::
    vocab_lookup`` behind ``models/layers.py::embed_tokens``): rank 0's
    partial equals the plain lookup (and JAX's ``table[tokens]``) with
    the rows outside its vocab range zeroed, exactly; no op falls back,
    the forward issues no collective and its reduction one all-reduce of
    the (B_local, L, d) output.  Its gradient: rank 0's local rows equal
    the plain gradient's rows from rank 0's tokens, exactly, and stay a
    partial sum over "data"; no ``index_put`` (no op at all) falls back;
  * the k/v head split (``models/attention.py::_split_heads``): where
    the "model" shards cut a head, only "model" is gathered (no
    fallback, the batch stays split); where the heads divide, nothing is
    communicated; the values equal the plain reshape;
  * the MoE router's gradient (``models/moe.py::_moe_groups``): the
    combine reads the weights of rank 0's experts' pairs alone, so their
    gradient comes back ``Partial()`` over "model" (not ``Replicate()``,
    which would train the router on one rank's share) and equals the
    plain gradient with the other experts' pairs zeroed;
  * a microbatch (``training/train_step.py::_rows``): DTensor gathers a
    slice of the batch whole, and the train step splits it back over
    "data", so that each microbatch runs data-parallel.

The reference's own lowering of the lookup is the yardstick:
``python tests/test_torch_mesh_grads.py`` prints the collectives XLA
compiles for ``table[tokens]`` and its gradient on 8 CPU devices (a 2 x
4 mesh, the table split over "model", the tokens over "data"), and
``test_the_references_lookup_gathers_no_table`` holds it to no gather.

Tolerances: 0 on the lookup and its gradient (a row copy and a sum of
the same rows in the same order); 1e-6 on the router's gradient (f32,
the plain and the local combine round alike but for the zeroed pairs).
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_arch
from repro_torch.distributed.local import vocab_lookup
from repro_torch.launch import ablate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.comm_analysis import DeviceCounter, ReplicateFallback
from repro_torch.models import attention, layers, moe
from repro_torch.training import train_step

V, D, B, L = 32, 8, 4, 5
COORDS = [(0, 0), (0, 1), (1, 0), (1, 1)]
# (table placements, whether the tokens' batch halves must be equal,
# whether the table's width halves must be): the default rules (vocab on
# "model"), hillclimb's wide2d (vocab on "data" and "model": the tokens
# are gathered over "data"), a table whose vocab no axis splits, and
# FSDP (the width on "data": the table is gathered over "data")
LAYOUTS = {
    "vocab-model": ([Replicate(), Shard(0)], False, False),
    "vocab-data-model": ([Shard(0), Shard(0)], True, False),
    "replicated": ([Replicate(), Replicate()], False, False),
    "fsdp": ([Shard(1), Shard(0)], False, True),
}


def _mesh_at(coord):
    """A fake 2 x 2 ("data", "model") mesh with this process (rank 0) at
    ``coord``: a layout of its own, so that no sharding cached for
    another layout (and its coordinate) is reused."""
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


def _shard(t, placements, coord):
    """Rank ``coord``'s shard of ``t``: each Shard(d) splits d in two,
    the outer mesh axis first, as ``distribute_tensor`` does."""
    index = {}
    for axis, p in enumerate(placements):
        if p.is_shard():
            i, n = index.get(p.dim, (0, 1))
            index[p.dim] = (i * 2 + coord[axis], n * 2)
    for dim, (i, n) in index.items():
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t.clone()


def _vocab_range(placements, coord):
    """(first, n): rank ``coord``'s rows of the table."""
    i, n = 0, 1
    for axis, p in enumerate(placements):
        if p.is_shard(0):
            i, n = i * 2 + coord[axis], n * 2
    return i * (V // n), V // n


def _lookup_inputs(layout, seed=0):
    placements, equal_batch, equal_width = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    if equal_width:
        table[:, D // 2:] = table[:, :D // 2]
    tokens = rng.integers(0, V, (B, L))
    if equal_batch:
        tokens[B // 2:] = tokens[:B // 2]
    return placements, table, tokens


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_lookup_is_shard_local_on_a_mesh(released, layout, coord):
    """Rank 0's partial (``vocab_lookup``) is the plain lookup (JAX's
    ``table[tokens]``) of its tokens with the rows outside its vocab
    range zeroed, exactly; no fallback, no gather of the table but where
    its width is split over the tokens' axis (FSDP); and
    ``embed_tokens`` adds to it one all-reduce of the (B_local, L, d)
    output over each axis that splits the vocab, as XLA's lowering of
    the reference does, which leaves it whole there."""
    placements, table, tokens = _lookup_inputs(layout)
    mesh = _mesh_at(coord)
    tab = DTensor.from_local(_shard(torch.tensor(table), placements, coord),
                             mesh, placements, run_check=False)
    tok = DTensor.from_local(_shard(torch.tensor(tokens), [Shard(0),
                                                           Replicate()],
                                    coord), mesh, [Shard(0), Replicate()],
                             run_check=False)
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    with counter, fallback:
        out = vocab_lookup(tab, tok)
        forward = counter.collectives()
        whole_rows = layers.embed_tokens({"embed": tab}, tok)
        reduced = counter.collectives()
    assert not fallback.fallbacks
    # FSDP gathers the table over "data" (its width), wide2d the tokens
    # (int64) over "data"; the default layout nothing
    gathered = {"fsdp": 2 * tab.to_local().numel() * 4,
                "vocab-data-model": B * L * 8}.get(layout, 0)
    assert forward.bytes_by_op == ({"all-gather": gathered} if gathered
                                   else {})
    first, n = _vocab_range(placements, coord)
    rows = tokens if layout == "vocab-data-model" else _shard(
        torch.tensor(tokens), [Shard(0), Replicate()], coord).numpy()
    want = np.asarray(jnp.asarray(table)[rows])
    want = np.where(((rows >= first) & (rows < first + n))[..., None],
                    want, 0.0)
    np.testing.assert_array_equal(out.to_local().numpy(), want)
    partial = [p.is_shard(0) for p in placements]
    assert [p.is_partial() for p in out.placements] == partial
    out_bytes = out.to_local().numel() * 4
    extra = {k: reduced.bytes_by_op[k] - 2 * forward.bytes_by_op.get(k, 0)
             for k in reduced.bytes_by_op}
    extra = {k: v for k, v in extra.items() if v}
    assert extra == ({"all-reduce": out_bytes * sum(partial)}
                     if any(partial) else {})
    assert not any(p.is_partial() for p in whole_rows.placements)
    assert whole_rows.to_local().shape == out.to_local().shape


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("layout", ["vocab-model", "vocab-data-model",
                                    "replicated"])
def test_the_lookup_gradient_is_shard_local_on_a_mesh(released, layout,
                                                      coord):
    """Rank 0's local table gradient is the plain gradient's rows
    ``[first, first + n)`` from rank 0's tokens, exactly, a partial sum
    over the axes that split the tokens and not the table ("data"); it is
    a local ``index_put``: no op falls back and the lookup's backward
    communicates nothing."""
    placements, table, tokens = _lookup_inputs(layout, seed=1)
    mesh = _mesh_at(coord)
    batch = [Shard(0), Replicate()]
    tab = DTensor.from_local(_shard(torch.tensor(table), placements, coord),
                             mesh, placements,
                             run_check=False).requires_grad_(True)
    tok = DTensor.from_local(_shard(torch.tensor(tokens), batch, coord),
                             mesh, batch, run_check=False)
    rng = np.random.default_rng(2)
    cot = rng.standard_normal((B, L, D)).astype(np.float32)
    gathered = layout == "vocab-data-model"    # its tokens, over "data"
    local_cot = torch.tensor(cot) if gathered else _shard(
        torch.tensor(cot), batch, coord)
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    with counter, fallback:
        out = layers.embed_tokens({"embed": tab}, tok)
        forward = counter.collectives().total_count
        (out.to_local() * local_cot).sum().backward()
    assert not fallback.fallbacks
    assert counter.collectives().total_count == forward
    want = [p if p.is_shard() else Replicate() if gathered else Partial()
            if axis == 0 else Replicate() for axis, p in enumerate(placements)]
    assert list(tab.grad.placements) == want
    rows = np.arange(B) if gathered else np.arange(B)[
        coord[0] * B // 2:(coord[0] + 1) * B // 2]
    plain = torch.tensor(table, requires_grad=True)
    (plain[torch.tensor(tokens[rows])] * torch.tensor(cot[rows])
     ).sum().backward()
    first, n = _vocab_range(placements, coord)
    torch.testing.assert_close(tab.grad.to_local(),
                               plain.grad[first:first + n], atol=0, rtol=0)


@pytest.mark.parametrize("heads", [1, 2, 3, 4])
def test_the_kv_split_gathers_only_the_heads_axis(released, heads):
    """(B, L, heads x hd) split over "data" (batch) and "model" (width):
    where 2 "model" shards cut a head (1 or 3 heads) only "model" is
    gathered, the local width, once; where they do not, nothing is; no
    fallback either way, the batch stays split, and the values are the
    plain reshape's."""
    hd = 4
    rng = np.random.default_rng(heads)
    x = rng.standard_normal((B, L, heads * hd // 2)).astype(np.float32)
    x = np.concatenate([x, x], axis=-1)       # periodic over "model"
    mesh = _mesh_at((0, 0))
    xd = DTensor.from_local(torch.tensor(x[:B // 2, :, :heads * hd // 2]),
                            mesh, [Shard(0), Shard(2)], run_check=False)
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    with counter, fallback:
        y = attention._split_heads(xd, heads, hd)
    assert not fallback.fallbacks
    local = xd.to_local().numel() * 4
    cut = heads % 2 != 0
    assert counter.collectives().bytes_by_op == (
        {"all-gather": 2 * local} if cut else {})
    assert y.placements == ((Shard(0), Replicate()) if cut
                            else (Shard(0), Shard(2)))
    torch.testing.assert_close(
        y.full_tensor()[:B // 2],
        torch.tensor(x[:B // 2]).reshape(B // 2, L, heads, hd),
        atol=0, rtol=0)
    # plain tensors: the plain reshape
    plain = torch.tensor(x)
    assert attention._split_heads(plain, heads, hd).data_ptr() \
        == plain.data_ptr()


@pytest.mark.parametrize("kvh,H", [(1, 4), (3, 6), (2, 4)])
def test_the_query_group_split_gathers_only_the_heads_axis(released, kvh,
                                                           H):
    """``_sdpa``'s (B, H, L, D) queries split over "data" (batch) and
    "model" (heads) into KV groups: whether 2 "model" shards cut a group
    (1 or 3 KV heads) or not (2), nothing is gathered: each shard attends
    its own query heads against their KV heads' k and v, and the output
    keeps q's split; no fallback either way, the batch stays split, and
    rank 0's rows and heads equal the plain attention's (tolerance 1e-6,
    f32).
    Backward, against a gradient split over the heads as the output
    projection's is: no fallback, and rank 0's query gradient is the
    plain one's rows."""
    Lq, hd = 3, 4
    rng = np.random.default_rng(kvh)
    q = rng.standard_normal((B, H // 2, Lq, hd)).astype(np.float32)
    q = np.concatenate([q, q], axis=1)        # periodic over "model"
    k, v = (rng.standard_normal((B, kvh, Lq, hd)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((B, H // 2, Lq, hd)).astype(np.float32)
    w = np.concatenate([w, w], axis=1)
    mask = torch.tensor(np.tril(np.ones((Lq, Lq), bool)))[None, None]
    plain_q = torch.tensor(q, requires_grad=True)
    want = attention._sdpa(plain_q, torch.tensor(k), torch.tensor(v), mask)
    (want * torch.tensor(w)).sum().backward()
    mesh = _mesh_at((0, 0))
    batch = [Shard(0), Replicate()]
    heads = [Shard(0), Shard(1)]
    qd = DTensor.from_local(torch.tensor(q[:B // 2, :H // 2]), mesh, heads,
                            run_check=False).requires_grad_(True)
    wd = DTensor.from_local(torch.tensor(w[:B // 2, :H // 2]), mesh, heads,
                            run_check=False)
    kd, vd = (DTensor.from_local(torch.tensor(t[:B // 2]), mesh, batch,
                                 run_check=False) for t in (k, v))
    counter = DeviceCounter()
    fallback = ReplicateFallback(counter)
    with counter, fallback, implicit_replication():   # the plain mask
        out = attention._sdpa(qd, kd, vd, mask)
    assert not fallback.fallbacks
    # rank 0's batch rows and heads, no collective
    assert counter.collectives().bytes_by_op == {}
    assert out.placements == tuple(heads)
    torch.testing.assert_close(out.to_local(), want[:B // 2, :H // 2],
                               atol=1e-6, rtol=1e-6)
    with fallback, implicit_replication():
        (out * wd).sum().backward()
    assert not fallback.fallbacks
    grad = qd.grad.redistribute(mesh, heads)   # a local chunk, if whole
    torch.testing.assert_close(grad.to_local(),
                               plain_q.grad[:B // 2, :H // 2], atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("coord", COORDS)
def test_the_router_gradient_is_partial_over_the_experts(released, coord):
    """Rank 0 at ``coord`` = (data, model) holds groups [2 data, 2 data +
    2) and experts [2 model, 2 model + 2) of 4.  The gradient of the
    combine's weights comes back ``Partial()`` over "model" (each rank's
    covers its own experts' pairs) and equals the plain gradient of the
    same groups with the other experts' down projection zeroed (their
    pairs then carry exact zeros).  No op falls back."""
    cfg = get_arch("qwen3-moe-30b-a3b").reduced(num_layers=1, d_model=64)
    E, k, G, Tg, C = cfg.moe.num_experts, cfg.moe.experts_per_token, 4, 8, 3
    rng = np.random.default_rng(7)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                     torch.device("cpu"))
    xg = torch.tensor(rng.standard_normal((G, Tg, cfg.d_model)),
                      dtype=torch.float32)
    wg, eg, _ = moe._topk_routing(torch.tensor(
        rng.standard_normal((G * Tg, E)), dtype=torch.float32), k)
    wg, eg = wg.reshape(G, Tg, k), eg.reshape(G, Tg, k)
    cot = torch.tensor(rng.standard_normal((G, Tg, cfg.d_model)),
                       dtype=torch.float32)
    g0, e0 = 2 * coord[0], 2 * coord[1]
    plain_p = dict(p, down=p["down"].clone())
    plain_p["down"][[e for e in range(E) if not e0 <= e < e0 + 2]] = 0
    plain_w = wg.clone().requires_grad_(True)
    (moe._moe_groups(plain_p, xg, plain_w, eg, C, E)[g0:g0 + 2]
     * cot[g0:g0 + 2]).sum().backward()
    want = plain_w.grad[g0:g0 + 2]
    assert want.abs().sum() > 0 and (want == 0).any()
    mesh = _mesh_at(coord)
    groups = [Shard(0), Replicate()]
    xd, ed = (DTensor.from_local(t[g0:g0 + 2], mesh, groups,
                                 run_check=False) for t in (xg, eg))
    wd = DTensor.from_local(wg[g0:g0 + 2].clone(), mesh, groups,
                            run_check=False).requires_grad_(True)
    pd = {name: DTensor.from_local(
              w if name == "router" else w[e0:e0 + 2], mesh,
              [Replicate(), Replicate() if name == "router" else Shard(0)],
              run_check=False)
          for name, w in p.items()}
    fallback = ReplicateFallback()
    with fallback:
        out = moe._moe_groups(pd, xd, wd, ed, C, E)
        (out.to_local() * cot[g0:g0 + 2]).sum().backward()
    assert not fallback.fallbacks
    assert wd.grad.placements == (Shard(0), Partial())
    torch.testing.assert_close(wd.grad.to_local(), want, atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("coord", COORDS)
def test_a_microbatch_is_split_over_the_batch_axes(released, coord):
    """DTensor gathers a slice of the batch whole; the train step's
    microbatch (``training/train_step.py::_rows``) is split back over
    "data" (a local chunk, no collective of its own), rank 0 at
    ``coord`` holding rows [2 data, 2 data + 2) of microbatch 1 of 2.
    The batch's halves are equal, so the fake gather gives the real
    values."""
    rng = np.random.default_rng(5)
    half = rng.integers(0, V, (4, L))
    batch = np.concatenate([half, half])          # periodic over "data"
    mesh = _mesh_at(coord)
    rows = [Shard(0), Replicate()]
    bd = DTensor.from_local(_shard(torch.tensor(batch), rows, coord), mesh,
                            rows, run_check=False)
    counter = DeviceCounter()
    with counter:
        mb = train_step._rows(bd, 4, 8)
    assert mb.placements == tuple(rows)
    # the slice's gather of the batch, and nothing more
    assert counter.collectives().bytes_by_op == {"all-gather": batch.nbytes}
    d = coord[0]
    np.testing.assert_array_equal(mb.to_local().numpy(),
                                  batch[4:8][2 * d:2 * d + 2])
    plain = torch.tensor(batch)
    assert train_step._rows(plain, 4, 8).data_ptr() == plain[4:8].data_ptr()


@pytest.mark.parametrize("part", ["kv-split", "query-split"])
def test_each_head_split_repairs_its_fallbacks(released, part):
    """One train step of granite-3-2b cut to 1 layer of 6 query heads on 3
    KV heads (hd 16), batch 4 x 32, on a fake 2 x 2 mesh: the tree's
    record has no fallback, and with the head split's plain view put back
    (``launch/ablate.py``) views fall back there."""
    small = lambda s: dataclasses.replace(s, global_batch=4, seq_len=32)
    cut = lambda c: c.reduced(num_layers=1, d_model=96, num_heads=6,
                              num_kv_heads=3)
    recs = {}
    for which in ("none", part):
        mesh = mesh_lib.make_debug_mesh(2, 2)
        recs[which] = ablate.run("granite-3-2b", "train_4k", "", which,
                                 mesh=mesh, shape_transform=small,
                                 config_transform=cut)
    assert recs["none"]["fallback_ops"] == {}
    sites = recs[part]["fallback_sites"]["aten.view.default"]
    plain = {"kv-split": "(_plain_split)", "query-split": "(_plain_sdpa)"}
    assert any(site.endswith(plain[part]) for site in sites)


# ---------------------------------------------------------------------------
# the reference's lowering of the lookup, the yardstick
# ---------------------------------------------------------------------------

LOWERING = """
import re
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
tab = jax.device_put(jnp.zeros((4096, 256), jnp.bfloat16),
                     NamedSharding(mesh, P("model", None)))
tok = jax.device_put(jnp.zeros((8, 16), jnp.int32),
                     NamedSharding(mesh, P("data", None)))
pattern = re.compile(r"= (\\S+) (all-reduce|all-gather|reduce-scatter|"
                     r"all-to-all|collective-permute)\\(")
for name, fn in (("forward", lambda t, x: t[x]),
                 ("gradient", jax.grad(lambda t, x: jnp.sum(
                     t[x].astype(jnp.float32))))):
    text = jax.jit(fn).lower(tab, tok).compile().as_text()
    print(name, [m.group(2) + " " + m.group(1)
                 for m in pattern.finditer(text)])
"""


def jax_lookup_lowering() -> str:
    """The collectives XLA compiles for the reference's ``t[x]`` and its
    gradient, a (4096, 256) bf16 table split ``P("model", None)`` and (8,
    16) tokens ``P("data", None)`` on a 2 x 4 mesh of 8 CPU devices (a
    process of its own: the device count is fixed when JAX starts)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.run([sys.executable, "-c", LOWERING], env=env,
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout


def test_the_references_lookup_gathers_no_table():
    """XLA's lookup is a masked local lookup and one all-reduce of the
    (B_local, L, d) output; its gradient gathers nothing either."""
    lines = dict(line.split(" ", 1)
                 for line in jax_lookup_lowering().splitlines())
    assert not re.search("all-gather", lines["forward"] + lines["gradient"])
    assert "all-reduce f32[4,16,256]" in lines["forward"]


if __name__ == "__main__":
    print(jax_lookup_lowering(), end="")
