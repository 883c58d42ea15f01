"""The dense per-slot KV cache's writes (``repro_torch.models.attention``)
against the JAX reference's, every column of every leaf.

The cache holds the reference's S columns, and the writes JAX drops as out
of range (``.at[...].set(mode="drop")``: inactive chunk tokens, positions
past S under full attention, a finished slot idling at ``lengths == S``
in a decode burst) leave their columns as they were.  Both sides start
from the same random cache (a zero cache would hide a stray write of
zeros) and get the same q/k/v rows: ``_project_qkv`` is replaced on both
sides by one that returns fixed numpy rows, so the rows written are
bitwise the same and the caches must agree exactly.

Tolerance: 0 on every leaf, every column (float rows, int8 rows and their
scales: the quantizer is bit for bit the reference's); 1e-4 on the
attention outputs (f32, the two frameworks' matmuls round apart).

On a fake 2 x 2 mesh (``launch/mesh.py``; ``"data"`` shards the batch,
``"model"`` the cache's ``kv_seq``) the writes run shard-local: no
``ReplicateFallback`` fallback, no collective, and rank 0's shard equals
the same slice of the plain write.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import ARCHITECTURES
from repro.models import attention as jax_attention
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.comm_analysis import DeviceCounter, ReplicateFallback
from repro_torch.models import attention as port_attention

OUT_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, C = 3, 16, 8
KW = dict(num_layers=1, d_model=32, num_heads=4, num_kv_heads=2)


def _cfgs(window, quant):
    over = dict(sliding_window=window, kv_quant=quant)
    jcfg = dataclasses.replace(ARCHITECTURES["granite-3-2b"].reduced(**KW),
                               **over)
    tcfg = dataclasses.replace(get_arch("granite-3-2b").reduced(**KW),
                               **over)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _params(cfg, rng):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wo": (0.1 * rng.standard_normal(
        (cfg.num_heads * hd, d))).astype(np.float32)}


def _cache(cfg, rng, batch=B):
    """A random cache of the reference's shape."""
    shape = (batch, cfg.num_kv_heads, S, cfg.resolved_head_dim)
    if cfg.kv_quant:
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": (rng.random(shape[:-1]) / 64).astype(np.float32),
                "v_scale": (rng.random(shape[:-1]) / 64).astype(np.float32)}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _fixed_qkv(monkeypatch, cfg, n, rng):
    """Both sides' ``_project_qkv`` return the same rows for n tokens."""
    hd = cfg.resolved_head_dim
    q = rng.standard_normal((B, n, cfg.num_heads, hd)).astype(np.float32)
    k = rng.standard_normal((B, n, cfg.num_kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal((B, n, cfg.num_kv_heads, hd)).astype(np.float32)
    monkeypatch.setattr(jax_attention, "_project_qkv", lambda *_: (
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    monkeypatch.setattr(port_attention, "_project_qkv", lambda *_: (
        torch.tensor(q), torch.tensor(k), torch.tensor(v)))


def _check(tcache, jcache, tout, jout):
    assert set(tcache) == set(jcache)
    for name, leaf in tcache.items():
        assert tuple(leaf.shape) == jcache[name].shape, name
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jcache[name]),
                                      err_msg=name)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **OUT_TOL)


def _run(monkeypatch, window, quant, n, seed, call_jax, call_port):
    jcfg, tcfg = _cfgs(window, quant)
    rng = np.random.default_rng(seed)
    params, cache = _params(tcfg, rng), _cache(tcfg, rng)
    _fixed_qkv(monkeypatch, tcfg, n, rng)
    x = np.zeros((B, n, tcfg.d_model), np.float32)
    jout, jcache = call_jax(jcfg, {k: jnp.asarray(v) for k, v in
                                   params.items()}, jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: torch.tensor(v) for k, v in cache.items()}
    tout = call_port(tcfg, {k: torch.tensor(v) for k, v in params.items()},
                     torch.tensor(x), tcache)
    _check(tcache, jcache, tout, jout)
    return tcache, cache


LAYOUTS = [(None, False), (None, True), (S, False), (S, True)]
IDS = ["full", "full-int8", "rolling", "rolling-int8"]


@pytest.mark.parametrize("window,quant", LAYOUTS, ids=IDS)
def test_chunk_with_inactive_tokens_writes_as_jax(monkeypatch, window,
                                                  quant):
    """Row 0 runs past S (dropped under full attention, wrapped when
    rolling), row 1 has 5 inactive tokens, row 2 is inactive."""
    starts = np.array([12, 2, 5], np.int32)
    valid = np.array([C, 3, 0], np.int32)
    positions = starts[:, None] + np.arange(C, dtype=np.int32)[None]

    def jax_call(cfg, p, x, cache):
        return jax_attention.attend_prefill_chunk(
            p, cfg, x, jnp.asarray(positions), jnp.asarray(valid), cache)

    def port_call(cfg, p, x, cache):
        return port_attention.attend_prefill_chunk(
            p, cfg, x, torch.tensor(positions), torch.tensor(valid), cache)

    tcache, before = _run(monkeypatch, window, quant, C, 1, jax_call,
                          port_call)
    # row 2 wrote nothing; row 1 only its 3 columns
    for name, leaf in tcache.items():
        np.testing.assert_array_equal(leaf[2].numpy(), before[name][2])
        kept = np.zeros(S, bool)
        kept[2:5] = True
        np.testing.assert_array_equal(leaf[1][:, ~kept].numpy(),
                                      before[name][1][:, ~kept])


@pytest.mark.parametrize("window,quant", LAYOUTS, ids=IDS)
def test_decode_burst_with_a_finished_slot_writes_as_jax(monkeypatch,
                                                         window, quant):
    """Slot 0 idles at ``lengths == S`` (a finished slot in a burst: its
    write drops under full attention, wraps when rolling), slot 1 writes
    past a rolling window's end, slot 2 at column 0."""
    for step, lengths in enumerate(([S, 9, 0], [S, S + 3, 1])):
        lengths = np.array(lengths, np.int32)

        def jax_call(cfg, p, x, cache):
            return jax_attention.attend_decode(p, cfg, x,
                                               jnp.asarray(lengths), cache)

        def port_call(cfg, p, x, cache):
            return port_attention.attend_decode(p, cfg, x,
                                                torch.tensor(lengths), cache)

        if window is None and lengths[1] > S:
            lengths[1] = S - 1
        tcache, before = _run(monkeypatch, window, quant, 1, 10 + step,
                              jax_call, port_call)
        if window is None:             # the finished slot wrote nothing
            for name, leaf in tcache.items():
                np.testing.assert_array_equal(leaf[0].numpy(),
                                              before[name][0])


PREFILLS = [(w, q, L) for (w, q) in LAYOUTS for L in (5, S, 2 * S + 3)
            if w is not None or L <= S]


@pytest.mark.parametrize("window,quant,L", PREFILLS)
def test_single_shot_prefill_replaces_every_column_as_jax(monkeypatch,
                                                          window, quant, L):
    """The prompt's rows at their columns and zeros past them (full
    attention), or the last S positions at their rolling columns."""
    pos = np.arange(L, dtype=np.int32)[None]

    def jax_call(cfg, p, x, cache):
        return jax_attention.attend_prefill(p, cfg, x, jnp.asarray(pos),
                                            cache)

    def port_call(cfg, p, x, cache):
        return port_attention.attend_prefill(p, cfg, x, torch.tensor(pos),
                                             cache)

    _run(monkeypatch, window, quant, L, 20 + L, jax_call, port_call)


def test_a_prompt_longer_than_a_full_attention_cache_is_refused():
    _, cfg = _cfgs(None, False)
    cache = port_attention.kv_buffers(cfg, (1, 2, 4, cfg.resolved_head_dim),
                                      torch.float32, "cpu")
    x = torch.zeros(1, 5, cfg.d_model)
    with pytest.raises(ValueError, match="does not fit"):
        port_attention.attend_prefill(
            port_attention.init_attention(torch.Generator(), cfg,
                                          torch.float32, "cpu"), cfg, x,
            torch.arange(5)[None], cache)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_a_chunk_longer_than_the_cache_is_refused(quant):
    _, cfg = _cfgs(None, quant)
    hd = cfg.resolved_head_dim
    cache = port_attention.kv_buffers(cfg, (1, 2, 4, hd), torch.float32,
                                      "cpu")
    with pytest.raises(ValueError, match="C <= S"):
        port_attention._write_dense(cfg, cache, torch.ones(1, 5, 2, hd),
                                    torch.ones(1, 5, 2, hd),
                                    torch.arange(5)[None], None)


# ---------------------------------------------------------------------------
# on a fake 2 x 2 mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2x2():
    mesh_lib.release()
    yield mesh_lib.make_debug_mesh(2, 2)
    mesh_lib.release()


def _rank0_cache(mesh, cache):
    """DTensors of ``cache`` sharded (batch on "data", kv_seq on "model"),
    holding rank 0's shard of the values (the fake group has no other)."""
    out = {}
    for name, leaf in cache.items():
        local = leaf[:leaf.shape[0] // 2, :, :S // 2].clone()
        out[name] = DTensor.from_local(local, mesh, [Shard(0), Shard(2)],
                                       run_check=False)
    return out


def _replicated(mesh, t):
    return DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                              run_check=False)


@pytest.mark.parametrize("window,quant", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("kind", ["chunk", "decode"])
def test_the_write_is_shard_local_on_a_mesh(mesh2x2, window, quant, kind):
    """Rank 0 owns rows [0, 2) and columns [0, 8): after the write its
    shard equals that slice of the same write on plain tensors, and no op
    fell back or gathered."""
    _, cfg = _cfgs(window, quant)
    rng = np.random.default_rng(3)
    cache = {k: torch.tensor(v) for k, v in _cache(cfg, rng, 4).items()}
    n = C if kind == "chunk" else 1
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    k = torch.tensor(rng.standard_normal((4, n, kvh, hd)),
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((4, n, kvh, hd)),
                     dtype=torch.float32)
    if kind == "chunk":      # row 0 straddles both shards, row 1 drops
        starts = torch.tensor([4, 6, 9, 0], dtype=torch.int32)
        valid = torch.tensor([C, 0, 5, 2], dtype=torch.int32)
        positions = starts[:, None] + torch.arange(C, dtype=torch.int32)
        keep = torch.arange(C)[None] < valid[:, None]
        if window is None:
            keep = keep & (positions < S)
    else:
        positions = torch.tensor([[S], [3], [12], [S + 2]],
                                 dtype=torch.int32)
        if window is None:
            positions[3] = 7
        keep = None if window is not None else positions < S
    sharded = _rank0_cache(mesh2x2, cache)
    plain = {name: leaf.clone() for name, leaf in cache.items()}
    port_attention._write_dense(cfg, plain, k, v, positions, keep)
    counter, fallback = DeviceCounter(), ReplicateFallback()
    with counter, fallback:
        port_attention._write_dense(
            cfg, sharded, _replicated(mesh2x2, k),
            _replicated(mesh2x2, v), _replicated(mesh2x2, positions),
            None if keep is None else _replicated(mesh2x2, keep))
    assert not fallback.fallbacks
    assert counter.collectives().total_count == 0
    for name, leaf in sharded.items():
        torch.testing.assert_close(leaf.to_local(),
                                   plain[name][:2, :, :S // 2],
                                   atol=0, rtol=0)
