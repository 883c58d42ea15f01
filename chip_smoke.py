"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

  1. require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, started together);
  3. kernel phase: each kernel against its plain PyTorch version on the
     card, in float32 and bfloat16, at granite-3-2b's widths (32 query
     heads, 8 KV heads, head_dim 64, 16-token pages): sentinel table
     entries, lengths 0/1/page edges/several pages, prefill chunks that
     start past a page edge, ``valid == 0`` rows, chunks of 128 and 512,
     and the serve phase's own shapes (8 slots, its page pool and table,
     16- and 32-token chunk buckets with free slots among live rows).
     Then time kernel, plain version and ``scaled_dot_product_attention``
     over the gathered KV at the serving path's shapes (device time, from
     CUDA-graph replays), beside the bound;
  4. serve phase (the main path): full-width granite-3-2b (40 layers,
     d_model 2048, bfloat16, random weights from a seeded
     ``torch.Generator``) through ``calibrate_registry`` / ``build_cluster``
     / ``run_round_robin`` of ``repro_torch.launch.serve`` for 8 requests;
     every request must end terminal, no KV block may leak and both
     kernels must have launched;
  5. long-prompt phase: one full-width engine with 64-token chunks serves
     a 300-token prompt and a second one sharing its first 256 tokens (a
     prefix hit: prefill chunks start past the shared pages), plus a
     copy-on-write page copy of a forked tail block;
  6. reference phase: reduced granite (GQA) in float32 on the card and on
     the CPU (the kernels' plain versions) with the same weights must give
     the same greedy tokens through chunked prefill, prefix sharing,
     evict/resume and decode bursts.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
GRANITE = "granite-3-2b"
# the main path's serving arguments (repro_torch.launch.serve's flags)
SERVE_ARGS = argparse.Namespace(
    slots=8, decode_burst=1, backend=None, prefix_sharing=True,
    debug_invariants=False, device="cuda", instances=1,
    routing="solver", requests=8, rate=4.0, max_new_tokens=16, seed=0,
    max_wall=300.0)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _pool(gen, N, KVH, bs, D, dtype):
    return [torch.randn((N, KVH, bs, D), generator=gen, device="cuda")
            .to(dtype) for _ in range(2)]


def _table(rng, B, nb, N, live):
    """Distinct random pages for each row's live blocks, sentinels after."""
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    for b, n in enumerate(live):
        bt[b, n:] = N + 5
    return torch.tensor(bt, device="cuda")


def decode_case(rng, gen, dtype, lengths, *, H=32, KVH=8, D=64, bs=16, nb=8,
                N=None):
    B = len(lengths)
    N = N or max(B * nb, 8)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    kp, vp = _pool(gen, N, KVH, bs, D, dtype)
    bt = _table(rng, B, nb, N, [-(-int(n) // bs) for n in lengths])
    ln = torch.tensor(np.asarray(lengths, np.int32), device="cuda")
    return q, kp, vp, bt, ln


def prefill_case(rng, gen, dtype, starts, valid, C, *, H=32, KVH=8, D=64,
                 bs=16, nb=None, N=None):
    B = len(starts)
    nb = nb or -(-(max(starts) + C) // bs)
    N = N or B * nb
    q = torch.randn((B, H, C, D), generator=gen, device="cuda").to(dtype)
    ck, cv = [torch.randn((B, KVH, C, D), generator=gen, device="cuda")
              .to(dtype) for _ in range(2)]
    kp, vp = _pool(gen, N, KVH, bs, D, dtype)
    bt = _table(rng, B, nb, N, [-(-int(s) // bs) for s in starts])
    st = torch.tensor(np.asarray(starts, np.int32), device="cuda")
    vd = torch.tensor(np.asarray(valid, np.int32), device="cuda")
    return q, kp, vp, ck, cv, bt, st, vd


def compare(out, want, dtype, rows=None):
    """Max abs error and whether every element is within TOL[dtype];
    ``rows`` restricts a prefill output to each sequence's valid rows."""
    if rows is not None:
        out = torch.cat([out[b, :, :n].flatten() for b, n in enumerate(rows)])
        want = torch.cat([want[b, :, :n].flatten()
                          for b, n in enumerate(rows)])
    out, want = out.float(), want.float()
    err = (out - want).abs()
    ok = bool((err <= TOL[dtype]["atol"] + TOL[dtype]["rtol"]
               * want.abs()).all())
    return (float(err.max()) if err.numel() else 0.0), ok


def time_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    dispatch of each call is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, iters: int = 50) -> float:
    """Time per call issued one by one from Python, the host's dispatch
    included (what the engine pays per call)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(main_shapes: dict) -> dict:
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels.paged_decode_attention import gather_pages

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, nb, N, bs = (main_shapes[k] for k in ("B", "nb", "N", "bs"))
    serving = dict(nb=nb, N=N)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        decode_cases = {
            "edges+sentinels": dict(lengths=[1, 16, 17, 0, 100, 128, 33, 2]),
            "long (nb=32)": dict(lengths=[500, 257, 1, 320], nb=32),
            f"serving B={B} nb={nb} N={N}": dict(
                lengths=[5, 40, 1, 0, 17, 33, 0, 16][:B], **serving),
        }
        for name, kw in decode_cases.items():
            args = decode_case(rng, gen, dtype, **kw)
            out = pda.paged_decode_attention(*args)
            err, ok = compare(out, pda.paged_decode_attention_plain(*args),
                              dtype)
            torch.cuda.synchronize()
            log(f"  decode  {str(dtype):15s} {name:22s} max_abs_err {err:.3e}"
                f" tol {TOL[dtype]} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("decode", dtype, name))
        prefill_cases = {
            "C=64 page edges, valid=0": dict(starts=[0, 21, 64, 250],
                                             valid=[64, 64, 40, 0], C=64),
            "C=128": dict(starts=[0, 7, 300], valid=[128, 100, 128], C=128),
            "C=512": dict(starts=[0, 33, 16], valid=[512, 0, 300], C=512),
            # the serve phase's buckets: one and two tiles of 16 positions,
            # live rows beside free (valid == 0) slots
            f"serving C=16 B={B}": dict(
                starts=[0, 0, 16, 0, 5, 0, 0, 0][:B],
                valid=[5, 16, 0, 12, 0, 1, 16, 0][:B], C=16, **serving),
            f"serving C=32 B={B}": dict(
                starts=[0] * B, valid=[23, 0, 32, 4, 17, 0, 9, 0][:B], C=32,
                **serving),
        }
        for name, kw in prefill_cases.items():
            args = prefill_case(rng, gen, dtype, **kw)
            out = ppa.paged_prefill_attention(*args)
            err, ok = compare(out, ppa.paged_prefill_attention_plain(*args),
                              dtype, rows=kw["valid"])
            torch.cuda.synchronize()
            log(f"  prefill {str(dtype):15s} {name:22s} max_abs_err {err:.3e}"
                f" tol {TOL[dtype]} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("prefill", dtype, name))

    # timings at the serving path's shapes, in its dtype
    dtype = torch.bfloat16
    H, KVH, D = 32, 8, 64
    esize = 2
    lengths = rng.integers(5, 41, size=B)       # prompt 4-23 + <=16 new
    d_args = decode_case(rng, gen, dtype, lengths.tolist(), nb=nb, N=N)
    q, kp, vp, bt, ln = d_args
    d_err, ok = compare(pda.paged_decode_attention(*d_args),
                        pda.paged_decode_attention_plain(*d_args), dtype)
    if not ok:
        failures.append(("decode", dtype, "timed serving case"))
    S = nb * bs
    k_dense = gather_pages(kp, bt).to(dtype)
    v_dense = gather_pages(vp, bt).to(dtype)
    mask = (torch.arange(S, device="cuda")[None, :] < ln[:, None])[:, None,
                                                                    None]
    q4 = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live = int(lengths.sum())
    live_blocks = int(sum(-(-n // bs) for n in lengths))
    d_bytes = (2 * B * H * D + 2 * live * KVH * D) * esize \
        + live_blocks * 4 + B * 4
    d_flops = 4.0 * H * D * live
    d_bound, d_by = bound(d_bytes, d_flops, dtype)
    decode = {
        "max_abs_err": d_err,
        "ms": time_ms(lambda: pda.paged_decode_attention(*d_args)),
        "plain_ms": time_ms(lambda: pda.paged_decode_attention_plain(*d_args)),
        "bound_ms": d_bound, "bound_by": d_by,
        "library_ms": time_ms(lambda: sdpa(q4, k_dense, v_dense,
                                           attn_mask=mask, enable_gqa=True)),
    }

    C = main_shapes["C"]
    valid = rng.integers(4, 24, size=B)
    valid[-2:] = 0                               # free slots in the batch
    p_args = prefill_case(rng, gen, dtype, [0] * B, valid.tolist(), C,
                          nb=nb, N=N)
    q, kp, vp, ck, cv, bt, st, vd = p_args
    p_err, ok = compare(ppa.paged_prefill_attention(*p_args),
                        ppa.paged_prefill_attention_plain(*p_args), dtype,
                        rows=valid.tolist())
    if not ok:
        failures.append(("prefill", dtype, "timed serving case"))
    check(not failures, f"kernels disagree with their plain versions: "
                        f"{failures}")
    k_all = torch.cat([gather_pages(kp, bt).to(dtype), ck], dim=2)
    v_all = torch.cat([gather_pages(vp, bt).to(dtype), cv], dim=2)
    c = torch.arange(C, device="cuda")
    pmask = torch.cat([
        (torch.arange(S, device="cuda")[None, :] < st[:, None])[:, None, :]
        .expand(B, C, S),
        (c[None, :] <= c[:, None])[None] & (c[None, None, :]
                                            < vd[:, None, None])],
        dim=-1)[:, None]
    # only the valid query rows are needed (rows past valid[b] are garbage
    # the caller ignores); the prefix is empty, so no table entry is live
    n_q = int(valid.sum())
    p_bytes = (2 * n_q * H * D + 2 * n_q * KVH * D) * esize + 2 * B * 4
    p_flops = 4.0 * H * D * float(sum(v * (v + 1) / 2 for v in valid))
    p_bound, p_by = bound(p_bytes, p_flops, dtype)
    prefill = {
        "max_abs_err": p_err,
        "ms": time_ms(lambda: ppa.paged_prefill_attention(*p_args)),
        "plain_ms": time_ms(lambda: ppa.paged_prefill_attention_plain(
            *p_args)),
        "bound_ms": p_bound, "bound_by": p_by,
        "library_ms": time_ms(lambda: sdpa(q, k_all, v_all, attn_mask=pmask,
                                           enable_gqa=True)),
    }
    long_context_timings(rng, gen)
    log(f"  timed at serving shapes, bf16: decode B={B} H={H} KVH={KVH} D={D}"
        f" bs={bs} nb={nb} N={N} live tokens={live}; prefill C={C} valid "
        f"rows={int((valid > 0).sum())} query tokens={n_q}")
    for name, rec, fn, args in (
            ("paged_decode_attention", decode, pda.paged_decode_attention,
             d_args),
            ("paged_prefill_attention", prefill, ppa.paged_prefill_attention,
             p_args)):
        log(f"  {name}: " + json.dumps(rec) + f"; eager call with host "
            f"dispatch {eager_ms(lambda: fn(*args)):.4f} ms")
    return {"paged_decode_attention": decode,
            "paged_prefill_attention": prefill}


def long_context_timings(rng, gen) -> None:
    """Informational: both kernels where the KV read is large (decode over
    8 x 4096 tokens, 67 MB of KV, past the 50 MB L2; a 128-token chunk over
    a 2048-token prefix), bf16, beside their bounds."""
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa

    dtype, H, KVH, D = torch.bfloat16, 32, 8, 64
    d_args = decode_case(rng, gen, dtype, [4096] * 8, nb=256)
    live = 8 * 4096
    d_bound, d_by = bound((2 * 8 * H * D + 2 * live * KVH * D) * 2
                          + (live // 16 + 8) * 4, 4.0 * H * D * live, dtype)
    C, start, B = 128, 2048, 4
    p_args = prefill_case(rng, gen, dtype, [start] * B, [C] * B, C)
    p_bound, p_by = bound((2 * B * H * C * D + 2 * B * KVH * C * D
                           + 2 * B * start * KVH * D) * 2
                          + (B * start // 16 + 2 * B) * 4,
                          4.0 * H * D * B * (start * C + C * (C + 1) / 2),
                          dtype)
    for name, fn, args, b, by in (
            ("paged_decode_attention", pda.paged_decode_attention, d_args,
             d_bound, d_by),
            ("paged_prefill_attention", ppa.paged_prefill_attention, p_args,
             p_bound, p_by)):
        log(f"  long context {name}: " + json.dumps({
            "ms": time_ms(lambda: fn(*args)),
            "bound_ms": b, "bound_by": by}))


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------

def serving_shapes() -> dict:
    """The attention shapes the serve phase gives the kernels: every slot
    in each call, the engine's page pool and block table, and the chunk
    bucket covering the workload's longest prompt (23 tokens)."""
    from repro_torch.launch import serve
    ecfg = serve.engine_config(SERVE_ARGS, torch.bfloat16)
    return {"B": ecfg.max_slots, "bs": ecfg.block_size,
            "nb": ecfg.max_blocks_per_seq(), "N": ecfg.resolved_kv_blocks(),
            "C": next(b for b in ecfg.resolved_buckets() if b >= 23)}


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def serve_phase(model, params) -> dict:
    """The main path: repro_torch.launch.serve's round-robin driver."""
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch import serve

    args = SERVE_ARGS
    np.random.seed(0)                # calibrate_from_engine's prompts
    pda.launches = ppa.launches = 0
    t0 = time.monotonic()
    stats, seen, engines = serve.run_round_robin(
        args, {GRANITE: (model, params)}, [GRANITE])
    launches = {"paged_decode_attention": pda.launches,
                "paged_prefill_attention": ppa.launches}
    wall = time.monotonic() - t0
    log("  summarize: " + json.dumps(stats))
    st = engines[0].stats
    log(f"  engine: {st.decode_iterations} decode steps in "
        f"{st.decode_time:.3f} s, {st.prefill_chunks} prefill chunk rounds "
        f"in {st.prefill_time:.3f} s (serving only, after calibration)")
    log(f"  wall {wall:.1f} s (calibration included); kernel launches "
        f"{launches}")
    check(len(seen) == 8, f"workload has {len(seen)} requests")
    check(all(r.finished() or r.dropped() for r in seen),
          "a request is not terminal")
    check(stats["served"] >= 1 and stats["tokens"] > 0,
          f"nothing served: {stats}")
    for r in seen:
        if r.output_tokens:
            check(len(r.output_tokens) == args.max_new_tokens
                  and all(0 <= t < model.cfg.vocab_size
                          for t in r.output_tokens),
                  f"request {r.req_id} tokens {r.output_tokens}")
    check(all(e.block_mgr.used_blocks == 0 for e in engines),
          "KV blocks leaked")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    return launches


def step_timings(model, params) -> None:
    """Informational: one full-width decode step and one prefill chunk
    round at the serve phase's batch (8 slots, 40-token sequences, a
    32-token chunk bucket) — device time from CUDA-graph replays against
    the time of the same call issued eagerly from Python."""
    shapes = serving_shapes()
    B, nb, N, bs, C = (shapes[k] for k in ("B", "nb", "N", "bs", "C"))
    cache = model.init_paged_cache(N, bs, torch.bfloat16, "cuda")
    bt = torch.arange(B * nb, dtype=torch.int32, device="cuda").reshape(B, nb)
    tokens = torch.arange(B, dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), 40, dtype=torch.int32, device="cuda")
    chunk = torch.arange(B * C, dtype=torch.int32, device="cuda").reshape(B, C)
    starts = torch.zeros(B, dtype=torch.int32, device="cuda")
    valid = torch.full((B,), 20, dtype=torch.int32, device="cuda")
    for name, fn in (
            ("decode step", lambda: model.decode_step_paged(
                params, cache, tokens, lengths, bt)),
            ("prefill chunk round", lambda: model.prefill_chunk_paged(
                params, cache, chunk, starts, valid, bt))):
        device, eager = time_ms(fn, iters=5, replays=4), eager_ms(fn, iters=10)
        log(f"  {name}: device {device:.3f} ms, eager {eager:.3f} ms, host "
            f"share {1 - device / eager:.3f}")


def long_prompt_phase(model, params) -> None:
    from repro_torch.core.request import Request
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    eng = ContinuousBatchingEngine(model, params, EngineConfig(
        max_slots=4, max_seq_len=512, block_size=16, prefill_chunk_tokens=64,
        dtype=torch.bfloat16, device="cuda"), model_name=GRANITE)
    rng = np.random.default_rng(1)
    vocab = model.cfg.vocab_size
    prompt_a = rng.integers(0, vocab, size=300).tolist()
    prompt_b = prompt_a[:256] + rng.integers(0, vocab, size=40).tolist()
    a = Request(prompt_tokens=prompt_a, model=GRANITE, slo=1e9,
                max_new_tokens=8)
    b = Request(prompt_tokens=prompt_b, model=GRANITE, slo=1e9,
                max_new_tokens=8)
    launches0 = ppa.launches
    check(eng.admit(a), "long prompt not admitted")
    while eng.prefilling_slots():
        eng.step()
    check(eng.stats.prefill_chunks == 5, f"{eng.stats.prefill_chunks} chunks")
    # copy-on-write: fork a's sequence; its partial tail block is copied
    # before any dispatch
    table = eng.block_mgr.block_table(a.req_id)
    fork_id = 10 ** 9
    eng.block_mgr.fork(a.req_id, fork_id)
    clone = eng.block_mgr.block_table(fork_id)
    eng._apply_cow()
    torch.cuda.synchronize()
    check(eng.stats.cow_copies == 1 and clone[-1] != table[-1]
          and all(torch.equal(pool[:, clone[-1]], pool[:, table[-1]])
                  for pool in eng.cache.values()), "COW page copy")
    eng.block_mgr.free(fork_id)
    check(eng.admit(b), "sharing prompt not admitted")
    for _ in range(100):
        eng.step()
        if a.finished() and b.finished():
            break
    s = eng.stats
    log(f"  prefix_hits {s.prefix_hits} shared_tokens "
        f"{s.prefix_shared_tokens} prefill_chunks {s.prefill_chunks} "
        f"cow_copies {s.cow_copies} prefill launches "
        f"{ppa.launches - launches0}; tokens a {a.output_tokens} "
        f"b {b.output_tokens}")
    check(a.finished() and b.finished()
          and len(a.output_tokens) == len(b.output_tokens) == 8,
          "long-prompt requests did not finish")
    check(s.prefix_hits == 1 and s.prefix_shared_tokens == 256,
          "no prefix hit")
    check(eng.block_mgr.used_blocks == 0, "KV blocks leaked")


def reference_phase() -> None:
    """The CUDA path against the plain path on the CPU, same weights."""
    from repro_torch.configs import get_arch
    from repro_torch.core.request import Request
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    cfg = get_arch(GRANITE).reduced(num_layers=2, d_model=256, num_heads=8,
                                    num_kv_heads=2)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = model.init(gen, torch.float32, "cuda")
    rng = np.random.default_rng(2)
    common = rng.integers(0, 100, size=24).tolist()
    prompts = [common + rng.integers(0, 100, size=n).tolist()
               for n in (5, 60, 1, 17)] + [rng.integers(0, 100, 9).tolist()]

    outs = []
    for device, p in (("cuda", params), ("cpu", _to_cpu(params))):
        eng = ContinuousBatchingEngine(model, p, EngineConfig(
            max_slots=4, max_seq_len=128, block_size=8,
            prefill_chunk_tokens=16, decode_burst=4, device=device,
            debug_invariants=True), model_name="m")
        reqs = [Request(prompt_tokens=pr, model="m", slo=1e9,
                        max_new_tokens=12) for pr in prompts]
        first_admitted = eng.admit(reqs[0])
        while eng.prefilling_slots():
            eng.steps()
        waiting = reqs[1:]
        for i in range(200):
            while waiting and eng.admit(waiting[0]):
                waiting.pop(0)
            eng.steps()
            if i == 3 and eng.decode_slots():
                r = eng.evict_slot(eng.decode_slots()[0])
                waiting.insert(0, r)
            if all(r.finished() for r in reqs):
                break
        check(first_admitted and all(r.finished() for r in reqs),
              f"{device}: reference trace did not finish")
        outs.append(([r.output_tokens for r in reqs], eng.stats))
    (got, gs), (want, ws) = outs
    log(f"  cuda tokens == cpu tokens: {got == want}; prefix_hits "
        f"{gs.prefix_hits}/{ws.prefix_hits}, resumes {gs.resumes}/"
        f"{ws.resumes}")
    check(got == want, f"cuda {got} != cpu {want}")
    check(gs.prefix_hits >= 1 and gs.resumes >= 1,
          "reference trace missed sharing or resume")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    build.build()
    log(f"[build] {len(build.SOURCES)} kernels in "
        f"{time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    cfg = get_arch(GRANITE)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[init] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params bf16 in {time.monotonic() - t0:.1f} s")

    log("[kernels] against their plain versions")
    t0 = time.monotonic()
    timings = kernel_phase(serving_shapes())
    log(f"[kernels] ok in {time.monotonic() - t0:.1f} s")

    log("[serve] main path")
    t0 = time.monotonic()
    launches = serve_phase(model, params)
    log(f"[serve] ok in {time.monotonic() - t0:.1f} s")

    log("[step] full-width step times, device vs eager")
    step_timings(model, params)

    log("[long-prompt] 64-token chunks, prefix sharing, COW")
    t0 = time.monotonic()
    long_prompt_phase(model, params)
    log(f"[long-prompt] ok in {time.monotonic() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    log("[reference] cuda engine vs cpu engine, reduced granite, float32")
    t0 = time.monotonic()
    reference_phase()
    log(f"[reference] ok in {time.monotonic() - t0:.1f} s")

    sources = {"paged_decode_attention": 255, "paged_prefill_attention": 264}
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": f"src/repro/kernels/{name}.py:{line}",
        "launches": launches[name], **timings[name],
    } for name, line in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
