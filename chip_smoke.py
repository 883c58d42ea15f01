"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-timings [SRC]

The second form times only the float decode kernels and the granite
decode steps (``decode_timings``), with the package under SRC, so that a
parent commit's kernels can be timed beside this one's in one call.

Phases, in order; any failure exits non-zero before the result lines:

  1. require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, started together); print one line per library with
     ``ptxas``'s registers, spill bytes and static shared memory of each of
     its kernels, and one with the count of tensor-core instructions
     (``HMMA``/``HGMMA``) in its SASS (``cuobjdump -sass``): the float
     paged prefill, flash and paged / dense decode kernels must hold
     them, or the run fails;
  3. kernel phase: the six serving kernels (paged decode, paged prefill,
     dense decode, each in float and int8-KV form) against their plain
     PyTorch versions on the card, in float32 and bfloat16, at granite-3-2b's
     widths (32 query heads, 8 KV heads, head_dim 64, 16-token pages) and
     at h2o-danube's head_dim 80: sentinel table entries, lengths 0/1/page
     edges/the full slot, prefill chunks that start past a page edge,
     ``valid == 0`` rows, chunks of 128 and 512, long context (lengths up
     to 4096), and the serve phases' own shapes (8 slots, the page pool and
     table or the 128-slot dense cache plus its sink column, 16- and
     32-token chunk buckets with free slots among live rows).  Every case
     that disagrees is a failure.  Then time kernel, plain version and the
     library call (``scaled_dot_product_attention`` over the gathered or
     length-masked KV; none computes an int8 twin in one call, so its
     ``library_ms`` is null and the dequantize-then-SDPA time is printed
     beside it) at the serving shapes (device time, from CUDA-graph
     replays), beside the bound, and each kernel once more at long context
     (the float decode kernels also beside SDPA over the gathered or
     length-masked KV, with their split count; the float prefill also
     beside SDPA over the gathered prefix plus the chunk, and at one chunk
     round of a single long prompt: B 1, 128 queries over a 4096-token
     prefix).
     Then flash attention in f32 and bf16 at granite's widths (B 2, 32
     heads on 8, D 64, L 512), h2o-danube's D 80 with windows 8, 17 and
     64, the JAX tests' ragged cases (Lq 33 on Lkv 65, L 100) and L 2048;
     its autograd Function's gradients against autograd of the plain
     version (f32, 1e-4); and its time at the training phase's shape (f32)
     beside its bound (the visible half of the causal square; f32 at the
     3xTF32 rate, with the CUDA-core rate's bound beside it) and
     ``scaled_dot_product_attention``, and, for reference, in bf16, with
     a 64-token window (SDPA with a boolean mask) and at L 2048.  Then
     the SSD scan in f32 and bf16 (dt, A and the states f32), with and
     without an initial state, its final state returned, on the JAX
     tests' shapes (G > 1 among them), mamba2-130m's serving prefill (B 1,
     L 64, 24 heads of 64, N 128), L 2048, B 4 L 512 and zamba2's widths
     (64 heads, N 64); f32 within 5e-4, the JAX kernel test's tolerance;
     and its time at the serving prefill's shape (bf16, with the state in
     and out, as the engine calls it) beside its bound and the plain
     version (no single PyTorch call computes the scan: ``library_ms``
     null), and for reference at L 512, L 2048 and B 4 L 512;
  4. serve phases, one per path, each with the launch counts set to 0 just
     before and read just after, through ``calibrate_registry`` /
     ``build_cluster`` / ``run_round_robin`` of
     ``repro_torch.launch.serve`` for 8 requests, full width, bfloat16,
     random weights from seeded ``torch.Generator``s; every request must
     end terminal, no KV block may leak, the path's kernels (and no other)
     must have launched:
       a. the page pool (``paged-cuda``), granite-3-2b (40 layers,
          d_model 2048);
       b. int8 KV pages: the same granite with ``kv_quant``;
       c. the dense per-slot backend (``cuda``): granite-3-2b and
          h2o-danube-1.8b (24 layers, d_model 2560, head_dim 80,
          4096-token window) in one engine, with at least one model swap;
       d. the same two models with int8 dense caches;
       e. mamba2-130m (24 layers, d_model 768, 24 SSD heads of 64, N 128)
          on the dense backend, admitted through the single-shot prefill:
          exactly one ``ssd_scan`` launch per layer and prefill (prefills
          counted by wrapping the model's ``prefill``);
       f. granite-3-2b and mamba2-130m in one dense engine, with at least
          one model swap: ``decode_attention`` and ``ssd_scan`` only;
     b-f must serve all 8 requests;
  5. full-width step times of each path, device time (CUDA-graph replay)
     against the eager call; granite's decode step also at 8 slots x 4096
     tokens of context, page pool and dense; for mamba2 one decode step at
     8 slots and one
     single-shot prefill of 64 and of 512 tokens, with the launch count
     of one prefill (one per layer) and of one decode step (none);
  6. long-prompt phase: one full-width engine with 64-token chunks serves
     a 300-token prompt and a second one sharing its first 256 tokens (a
     prefix hit: prefill chunks start past the shared pages), plus a
     copy-on-write page copy of a forked tail block;
  7. reference phase: reduced models in float32 on the card and on the
     CPU (the kernels' plain versions) with the same weights must give the
     same greedy tokens through chunked prefill, evict/resume and decode
     bursts: granite on the page pool (with prefix sharing), granite on
     the dense backend, and h2o-danube on the dense backend with prompts
     past its 64-token rolling window; granite on int8 pages must keep its
     logits within 1e-3 of the CPU's and may part from its tokens only at
     a near tie (``near_tie_parting``); so may mamba2 (dense backend,
     single-shot prefill through the SSD kernel on the card), whose
     float logits are checked the same way;
  8. training phase, through ``repro_torch.launch.train.train`` with
     ``use_pallas_attention`` set, float32, launch counts set to 0 just
     before and read just after: 3 steps of full-width granite-3-2b
     (batch 2, seq 512, remat) with finite losses and exactly 2 flash
     launches per layer and step (the forward and each block's recompute),
     its step times and peak memory; one step of the same weights and
     batch with the flag off (step-0 loss within 1e-4 relative, gradient
     norm within 1e-3); one full-width step of h2o-danube-1.8b (D 80);
  9. training reference phase: reduced granite and h2o-danube (window 64,
     seq 128) trained 3 steps on the card (the kernel) and on the CPU (the
     plain version) from the same weights and data: losses and final
     params within 1e-4.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# f32: the 3xTF32 rate, three TF32 products (495 TFLOP/s) per f32-accurate
# one, the fastest f32-accurate rate of the card, on which the flash
# kernel runs; the CUDA cores' f32 rate is printed beside it
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
F32_CUDA_CORE_FLOPS = 67e12
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
GRANITE, DANUBE, MAMBA = "granite-3-2b", "h2o-danube-1.8b", "mamba2-130m"
# the SSD scan in float32: the JAX kernel test's own tolerance (sums over
# up to 128 + 64 terms of unit-normal inputs in another order)
SSD_TOL = {**TOL, torch.float32: dict(atol=5e-4, rtol=5e-4)}
# the serve phases' arguments (repro_torch.launch.serve's flags); each
# phase sets its backend
SERVE_ARGS = argparse.Namespace(
    slots=8, decode_burst=1, backend=None, prefix_sharing=True,
    debug_invariants=False, device="cuda", instances=1,
    routing="solver", requests=8, rate=4.0, max_new_tokens=16, seed=0,
    max_wall=300.0)
# kernel -> (wrapper module in repro_torch.kernels, its launch counter,
# CUDA source, the TPU kernel it replaces: file:line of its def)
KERNELS = {
    "paged_decode_attention": (
        "paged_decode_attention", "launches", "paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:255"),
    "paged_decode_attention_quant": (
        "paged_decode_attention", "quant_launches",
        "paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:269"),
    "paged_prefill_attention": (
        "paged_prefill_attention", "launches", "paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention.py:264"),
    "paged_prefill_attention_quant": (
        "paged_prefill_attention", "quant_launches",
        "paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention.py:284"),
    "decode_attention": (
        "decode_attention", "launches", "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:173"),
    "decode_attention_quant": (
        "decode_attention", "quant_launches", "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:121"),
    "flash_attention": (
        "flash_attention", "launches", "flash_attention.cu",
        "src/repro/kernels/flash_attention.py:94"),
    "ssd_scan": (
        "ssd_scan", "launches", "ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:75"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(*a) -> None:
    print(*a, flush=True)


def _module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{KERNELS[name][0]}")


def kernel_fns(name: str):
    """(wrapper, plain version) of kernel ``name``."""
    mod = _module(name)
    return getattr(mod, name), getattr(mod, f"{name}_plain")


def reset_launches() -> None:
    for name, (_, counter, _, _) in KERNELS.items():
        setattr(_module(name), counter, 0)


def read_launches() -> dict:
    return {name: getattr(_module(name), counter)
            for name, (_, counter, _, _) in KERNELS.items()}


# ---------------------------------------------------------------------------
# build: resources and tensor-core instructions
# ---------------------------------------------------------------------------

# libraries whose float kernels must run their products on the tensor cores
MMA_LIBRARIES = ("paged_prefill_attention", "flash_attention",
                 "paged_decode_attention", "decode_attention")


def _short_names(mangled) -> dict:
    """mangled -> short demangled kernel name (template arguments kept)."""
    from repro_torch.kernels import build
    mangled = sorted(set(mangled))
    out = subprocess.run([build.cuda_tool("cu++filt"), *mangled],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()
    short = {}
    for m, d in zip(mangled, out):
        d = d.replace("(int)", "")      # cu++filt's casts of template ints
        name = re.search(r"(\w+(?:<[^()]*>)?)\(", d)
        short[m] = name.group(1) if name else d
    return short


def kernel_resources() -> None:
    """One line per library with ptxas's registers, spill bytes and static
    shared memory of each kernel; one with the HMMA/HGMMA count of each
    kernel's SASS.  Every tensor-core kernel of MMA_LIBRARIES must hold
    tensor-core instructions."""
    from repro_torch.kernels import build

    for lib in build.SOURCES:
        res, name = {}, None
        for line in build.ptxas_log(lib).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                res[name] = {"registers": 0, "spill_bytes": 0,
                             "smem_bytes": 0}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                res[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                res[name]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                res[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
        short = _short_names(res)
        log(f"  ptxas {lib}: {len(res)} kernels, max registers "
            f"{max(r['registers'] for r in res.values())}, max spill bytes "
            f"{max(r['spill_bytes'] for r in res.values())}; " + json.dumps(
                {short[k]: [r["registers"], r["spill_bytes"], r["smem_bytes"]]
                 for k, r in res.items()}) + " (registers, spill stores + "
            "loads bytes, static smem bytes)")

        sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass",
                               str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn and re.search(r"\b(HMMA|HGMMA)\.", line):
                counts[fn] += 1
        short = _short_names(counts)
        named = {short[k]: n for k, n in counts.items()}
        log(f"  sass {lib}: HMMA/HGMMA instructions {sum(counts.values())} "
            f"in {sum(1 for n in counts.values() if n)} of {len(counts)} "
            f"kernels; " + json.dumps(named))
        if lib in MMA_LIBRARIES:
            mma = {k: n for k, n in named.items() if "mma_kernel" in k}
            check(mma and all(mma.values()),
                  f"{lib}: a tensor-core kernel without HMMA/HGMMA: {named}")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _rows(gen, shape, dtype, quant):
    """k and v rows of ``shape`` (..., D): ``dtype`` values, or int8 values
    followed by their per-row ``dtype`` scales."""
    if quant:
        kv = [torch.randint(-127, 128, shape, generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2)]
        scales = [(torch.rand(shape[:-1], generator=gen, device="cuda") * 0.05
                   + 1e-3).to(dtype) for _ in range(2)]
        return kv + scales
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2)]


def _table(rng, B, nb, N, live):
    """Distinct random pages for each row's live blocks, sentinels after."""
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    for b, n in enumerate(live):
        bt[b, n:] = N + 5
    return torch.tensor(bt, device="cuda")


def _ints(values):
    return torch.tensor(np.asarray(values, np.int32), device="cuda")


def decode_case(rng, gen, dtype, lengths, quant=False, *, H=32, KVH=8, D=64,
                bs=16, nb=8, N=None):
    """Arguments of the paged decode kernel (its int8 twin if ``quant``)."""
    B = len(lengths)
    N = N or max(B * nb, 8)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    pools = _rows(gen, (N, KVH, bs, D), dtype, quant)
    bt = _table(rng, B, nb, N, [-(-int(n) // bs) for n in lengths])
    return (q, *pools, bt, _ints(lengths))


def prefill_case(rng, gen, dtype, starts, valid, C, quant=False, *, H=32,
                 KVH=8, D=64, bs=16, nb=None, N=None):
    """Arguments of the paged prefill kernel (its int8 twin if ``quant``)."""
    B = len(starts)
    nb = nb or -(-(max(starts) + C) // bs)
    N = N or B * nb
    q = torch.randn((B, H, C, D), generator=gen, device="cuda").to(dtype)
    ck, cv = [torch.randn((B, KVH, C, D), generator=gen, device="cuda")
              .to(dtype) for _ in range(2)]
    pools = _rows(gen, (N, KVH, bs, D), dtype, quant)
    bt = _table(rng, B, nb, N, [-(-int(s) // bs) for s in starts])
    return (q, *pools, ck, cv, bt, _ints(starts), _ints(valid))


def dense_case(rng, gen, dtype, lengths, S, quant=False, *, H=32, KVH=8,
               D=64):
    """Arguments of the dense decode kernel (its int8 twin if ``quant``)
    over a (B, KVH, S, D) cache."""
    B = len(lengths)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    return (q, *_rows(gen, (B, KVH, S, D), dtype, quant), _ints(lengths))


def compare(out, want, dtype, rows=None, tol=TOL):
    """Max abs error and whether every element is within tol[dtype];
    ``rows`` restricts a prefill output to each sequence's valid rows."""
    if rows is not None:
        out = torch.cat([out[b, :, :n].flatten() for b, n in enumerate(rows)])
        want = torch.cat([want[b, :, :n].flatten()
                          for b, n in enumerate(rows)])
    out, want = out.float(), want.float()
    err = (out - want).abs()
    ok = bool((err <= tol[dtype]["atol"] + tol[dtype]["rtol"]
               * want.abs()).all())
    return (float(err.max()) if err.numel() else 0.0), ok


def check_case(failures, name, dtype, case, args, rows=None) -> float:
    """Kernel ``name`` against its plain version on ``args``; a
    disagreement is appended to ``failures``."""
    fn, plain = kernel_fns(name)
    err, ok = compare(fn(*args), plain(*args), dtype, rows)
    torch.cuda.synchronize()
    log(f"  {name:30s} {str(dtype):15s} {case:24s} max_abs_err {err:.3e}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append((name, str(dtype), case))
    return err


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


def attn_bytes(esize, *, H, KVH, D, q_rows, kv_rows, quant, chunk_rows=0,
               table=0, ints=0):
    """Bytes an attention call must move: q and out (``q_rows`` query
    tokens), the live k/v rows (int8 plus one scale each when ``quant``),
    a prefill chunk's own k/v, the live table entries and the per-sequence
    ints."""
    kv_row = D + esize if quant else D * esize
    return (2 * q_rows * H * D * esize + 2 * kv_rows * KVH * kv_row
            + 2 * chunk_rows * KVH * D * esize + 4 * (table + ints))


def _dequant(x, scale, dtype):
    return (x.float() * scale.float()[..., None]).to(dtype)


def prefill_library(args, dtype):
    """SDPA computing the float paged prefill on ``args``: the gathered
    prefix (positions < starts) plus the chunk's own keys (causal, <
    valid), through one boolean mask."""
    from repro_torch.kernels.paged_decode_attention import gather_pages

    q, kp, vp, ck, cv, bt, st, vd = args
    B, _, C, _ = q.shape
    S = bt.shape[1] * kp.shape[2]
    c = torch.arange(C, device="cuda")
    mask = torch.cat([
        (torch.arange(S, device="cuda")[None, :] < st[:, None])
        [:, None, :].expand(B, C, S),
        (c[None, :] <= c[:, None])[None] & (c[None, None, :]
                                            < vd[:, None, None])],
        dim=-1)[:, None]
    k_all = torch.cat([gather_pages(kp, bt).to(dtype), ck], dim=2)
    v_all = torch.cat([gather_pages(vp, bt).to(dtype), cv], dim=2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_all, v_all, attn_mask=mask, enable_gqa=True)


FLOAT_DECODE = ("paged_decode_attention", "decode_attention")


def decode_library(name, args):
    """SDPA computing the float decode kernel ``name`` on ``args``: over
    the KV gathered through the block table (paged) or over the dense
    cache, masked by lengths."""
    from repro_torch.kernels.paged_decode_attention import gather_pages

    if name == "paged_decode_attention":
        q, kp, vp, bt, ln = args
        k, v = (gather_pages(p, bt).to(q.dtype) for p in (kp, vp))
    else:
        q, k, v, ln = args
    mask = (torch.arange(k.shape[2], device="cuda")[None, :]
            < ln[:, None])[:, None, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)


def decode_splits(name, args):
    """CTAs per (sequence, KV head) of the float decode kernel ``name`` on
    ``args``, from its launch plan (None for a tree without one)."""
    from repro_torch.kernels import common

    if not hasattr(common, "decode_plan"):
        return None
    q = args[0]
    B, H, D = q.shape
    if name == "paged_decode_attention":
        KVH, bs = args[1].shape[1:3]
        cap = args[3].shape[1] * bs
    else:
        KVH, cap = args[1].shape[1:3]
    return common.decode_plan(B, H, KVH, cap, D, q.dtype).splits


def kernel_phase(shapes: dict):
    """Every kernel against its plain version over the cases below, then
    the timed records at the serving shapes.  Returns (records, failures)."""
    from repro_torch.kernels.paged_decode_attention import gather_pages

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, nb, N, bs, S1 = (shapes[k] for k in ("B", "nb", "N", "bs", "S1"))
    serving = dict(nb=nb, N=N)
    failures = []
    decode_cases = {
        "edges+sentinels": dict(lengths=[1, 16, 17, 0, 100, 128, 33, 2]),
        "long (nb=32)": dict(lengths=[500, 257, 1, 320], nb=32),
        "head_dim 80": dict(lengths=[1, 40, 0, 77], D=80),
        f"serving B={B} nb={nb} N={N}": dict(
            lengths=[5, 40, 1, 0, 17, 33, 0, 16][:B], **serving),
    }
    prefill_cases = {
        "C=64 page edges, valid=0": dict(starts=[0, 21, 64, 250],
                                         valid=[64, 64, 40, 0], C=64),
        "C=128": dict(starts=[0, 7, 300], valid=[128, 100, 128], C=128),
        "C=512": dict(starts=[0, 33, 16], valid=[512, 0, 300], C=512),
        "head_dim 80": dict(starts=[0, 40, 3], valid=[32, 17, 0], C=32,
                            D=80),
        # the serve phases' buckets: one and two tiles of 16 positions,
        # live rows beside free (valid == 0) slots
        f"serving C=16 B={B}": dict(
            starts=[0, 0, 16, 0, 5, 0, 0, 0][:B],
            valid=[5, 16, 0, 12, 0, 1, 16, 0][:B], C=16, **serving),
        f"serving C=32 B={B}": dict(
            starts=[0] * B, valid=[23, 0, 32, 4, 17, 0, 9, 0][:B], C=32,
            **serving),
    }
    dense_cases = {
        # lengths up to S: the full slot, and the engine's clamp at S - 1
        "edges S=129": dict(lengths=[1, 0, 129, 64, 2, 33, 128, 17], S=129),
        "long S=4096": dict(lengths=[4096, 1, 2049, 0], S=4096),
        "head_dim 80": dict(lengths=[1, 65, 0, 40], S=65, D=80),
        f"serving B={B} S={S1}": dict(
            lengths=[5, 40, 1, 0, 17, 33, 0, 16][:B], S=S1),
    }
    for dtype in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            sfx = "_quant" if quant else ""
            for case, kw in decode_cases.items():
                check_case(failures, "paged_decode_attention" + sfx, dtype,
                           case, decode_case(rng, gen, dtype, quant=quant,
                                             **kw))
            for case, kw in prefill_cases.items():
                check_case(failures, "paged_prefill_attention" + sfx, dtype,
                           case, prefill_case(rng, gen, dtype, quant=quant,
                                              **kw), rows=kw["valid"])
            for case, kw in dense_cases.items():
                check_case(failures, "decode_attention" + sfx, dtype, case,
                           dense_case(rng, gen, dtype, quant=quant, **kw))

    # timings at the serving paths' shapes, in their dtype
    dtype, esize = torch.bfloat16, 2
    H, KVH, D = 32, 8, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = {}

    def timed(name, args, nbytes, flops, library=None, rows=None):
        fn, plain = kernel_fns(name)
        err = check_case(failures, name, dtype, "timed serving shapes", args,
                         rows)
        bound_ms, by = bound(nbytes, flops, dtype)
        records[name] = {
            "max_abs_err": err, "ms": time_ms(lambda: fn(*args)),
            "plain_ms": time_ms(lambda: plain(*args)),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None if library is None else time_ms(library)}
        log(f"  {name}: " + json.dumps(records[name]) + f"; eager call with "
            f"host dispatch {eager_ms(lambda: fn(*args)):.4f} ms")

    lengths = rng.integers(5, 41, size=B)       # prompt 4-23 + <=16 new
    live = int(lengths.sum())
    live_blocks = int(sum(-(-n // bs) for n in lengths))
    mask = (torch.arange(nb * bs, device="cuda")[None, :]
            < _ints(lengths)[:, None])[:, None, None]
    d_flops = 4.0 * H * D * live
    for quant in (False, True):
        args = decode_case(rng, gen, dtype, lengths.tolist(), quant,
                           nb=nb, N=N)
        q4, bt = args[0][:, :, None], args[-2]
        if quant:
            k = _dequant(gather_pages(args[1], bt), gather_pages(args[3], bt),
                         dtype)
            v = _dequant(gather_pages(args[2], bt), gather_pages(args[4], bt),
                         dtype)
            log("  paged_decode_attention_quant: no single PyTorch call; "
                "gather + dequantize, then SDPA: " + json.dumps({
                    "two_call_ms": time_ms(lambda: sdpa(
                        q4, _dequant(gather_pages(args[1], bt),
                                     gather_pages(args[3], bt), dtype),
                        _dequant(gather_pages(args[2], bt),
                                 gather_pages(args[4], bt), dtype),
                        attn_mask=mask, enable_gqa=True)),
                    "sdpa_alone_ms": time_ms(lambda: sdpa(
                        q4, k, v, attn_mask=mask, enable_gqa=True))}))
            library = None
        else:
            library = decode_library("paged_decode_attention", args)
        timed("paged_decode_attention" + ("_quant" if quant else ""), args,
              attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=B, kv_rows=live,
                         quant=quant, table=live_blocks, ints=B),
              d_flops, library)

    C = shapes["C"]
    valid = rng.integers(4, 24, size=B)
    valid[-2:] = 0                               # free slots in the batch
    n_q = int(valid.sum())
    for quant in (False, True):
        args = prefill_case(rng, gen, dtype, [0] * B, valid.tolist(), C,
                            quant, nb=nb, N=N)
        if quant:
            library = None
            log("  paged_prefill_attention_quant: no single PyTorch call; at "
                "the serving shapes the prefix is empty (every prompt fits "
                "its first chunk), so the int8 pages are not read")
        else:
            library = prefill_library(args, dtype)
        # only the valid query rows are needed (rows past valid[b] are
        # garbage the caller ignores); the prefix is empty, so no table
        # entry is live
        timed("paged_prefill_attention" + ("_quant" if quant else ""), args,
              attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=n_q, kv_rows=0,
                         quant=quant, chunk_rows=n_q, ints=2 * B),
              4.0 * H * D * float(sum(v * (v + 1) / 2 for v in valid)),
              library, rows=valid.tolist())

    dmask = (torch.arange(S1, device="cuda")[None, :]
             < _ints(lengths)[:, None])[:, None, None]
    for quant in (False, True):
        args = dense_case(rng, gen, dtype, lengths.tolist(), S1, quant)
        q4 = args[0][:, :, None]
        if quant:
            log("  decode_attention_quant: no single PyTorch call; "
                "dequantize, then SDPA: " + json.dumps({"two_call_ms": time_ms(
                    lambda: sdpa(q4, _dequant(args[1], args[3], dtype),
                                 _dequant(args[2], args[4], dtype),
                                 attn_mask=dmask, enable_gqa=True))}))
            library = None
        else:
            library = decode_library("decode_attention", args)
        timed("decode_attention" + ("_quant" if quant else ""), args,
              attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=B, kv_rows=live,
                         quant=quant, ints=B),
              d_flops, library)
    log(f"  timed at serving shapes, bf16: H={H} KVH={KVH} D={D}; paged "
        f"decode B={B} bs={bs} nb={nb} N={N} live tokens={live}; prefill "
        f"C={C} valid rows={int((valid > 0).sum())} query tokens={n_q}; "
        f"dense decode B={B} S={S1} live tokens={live}")
    long_context(rng, gen, failures)
    flash_phase(gen, failures, records)
    ssd_phase(gen, failures, records)
    return records, failures


def long_context(rng, gen, failures) -> None:
    """Every kernel where the KV read is large: decode over 8 x 4096 tokens
    (67 MB of bf16 KV, past the 50 MB L2; half that, plus scales, in int8),
    paged and dense, and a 128-token chunk over a 2048-token prefix for 4
    sequences; each checked against its plain version and timed beside its
    bound, bf16.  The float prefill also beside its plain version and SDPA,
    and at one chunk round of a single long prompt (B 1, 128 queries over
    a 4096-token prefix: 8 query tiles x 8 KV heads = 64 CTAs)."""
    dtype, esize, H, KVH, D = torch.bfloat16, 2, 32, 8, 64
    n, L = 8, 4096
    live = n * L

    def p_bound(B, start, C, quant):
        return bound(attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=B * C,
                                kv_rows=B * start, quant=quant,
                                chunk_rows=B * C, table=B * start // 16,
                                ints=2 * B),
                     4.0 * H * D * B * (start * C + C * (C + 1) / 2), dtype)

    for quant in (False, True):
        sfx = "_quant" if quant else ""
        d_bound = bound(attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=n,
                                   kv_rows=live, quant=quant,
                                   table=live // 16, ints=n),
                        4.0 * H * D * live, dtype)
        cases = [("paged_decode_attention" + sfx,
                  decode_case(rng, gen, dtype, [L] * n, quant, nb=L // 16),
                  d_bound, None, ""),
                 ("decode_attention" + sfx,
                  dense_case(rng, gen, dtype, [L] * n, L, quant), d_bound,
                  None, ""),
                 ("paged_prefill_attention" + sfx,
                  prefill_case(rng, gen, dtype, [2048] * 4, [128] * 4, 128,
                               quant), p_bound(4, 2048, 128, quant),
                  [128] * 4, " B4 C128 prefix 2048")]
        if not quant:
            cases.append(("paged_prefill_attention",
                          prefill_case(rng, gen, dtype, [4096], [128], 128),
                          p_bound(1, 4096, 128, False), [128],
                          " B1 C128 prefix 4096"))
        for name, args, (b, by), rows, label in cases:
            check_case(failures, name, dtype, "long context" + label, args,
                       rows)
            fn, plain = kernel_fns(name)
            rec = {"ms": time_ms(lambda: fn(*args)), "bound_ms": b,
                   "bound_by": by}
            if name == "paged_prefill_attention":
                rec["plain_ms"] = time_ms(lambda: plain(*args))
                rec["library_ms"] = time_ms(prefill_library(args, dtype))
            if name in FLOAT_DECODE:
                rec["library_ms"] = time_ms(decode_library(name, args))
                rec["splits"] = decode_splits(name, args)
            log(f"  long context {name}{label}: " + json.dumps(rec))


# (B, H, KVH, Lq, Lkv, D, window) of the flash cases: granite's widths at
# the training phase's batch and sequence, h2o-danube's D 80 with windows,
# the JAX tests' ragged lengths, and a long sequence
FLASH_CASES = {
    "granite B2 L512": (2, 32, 8, 512, 512, 64, None),
    "D80 window 8": (1, 32, 8, 300, 300, 80, 8),
    "D80 window 17": (1, 32, 8, 300, 300, 80, 17),
    "D80 window 64": (2, 32, 8, 512, 512, 80, 64),
    "MQA Lq33 Lkv65": (1, 4, 1, 33, 65, 16, None),
    "GQA L100": (2, 8, 2, 100, 100, 64, None),
    "L2048": (1, 32, 8, 2048, 2048, 64, None),
}


def flash_case(gen, dtype, B, H, KVH, Lq, Lkv, D):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, H, Lq, D), (B, KVH, Lkv, D), (B, KVH, Lkv, D))]


def flash_phase(gen, failures, records) -> None:
    """Flash attention against its plain version over FLASH_CASES in f32
    and bf16, the Function's gradients against autograd of the plain
    version, then the timed record at the training phase's shape (f32,
    causal), and for reference the same shape in bf16, a 64-token window
    at D 80 and L 2048."""
    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        for case, (B, H, KVH, Lq, Lkv, D, w) in FLASH_CASES.items():
            q, k, v = flash_case(gen, dtype, B, H, KVH, Lq, Lkv, D)
            err, ok = compare(fa.flash_attention(q, k, v, window=w),
                              fa.flash_attention_plain(q, k, v, window=w),
                              dtype)
            torch.cuda.synchronize()
            log(f"  {'flash_attention':30s} {str(dtype):15s} {case:24s} "
                f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("flash_attention", str(dtype), case))

    for case in ("granite B2 L512", "D80 window 64"):
        B, H, KVH, Lq, Lkv, D, w = FLASH_CASES[case]
        base = flash_case(gen, torch.float32, B, H, KVH, Lq, Lkv, D)
        cot = torch.randn(base[0].shape, generator=gen, device="cuda")
        grads = []
        for fn in (fa.flash_attention, fa.flash_attention_plain):
            ts = [t.clone().requires_grad_() for t in base]
            (fn(*ts, window=w) * cot).sum().backward()
            grads.append([t.grad for t in ts])
        errs = [compare(a, b, torch.float32) for a, b in zip(*grads)]
        ok = all(o for _, o in errs)
        log(f"  flash_attention gradients (dq, dk, dv) {case}: max_abs_err "
            f"{[f'{e:.3e}' for e, _ in errs]} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(("flash_attention", "gradients", case))

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype, esize, case in ((torch.float32, 4, "granite B2 L512"),
                               (torch.bfloat16, 2, "granite B2 L512"),
                               (torch.float32, 4, "D80 window 64"),
                               (torch.float32, 4, "L2048")):
        B, H, KVH, L, _, D, w = FLASH_CASES[case]
        q, k, v = flash_case(gen, dtype, B, H, KVH, L, L, D)
        err, ok = compare(fa.flash_attention(q, k, v, window=w),
                          fa.flash_attention_plain(q, k, v, window=w), dtype)
        if not ok:
            failures.append(("flash_attention", str(dtype), "timed " + case))
        if w is None:
            library = (lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        else:
            mask = fa.visible_keys(L, L, True, w, "cuda")
            library = (lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True))
        # each input read once, the output written once; 4 flops per
        # (query head, visible key, dimension): L(L+1)/2 visible pairs when
        # causal, min(i + 1, w) for query i under a window
        pairs = sum(min(i + 1, w or L) for i in range(L))
        nbytes = esize * D * L * B * (2 * H + 2 * KVH)
        flops = 4.0 * B * H * D * pairs
        bound_ms, by = bound(nbytes, flops, dtype)
        rec = {"max_abs_err": err,
               "ms": time_ms(lambda: fa.flash_attention(q, k, v, window=w)),
               "plain_ms": time_ms(
                   lambda: fa.flash_attention_plain(q, k, v, window=w)),
               "bound_ms": bound_ms, "bound_by": by,
               "library_ms": time_ms(library)}
        label = f"{case} {str(dtype).replace('torch.', '')}"
        cores = ""
        if dtype == torch.float32:
            cores_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / F32_CUDA_CORE_FLOPS) * 1e3
            cores = (f"; bound at the CUDA cores' f32 rate (67 TFLOP/s) "
                     f"{cores_ms:.6f} ms")
        log(f"  flash_attention {label}: " + json.dumps(rec) + cores)
        if dtype == torch.float32 and case == "granite B2 L512":
            records["flash_attention"] = rec     # the training phase's shape


# (B, L, H, P, G, N, chunk) of the SSD scan cases: the JAX kernel tests'
# shapes (G > 1 in the third), mamba2-130m's serving prefill (a prompt of
# up to 64 tokens pads to one chunk), a long prefill, a batch, and
# zamba2's SSM widths
SSD_CASES = {
    "(1,64,2,16,1,8,16)": (1, 64, 2, 16, 1, 8, 16),
    "(2,128,4,32,2,16,32)": (2, 128, 4, 32, 2, 16, 32),
    "groups (1,32,8,8,4,4,8)": (1, 32, 8, 8, 4, 4, 8),
    "mamba2 B1 L64": (1, 64, 24, 64, 1, 128, 64),
    "mamba2 B1 L512": (1, 512, 24, 64, 1, 128, 64),
    "mamba2 B1 L2048": (1, 2048, 24, 64, 1, 128, 64),
    "mamba2 B4 L512": (4, 512, 24, 64, 1, 128, 64),
    "zamba2 widths L256": (1, 256, 64, 64, 1, 64, 64),
}


def ssd_case(gen, dtype, B, L, H, P, G, N):
    """x, dt, A, Bm, Cm and an initial state: x, B and C in ``dtype``, the
    rest float32 (dt a softplus output, small as the model's, whose dt_bias
    puts it near 1e-3 .. 1e-1, so the state carries across chunks; A
    negative)."""
    def randn(shape, dt=dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    f32 = torch.float32
    return (randn((B, L, H, P)),
            torch.nn.functional.softplus(randn((B, L, H), f32) - 3),
            -torch.exp(randn((H,), f32)), randn((B, L, G, N)),
            randn((B, L, G, N)), randn((B, H, N, P), f32))


def ssd_bound(dtype, B, L, H, P, G, N, Q, esize) -> tuple:
    """Each input read once and each output written once (x, y, B, C in
    ``esize`` bytes; dt, A and the two states f32), and the products'
    flops: per chunk C.B^T over the visible half (j <= i), once per group,
    and per head the masked form times x, C times the state and the state
    update."""
    nbytes = (2 * B * L * H * P * esize + 2 * B * L * G * N * esize
              + 4 * (B * L * H + H) + 2 * 4 * B * H * N * P)
    half = Q * (Q + 1) / 2
    flops = B * (L // Q) * (G * 2 * half * N
                            + H * (2 * half * P + 4 * Q * N * P))
    return bound(nbytes, flops, dtype)


def ssd_phase(gen, failures, records) -> None:
    """The SSD scan against its plain version over SSD_CASES in f32 and
    bf16, with and without an initial state, the final state returned;
    then its time at the serving prefill's shape (bf16, the state in and
    out), the timed record, and for reference at longer prefills."""
    from repro_torch.kernels import ssd_scan as ss

    for dtype in (torch.float32, torch.bfloat16):
        for case, (B, L, H, P, G, N, Q) in SSD_CASES.items():
            x, dt, A, Bm, Cm, init = ssd_case(gen, dtype, B, L, H, P, G, N)
            for state in (None, init):
                y, h = ss.ssd_scan(x, dt, A, Bm, Cm, Q, state,
                                   return_state=True)
                want_y, want_h = ss.ssd_scan_plain(x, dt, A, Bm, Cm, Q,
                                                   state, return_state=True)
                err, ok = compare(y, want_y, dtype, tol=SSD_TOL)
                h_err, h_ok = compare(h, want_h, torch.float32, tol=SSD_TOL)
                torch.cuda.synchronize()
                label = f"{case} {'state in' if state is not None else ''}"
                log(f"  {'ssd_scan':30s} {str(dtype):15s} {label:32s} "
                    f"max_abs_err y {err:.3e} final state {h_err:.3e} "
                    f"{'ok' if ok and h_ok else 'FAIL'}")
                if not (ok and h_ok):
                    failures.append(("ssd_scan", str(dtype), label))

    dtype, esize = torch.bfloat16, 2
    for case in ("mamba2 B1 L64", "mamba2 B1 L512", "mamba2 B1 L2048",
                 "mamba2 B4 L512"):
        B, L, H, P, G, N, Q = SSD_CASES[case]
        x, dt, A, Bm, Cm, init = ssd_case(gen, dtype, B, L, H, P, G, N)
        args = (x, dt, A, Bm, Cm, Q, init)
        y, h = ss.ssd_scan(*args, return_state=True)
        want_y, want_h = ss.ssd_scan_plain(*args, return_state=True)
        err, ok = compare(y, want_y, dtype, tol=SSD_TOL)
        _, h_ok = compare(h, want_h, torch.float32, tol=SSD_TOL)
        if not (ok and h_ok):
            failures.append(("ssd_scan", str(dtype), "timed " + case))
        bound_ms, by = ssd_bound(dtype, B, L, H, P, G, N, Q, esize)
        rec = {"max_abs_err": err,
               "ms": time_ms(lambda: ss.ssd_scan(*args, return_state=True)),
               "plain_ms": time_ms(lambda: ss.ssd_scan_plain(
                   *args, return_state=True)),
               "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
        log(f"  ssd_scan {case} bf16, state in and out: " + json.dumps(rec)
            + f"; eager call with host dispatch "
            f"{eager_ms(lambda: ss.ssd_scan(*args, return_state=True)):.4f}"
            f" ms")
        if case == "mamba2 B1 L64":
            records["ssd_scan"] = rec            # the serve path's shape
    log("  ssd_scan: no single PyTorch call computes the chunked scan "
        "(library_ms null)")


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------

def serving_shapes() -> dict:
    """The attention shapes the serve phases give the kernels: every slot
    in each call, the engine's page pool and block table (paged), the
    cache's slots plus the sink column (dense), and the chunk bucket
    covering the workload's longest prompt (23 tokens)."""
    from repro_torch.launch import serve
    ecfg = serve.engine_config(SERVE_ARGS, torch.bfloat16)
    return {"B": ecfg.max_slots, "bs": ecfg.block_size,
            "nb": ecfg.max_blocks_per_seq(), "N": ecfg.resolved_kv_blocks(),
            "S1": ecfg.max_seq_len + 1,
            "C": next(b for b in ecfg.resolved_buckets() if b >= 23)}


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device, copy=True)


def _counting_prefill(model, counts: dict, name: str):
    """``model`` with its single-shot ``prefill`` (None for the dense
    transformer) counting its calls in ``counts[name]``."""
    if model.prefill is None:
        return model

    def prefill(*args):
        counts[name] = counts.get(name, 0) + 1
        return model.prefill(*args)
    return dataclasses.replace(model, prefill=prefill)


def serve_path(label, registry, backend, kernels, *, serve_all) -> dict:
    """One serving path through repro_torch.launch.serve's round-robin
    driver, launch counts set to 0 just before and read just after.
    ``kernels`` must have launched, every other kernel must not; with
    ``serve_all`` every request must be served.  Returns the counts."""
    from repro_torch.launch import serve

    args = argparse.Namespace(**{**vars(SERVE_ARGS), "backend": backend})
    names = list(registry)
    prefills = {}
    registry = {name: (_counting_prefill(model, prefills, name), params)
                for name, (model, params) in registry.items()}
    np.random.seed(0)                # calibrate_from_engine's prompts
    reset_launches()
    t0 = time.monotonic()
    stats, seen, engines = serve.run_round_robin(args, registry, names)
    launches = read_launches()
    wall = time.monotonic() - t0
    log(f"  [{label}] summarize: " + json.dumps(stats))
    st = engines[0].stats
    log(f"  [{label}] engine: {st.decode_iterations} decode steps in "
        f"{st.decode_time:.3f} s, {st.prefill_chunks} prefill chunk rounds "
        f"in {st.prefill_time:.3f} s, {st.model_swaps} swaps in "
        f"{st.swap_time:.3f} s (serving only, after calibration); wall "
        f"{wall:.1f} s (calibration included); kernel launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    check(len(seen) == 8, f"{label}: workload has {len(seen)} requests")
    check(all(r.finished() or r.dropped() for r in seen),
          f"{label}: a request is not terminal")
    check(stats["served"] >= 1 and stats["tokens"] > 0,
          f"{label}: nothing served: {stats}")
    check(not serve_all or stats["served"] == len(seen),
          f"{label}: served {stats['served']} of {len(seen)}")
    for r in seen:
        if r.output_tokens:
            vocab = registry[r.model][0].cfg.vocab_size
            check(len(r.output_tokens) == args.max_new_tokens
                  and all(0 <= t < vocab for t in r.output_tokens),
                  f"{label}: request {r.req_id} tokens {r.output_tokens}")
    check(all(e.block_mgr.used_blocks == 0 for e in engines),
          f"{label}: KV blocks leaked")
    check(all(launches[k] > 0 for k in kernels)
          and not any(n for k, n in launches.items() if k not in kernels),
          f"{label}: expected launches of {kernels} only, got {launches}")
    if "ssd_scan" in kernels:
        want = sum(registry[name][0].cfg.num_layers * n
                   for name, n in prefills.items())
        log(f"  [{label}] single-shot prefills {prefills} (calibration "
            f"included): ssd_scan launches {launches['ssd_scan']}, one per "
            f"layer and prefill = {want}")
        check(launches["ssd_scan"] == want,
              f"{label}: ssd_scan launches {launches['ssd_scan']} != {want}")
    if len(registry) > 1:
        check(stats["swaps"] >= 1, f"{label}: no model swap")
    return launches


def step_timings(registry) -> None:
    """Informational: one full-width decode step and one prefill chunk
    round at the serve phases' batch (8 slots, 40-token sequences, a
    32-token chunk bucket) on each path — device time from CUDA-graph
    replays against the time of the same call issued eagerly from
    Python."""
    shapes = serving_shapes()
    B, nb, N, bs, C = (shapes[k] for k in ("B", "nb", "N", "bs", "C"))
    bt = torch.arange(B * nb, dtype=torch.int32, device="cuda").reshape(B, nb)
    tokens = torch.arange(B, dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), 40, dtype=torch.int32, device="cuda")
    chunk = torch.arange(B * C, dtype=torch.int32, device="cuda").reshape(B, C)
    starts = torch.zeros(B, dtype=torch.int32, device="cuda")
    valid = torch.full((B,), 20, dtype=torch.int32, device="cuda")
    for label, (model, params), paged in registry:
        if paged:
            cache = model.init_paged_cache(N, bs, torch.bfloat16, "cuda")
            steps = (("decode step", lambda: model.decode_step_paged(
                params, cache, tokens, lengths, bt)),
                ("prefill chunk round", lambda: model.prefill_chunk_paged(
                    params, cache, chunk, starts, valid, bt)))
        else:
            cache = model.init_cache(B, shapes["S1"] - 1, torch.bfloat16,
                                     "cuda")
            steps = (("decode step", lambda: model.decode_step(
                params, cache, tokens, lengths)),
                ("prefill chunk round", lambda: model.prefill_chunk(
                    params, cache, chunk, starts, valid)))
        for name, fn in steps:
            device = time_ms(fn, iters=5, replays=4)
            eager = eager_ms(fn, iters=10)
            log(f"  {label} {name}: device {device:.3f} ms, eager "
                f"{eager:.3f} ms, host share {1 - device / eager:.3f}")
        del cache
        torch.cuda.empty_cache()


def long_step_timings(model, params) -> None:
    """Informational: one full-width decode step at 8 slots x 4096 tokens
    of context (each slot attends 4096 keys), on the page pool and on the
    dense cache, device time from CUDA-graph replays against the eager
    call.  The caches (2.7 GB each in bf16) are filled with random values
    directly, so no 4096-token prefill runs."""
    B, L, bs = 8, 4096, 16
    nb = L // bs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    tokens = torch.arange(B, dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), L - 1, dtype=torch.int32, device="cuda")
    bt = torch.arange(B * nb, dtype=torch.int32, device="cuda").reshape(B, nb)
    for label, make, step in (
            ("page pool", lambda: model.init_paged_cache(
                B * nb, bs, torch.bfloat16, "cuda"),
             lambda c: model.decode_step_paged(params, c, tokens, lengths,
                                               bt)),
            ("dense", lambda: model.init_cache(B, L, torch.bfloat16, "cuda"),
             lambda c: model.decode_step(params, c, tokens, lengths))):
        cache = make()
        for leaf in cache.values():
            leaf.normal_(generator=gen)
        device = time_ms(lambda: step(cache), iters=3, replays=3)
        eager = eager_ms(lambda: step(cache), iters=5)
        log(f"  granite {label} decode step, 8 slots x {L} tokens of "
            f"context: device {device:.3f} ms, eager {eager:.3f} ms, host "
            f"share {1 - device / eager:.3f}")
        del cache
        torch.cuda.empty_cache()


def ssm_step_timings(model, params) -> None:
    """Informational, mamba2: one full-width decode step at the serve
    phases' 8 slots and one single-shot prefill of 64 and of 512 tokens
    (batch 1, from a fresh state, as the engine admits), device time from
    CUDA-graph replays against the eager call; and the launches of one
    prefill (one ``ssd_scan`` per layer) and of one decode step (none)."""
    from repro_torch.kernels import ssd_scan as ss

    B = serving_shapes()["B"]
    vocab = model.cfg.vocab_size
    cache = model.init_cache(B, 128, torch.bfloat16, "cuda")
    tokens = torch.arange(B, dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), 40, dtype=torch.int32, device="cuda")
    steps = [("decode step, 8 slots", lambda: model.decode_step(
        params, cache, tokens, lengths))]
    for L in (64, 512):
        cache1 = model.init_cache(1, 128, torch.bfloat16, "cuda")
        batch = {"tokens": torch.arange(L, dtype=torch.int32,
                                        device="cuda")[None] % vocab}
        steps.append((f"single-shot prefill of {L} tokens",
                      lambda batch=batch, cache1=cache1: model.prefill(
                          params, batch, cache1)))
    reset_launches()
    steps[1][1]()
    per_prefill = ss.launches
    steps[0][1]()
    torch.cuda.synchronize()
    log(f"  mamba2-130m ssd_scan launches: one prefill {per_prefill}, then "
        f"one decode step {ss.launches - per_prefill}")
    check(per_prefill == model.cfg.num_layers and ss.launches == per_prefill,
          f"ssd_scan launches per prefill {per_prefill}, decode "
          f"{ss.launches - per_prefill}")
    for name, fn in steps:
        device = time_ms(fn, iters=5, replays=4)
        eager = eager_ms(fn, iters=10)
        log(f"  mamba2-130m {name}: device {device:.3f} ms, eager "
            f"{eager:.3f} ms, host share {1 - device / eager:.3f}")


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


LOGIT_TOL = 1e-3


def _recording(model, calls):
    """``model`` with every serving path appending its logits (on the
    CPU, in f32) to ``calls``."""
    def rec(fn):
        def run(*args):
            logits, cache = fn(*args)
            calls.append(logits.detach().float().cpu())
            return logits, cache
        return run
    return dataclasses.replace(model, **{
        name: rec(getattr(model, name)) for name in (
            "prefill", "prefill_chunk", "decode_step", "prefill_chunk_paged",
            "decode_step_paged") if getattr(model, name) is not None})


def near_tie_parting(label, cuda_calls, cpu_calls):
    """Walk the two runs' logits call by call (the calls line up while the
    token streams agree).  Logits must agree within LOGIT_TOL; an argmax
    may differ only where the CPU's two best logits lie within LOGIT_TOL
    (a near tie); once the logits part by more than LOGIT_TOL, such a flip
    must have come first.  Returns (call, row, CPU top-2 gap, max |logit
    difference| so far) of the first flip, or None."""
    flip, worst = None, 0.0
    for i, (a, b) in enumerate(zip(cuda_calls, cpu_calls)):
        diff = float((a - b).abs().max())
        if diff > LOGIT_TOL:
            check(flip is not None, f"{label}: logits parted at call {i} "
                                    f"(max diff {diff:.3e}) with no near tie")
            break
        worst = max(worst, diff)
        for r in (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist():
            top2 = b[r].topk(2).values
            gap = float(top2[0] - top2[1])
            check(gap <= LOGIT_TOL, f"{label}: call {i} row {r}: argmax "
                                    f"differs with a CPU top-2 gap of {gap}")
            flip = flip or (i, r, gap, worst)
    return flip


def reference_phase() -> None:
    """The CUDA path against the plain path on the CPU, same weights: on
    the page pool in float and int8, and on the dense backend for granite,
    for rolling-window h2o-danube (prompts up to 84 tokens, window 64) and
    for mamba2 (single-shot prefill through the SSD kernel).  Attention
    runs in float must give identical tokens; mamba2's may part only at a
    near tie, as an int8 run may.  An int8 run may part
    from the CPU's at a near tie: the two devices' f32 projections differ
    in the last bits, which can put one value on the other side of an int8
    rounding boundary, a one-step change that moves the logits by ~1e-4;
    so its logits must agree within LOGIT_TOL up to the parting, and a
    token may differ only where the CPU's two best logits lie within
    LOGIT_TOL (``near_tie_parting``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.request import Request
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    small = dict(num_layers=2, d_model=256, num_heads=8, num_kv_heads=2)
    granite = get_arch(GRANITE).reduced(**small)
    danube = get_arch(DANUBE).reduced(**small)
    mamba = get_arch(MAMBA).reduced(num_layers=2, d_model=256)
    check(danube.sliding_window == 64, "reduced h2o-danube window")
    rng = np.random.default_rng(2)
    common = rng.integers(0, 100, size=24).tolist()
    prompts = [common + rng.integers(0, 100, size=n).tolist()
               for n in (5, 60, 1, 17)] + [rng.integers(0, 100, 9).tolist()]
    for label, cfg, backend in (
            ("granite, page pool", granite, "paged-cuda"),
            ("granite, int8 pages", dataclasses.replace(granite,
                                                        kv_quant=True),
             "paged-cuda"),
            ("granite, dense", granite, "cuda"),
            ("h2o-danube, dense rolling window", danube, "cuda"),
            ("mamba2, dense single-shot prefill", mamba, "cuda")):
        model = build_model(cfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        params = model.init(gen, torch.float32, "cuda")
        outs = []
        for device, p in (("cuda", params),
                          ("cpu", _to_device(params, "cpu"))):
            calls = []
            eng = ContinuousBatchingEngine(
                _recording(model, calls), p, EngineConfig(
                    max_slots=4, max_seq_len=128, block_size=8,
                    prefill_chunk_tokens=16, decode_burst=4, device=device,
                    attention_backend=backend, debug_invariants=True),
                model_name="m")
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
                  f"{label} on {device}: reference trace did not finish")
            outs.append(([r.output_tokens for r in reqs], eng.stats, calls))
        (got, gs, g_calls), (want, ws, w_calls) = outs
        flip = near_tie_parting(label, g_calls, w_calls)
        log(f"  {label}: cuda tokens == cpu tokens: {got == want}; first "
            f"near-tie flip (call, row, cpu top-2 gap, max |logit diff| "
            f"before it): {flip}; prefix_hits {gs.prefix_hits}/"
            f"{ws.prefix_hits}, resumes {gs.resumes}/{ws.resumes}")
        check(got == want or ((cfg.kv_quant or cfg.arch_type == "ssm")
                              and flip is not None),
              f"{label}: cuda {got} != cpu {want}")
        check(gs.resumes >= 1, f"{label}: the trace missed the resume")
        check(backend == "cuda" or gs.prefix_hits >= 1,
              f"{label}: the trace missed prefix sharing")


def _train_args(arch, steps, *extra):
    from repro_torch.launch import train as train_cli
    return train_cli.parse_args(["--arch", arch, "--steps", str(steps),
                                 "--log-every", "1", *extra])


def _train(cfg, args, params=None) -> tuple:
    """``launch.train.train`` with the launch counts set to 0 just before
    and read just after; returns (result, counts)."""
    from repro_torch.launch import train as train_cli
    reset_launches()
    result = train_cli.train(cfg, args, params)
    counts = read_launches()
    torch.cuda.synchronize()
    return result, counts


def training_phase() -> int:
    """Full-width training through the flash kernel (f32, remat): 3
    granite-3-2b steps, one step with the flag off from the same weights
    and batch, one h2o-danube-1.8b step.  Returns granite's flash
    launches."""
    from repro_torch.configs import get_arch

    granite = get_arch(GRANITE)
    args = _train_args(GRANITE, 3, "--full", "--batch", "2", "--seq", "512")
    # the serve phases' engines sit in reference cycles (engine, agent,
    # controller) that hold both models' weights until a collection
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  memory allocated before training: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    res, counts = _train(dataclasses.replace(granite,
                                             use_pallas_attention=True), args)
    peak = torch.cuda.max_memory_allocated()
    launches = counts["flash_attention"]
    want = granite.num_layers * 2 * args.steps
    log(f"  granite-3-2b f32 B=2 L=512, flag on: losses {res['losses']}, "
        f"grad norms {res['grad_norms']}, step times (s, host clock, loss "
        f"read back) {res['step_s']}, peak memory "
        f"{peak / 2**30:.2f} GiB; flash launches {launches} (expected "
        f"{granite.num_layers} layers x 2 (forward + remat recompute) x "
        f"{args.steps} steps = {want})")
    check(all(np.isfinite(res["losses"])), f"non-finite loss {res}")
    check(launches == want, f"flash launches {launches} != {want}")
    check(not any(n for k, n in counts.items() if k != "flash_attention"),
          f"serving kernels launched in training: {counts}")

    off, off_counts = _train(granite,
                             argparse.Namespace(**{**vars(args), "steps": 1}))
    log(f"  granite-3-2b flag off, step 0: loss {off['losses'][0]} (flag on "
        f"{res['losses'][0]}), grad norm {off['grad_norms'][0]} (flag on "
        f"{res['grad_norms'][0]}), step time {off['step_s'][0]} s")
    check(off_counts["flash_attention"] == 0, "flag off launched the kernel")
    check(abs(off["losses"][0] - res["losses"][0])
          <= 1e-4 * abs(off["losses"][0]), "step-0 loss: flag on != off")
    check(abs(off["grad_norms"][0] - res["grad_norms"][0])
          <= 1e-3 * abs(off["grad_norms"][0]), "grad norm: flag on != off")

    danube = dataclasses.replace(get_arch(DANUBE), use_pallas_attention=True)
    d_args = _train_args(DANUBE, 1, "--full", "--batch", "2", "--seq", "512")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    d_res, d_counts = _train(danube, d_args)
    log(f"  h2o-danube-1.8b f32 B=2 L=512, flag on: loss {d_res['losses']}, "
        f"step time {d_res['step_s']} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
        f"launches {d_counts['flash_attention']}")
    check(np.isfinite(d_res["losses"][0]), "h2o-danube loss not finite")
    check(d_counts["flash_attention"] == danube.num_layers * 2,
          f"h2o-danube flash launches {d_counts}")
    return launches


def training_reference_phase() -> None:
    """Reduced granite and h2o-danube (window 64, seq 128) trained 3 steps
    on the card (the flash kernel) and on the CPU (its plain version) from
    the same weights and data: losses and final params within 1e-4."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_leaves

    small = dict(num_layers=2, d_model=256, num_heads=8, num_kv_heads=2)
    for name in (GRANITE, DANUBE):
        cfg = dataclasses.replace(get_arch(name).reduced(**small),
                                  use_pallas_attention=True)
        gen = torch.Generator()
        gen.manual_seed(4)
        cpu_params = build_model(cfg).init(gen, torch.float32, "cpu")
        cuda_params = _to_device(cpu_params, "cuda")
        results = []
        for device, params in (("cuda", cuda_params), ("cpu", cpu_params)):
            args = _train_args(name, 3, "--batch", "4", "--seq", "128",
                               "--device", device)
            results.append(_train(cfg, args, params))
        (got, counts), (want, _) = results
        diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves(cuda_params), tree_leaves(cpu_params)))
        ok_params = all(torch.allclose(a.cpu(), b, atol=1e-4, rtol=1e-4)
                        for a, b in zip(tree_leaves(cuda_params),
                                        tree_leaves(cpu_params)))
        log(f"  {name} reduced (window {cfg.sliding_window}): cuda losses "
            f"{got['losses']}, cpu {want['losses']}; max |param diff| "
            f"{diff:.3e}; flash launches {counts['flash_attention']}")
        check(counts["flash_attention"] == cfg.num_layers * 2 * 3,
              f"{name}: flash launches {counts}")
        check(np.allclose(got["losses"], want["losses"], atol=1e-4,
                          rtol=1e-4), f"{name}: losses part")
        check(ok_params, f"{name}: params part by {diff}")


def decode_timings(src: Path) -> int:
    """``--decode-timings [SRC]``: only the float decode kernels and the
    granite decode steps, with the ``repro_torch`` package under ``SRC``
    (default: this checkout's ``src``), so that another tree's kernels
    (a ``git archive`` of a parent commit) are timed by the same code in
    the same call.  Each kernel against its plain version, then its device
    time and SDPA's at the serving shape and at 8 x 4096 (bf16), then the
    full-width granite decode step at 40 and at 4096 tokens of context, on
    the page pool and the dense cache.  The last line is the records'
    JSON."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    log(f"[decode-timings] repro_torch from {src}")
    build.build(["paged_decode_attention", "decode_attention"])
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = serving_shapes()
    dtype, failures, records = torch.bfloat16, [], {}
    serve_lengths = rng.integers(5, 41, size=shapes["B"]).tolist()
    for label, lengths, nb, S in (
            ("serving", serve_lengths, shapes["nb"], shapes["S1"]),
            ("8 x 4096", [4096] * 8, 256, 4096)):
        for name in FLOAT_DECODE:
            args = (decode_case(rng, gen, dtype, lengths, nb=nb,
                                N=max(len(lengths) * nb, shapes["N"]))
                    if name == "paged_decode_attention"
                    else dense_case(rng, gen, dtype, lengths, S))
            err = check_case(failures, name, dtype, label, args)
            fn, _ = kernel_fns(name)
            records[f"{name} {label}"] = {
                "ms": time_ms(lambda: fn(*args)),
                "library_ms": time_ms(decode_library(name, args)),
                "splits": decode_splits(name, args), "max_abs_err": err}
            log(f"  {name} {label}: " + json.dumps(records[f"{name} {label}"]))
    check(not failures, f"kernels disagree with their plain versions: "
                        f"{failures}")
    cfg = get_arch(GRANITE)
    gen.manual_seed(0)
    model = build_model(cfg)
    params = model.init(gen, torch.bfloat16, "cuda")
    step_timings((("granite paged", (model, params), True),
                  ("granite dense", (model, params), False)))
    long_step_timings(model, params)
    print(json.dumps(records), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--decode-timings"]:
        return decode_timings(Path(sys.argv[2]) if len(sys.argv) > 2
                              else ROOT / "src")
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
    log(f"[build] {len(build.SOURCES)} CUDA sources in "
        f"{time.monotonic() - t0:.1f} s")
    kernel_resources()

    t0 = time.monotonic()
    models = {}
    for seed, name in enumerate((GRANITE, DANUBE)):
        cfg = get_arch(name)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        model = build_model(cfg)
        params = model.init(gen, torch.bfloat16, "cuda")
        quant = build_model(dataclasses.replace(cfg, kv_quant=True))
        models[name] = (model, quant, params)
        log(f"[init] {cfg.name}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, head_dim {cfg.resolved_head_dim}, window "
            f"{cfg.sliding_window}, "
            f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params "
            f"bf16")
    m_cfg = get_arch(MAMBA)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    m_model = build_model(m_cfg)
    m_params = m_model.init(gen, torch.bfloat16, "cuda")
    log(f"[init] {m_cfg.name}: {m_cfg.num_layers} layers, d_model "
        f"{m_cfg.d_model}, {m_cfg.ssm.num_heads(m_cfg.d_model)} SSD heads of "
        f"{m_cfg.ssm.head_dim}, d_state {m_cfg.ssm.d_state}, chunk "
        f"{m_cfg.ssm.chunk_size}, "
        f"{sum(t.numel() for t in _leaves(m_params)) / 1e9:.3f} B params "
        f"bf16")
    torch.cuda.synchronize()
    log(f"[init] in {time.monotonic() - t0:.1f} s")
    (g_model, g_quant, g_params), (d_model, d_quant, d_params) = \
        models[GRANITE], models[DANUBE]

    log("[kernels] against their plain versions")
    t0 = time.monotonic()
    timings, failures = kernel_phase(serving_shapes())
    check(not failures, f"kernels disagree with their plain versions: "
                        f"{failures}")
    log(f"[kernels] ok in {time.monotonic() - t0:.1f} s")

    launches = {}
    for label, registry, backend, kernels in (
            ("paged", {GRANITE: (g_model, g_params)}, "paged-cuda",
             ("paged_decode_attention", "paged_prefill_attention")),
            ("paged int8", {GRANITE: (g_quant, g_params)}, "paged-cuda",
             ("paged_decode_attention_quant",
              "paged_prefill_attention_quant")),
            ("dense swap", {GRANITE: (g_model, g_params),
                            DANUBE: (d_model, d_params)}, "cuda",
             ("decode_attention",)),
            ("dense int8 swap", {GRANITE: (g_quant, g_params),
                                 DANUBE: (d_quant, d_params)}, "cuda",
             ("decode_attention_quant",)),
            ("mamba2", {MAMBA: (m_model, m_params)}, "cuda", ("ssd_scan",)),
            ("dense granite + mamba2 swap", {GRANITE: (g_model, g_params),
                                             MAMBA: (m_model, m_params)},
             "cuda", ("decode_attention", "ssd_scan"))):
        log(f"[serve] {label}: {list(registry)} on {backend}")
        t0 = time.monotonic()
        counts = serve_path(label, registry, backend, kernels,
                            serve_all=label != "paged")
        # each kernel's record keeps the count of the first path that runs it
        for k in kernels:
            launches.setdefault(k, counts[k])
        log(f"[serve] {label} ok in {time.monotonic() - t0:.1f} s")

    log("[step] full-width step times, device vs eager")
    t0 = time.monotonic()
    step_timings((
        ("granite paged", (g_model, g_params), True),
        ("granite paged int8", (g_quant, g_params), True),
        ("granite dense", (g_model, g_params), False),
        ("granite dense int8", (g_quant, g_params), False),
        ("h2o-danube dense", (d_model, d_params), False)))
    long_step_timings(g_model, g_params)
    ssm_step_timings(m_model, m_params)
    log(f"[step] in {time.monotonic() - t0:.1f} s")

    log("[long-prompt] 64-token chunks, prefix sharing, COW")
    t0 = time.monotonic()
    long_prompt_phase(g_model, g_params)
    log(f"[long-prompt] ok in {time.monotonic() - t0:.1f} s")
    # the serve loop's last registry holds both models' weights too
    del models, registry, g_params, d_params, m_params
    torch.cuda.empty_cache()

    log("[reference] cuda engine vs cpu engine, reduced models, float32")
    t0 = time.monotonic()
    reference_phase()
    log(f"[reference] ok in {time.monotonic() - t0:.1f} s")

    log("[train] full width, float32, use_pallas_attention")
    t0 = time.monotonic()
    launches["flash_attention"] = training_phase()
    log(f"[train] ok in {time.monotonic() - t0:.1f} s")

    log("[train-reference] cuda vs cpu training, reduced models, float32")
    t0 = time.monotonic()
    training_reference_phase()
    log(f"[train-reference] ok in {time.monotonic() - t0:.1f} s")

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": launches[name], **timings[name],
    } for name, (_, _, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
