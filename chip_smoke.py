"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-timings [SRC]
    python3 chip_smoke.py --kernel-timings [SRC]

The second form times only the decode kernels, float and int8, and the
granite decode steps (``decode_timings``); the third the paged prefill
kernels, float and int8, the SSD scan, the granite page-pool chunk rounds
and mamba2's single-shot prefills (``kernel_timings``); both with the
package under SRC, so that a parent commit's kernels can be timed beside
this one's in one call.

Phases, in order; any failure exits non-zero before the result lines:

  1. require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, started together); print one line per library with
     ``ptxas``'s registers, spill bytes and static shared memory of each of
     its kernels, and one with the count of tensor-core instructions
     (``HMMA``/``HGMMA``) in its SASS (``cuobjdump -sass``): the paged
     prefill, flash, paged / dense decode and SSD kernels must hold them,
     or the run fails; every kernel of the two decode libraries must be a
     split-KV ``decode_mma_kernel`` (int8 instances among them), every
     kernel of the prefill library a ``prefill_mma_kernel`` (int8
     instances among them), every flash kernel a ``flash_mma_kernel`` and
     every SSD kernel an ``ssd_mma_kernel``, each with tensor-core
     instructions and no spill bytes;
  2b. lint phase (``lint_phase``): the port's lint
     (``repro_torch.analysis.lint``) over ``src/repro_torch`` with
     ``qlint_baseline.json`` must give 0 findings, and its
     ``--self-test`` must pass; then a probe of its blocking-upload rule:
     with ~50 ms of bf16 products queued, a blocking ``torch.tensor(a,
     device="cuda")``, the same copy from pinned memory with
     ``non_blocking=True`` and the engine's ``_to_device``, each timed on
     the host clock and printed; the run fails if the rule flags blocking
     uploads and they did not wait (or the reverse), or if a pinned
     non-blocking copy waited;
  3. kernel phase: the six serving kernels (paged decode, paged prefill,
     dense decode, each in float and int8-KV form) against their plain
     PyTorch versions on the card, in float32 and bfloat16, at granite-3-2b's
     widths (32 query heads, 8 KV heads, head_dim 64, 16-token pages) and
     at h2o-danube's head_dim 80: sentinel table entries, lengths 0/1/page
     edges/the full slot, prefill chunks that start past a page edge,
     ``valid == 0`` rows, chunks of 128 and 512, long context (lengths up
     to 4096), and the serve phases' own shapes (8 slots, the page pool and
     table or the 128-column dense cache, 16- and
     32-token chunk buckets with free slots among live rows).  Every case
     that disagrees is a failure.  Then time kernel, plain version and the
     library call (``scaled_dot_product_attention`` over the gathered or
     length-masked KV; none computes an int8 twin in one call, so its
     ``library_ms`` is null and the dequantize-then-SDPA time is printed
     beside it) at the serving shapes (device time, from CUDA-graph
     replays), beside the bound, and each kernel once more at long context
     (the float decode kernels also beside SDPA over the gathered or
     length-masked KV, the int8 ones beside the two calls that gather,
     dequantize and run SDPA, each with its split count; the float
     prefill also
     beside SDPA over the gathered prefix plus the chunk, the int8 one
     beside the two calls that gather and dequantize the prefix and run
     SDPA over it and the chunk, and the float one at one chunk
     round of a single long prompt: B 1, 128 queries over a 4096-token
     prefix).
     Then flash attention in f32 and bf16 at granite's widths (B 2, 32
     heads on 8, D 64, L 512), h2o-danube's D 80 with windows 8, 17 and
     64, the JAX tests' ragged cases (Lq 33 on Lkv 65, L 100) and L 2048;
     its autograd Function's gradients against autograd of the plain
     version (f32, 1e-4; the backward recomputes the plain version and
     never reads the kernel's output, so this holds the Function's
     wiring, not the kernel, whose gradient ``[train-reference]``'s
     card-against-CPU parameters hold); and its time at the training phase's shape (f32)
     beside its bound (the visible half of the causal square; f32 at the
     3xTF32 rate, with the CUDA-core rate's bound beside it) and
     ``scaled_dot_product_attention``, and, for reference, in bf16, with
     a 64-token window (SDPA with a boolean mask) and at L 2048; then
     at each training call of the ``[train]`` phase (f32: granite,
     zamba2's sites, whisper's decoder, qwen3-moe, llava over 3392
     positions) the Function's forward against the plain version's and
     its gradients against autograd of it (the wiring, as above), and its
     kernel, plain version, SDPA and backward (eager)
     times beside its bound.  Then
     the SSD scan in f32 and bf16 (dt, A and the states f32), with and
     without an initial state, its final state returned, on the JAX
     tests' shapes (G > 1 among them), mamba2-130m's serving prefill (B 1,
     L 64, 24 heads of 64, N 128), L 2048, B 4 L 512 and zamba2's widths
     (64 heads, N 64) at chunk 64 and 128; f32 within 5e-4, the JAX
     kernel test's tolerance;
     the f32 error at L 2048 printed on its own line; and its time at the
     serving prefill's shape (bf16, with the state in
     and out, as the engine calls it) beside its bound and the plain
     version (no single PyTorch call computes the scan: ``library_ms``
     null), and for reference at L 512, L 2048 and B 4 L 512; then at
     the training phase's calls (f32, B 2, L 512: mamba2's 24 heads of 64
     at N 128, zamba2's 64 at N 64) the autograd Function's forward
     against the plain version and its gradients against autograd of it
     (the Function's wiring, as flash's: cotangents, the final state
     without one, which inputs get a gradient), and its kernel,
     plain version and backward (eager) times beside its bound;
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
     tokens of context, page pool and dense, float and int8; for mamba2 one
     decode step at
     8 slots and one
     single-shot prefill of 64 and of 512 tokens, with the launch count
     of one prefill (one per layer) and of one decode step (none);
  6. long-prompt phase: one full-width engine with 64-token chunks serves
     a 300-token prompt and a second one sharing its first 256 tokens (a
     prefix hit: prefill chunks start past the shared pages), plus a
     copy-on-write page copy of a forked tail block; then ``fork_slot``
     clones a running decode: no page copied at the fork, exactly one
     copy-on-write copy at the next dispatch, the clone's tokens equal to
     the source's;
  7. drivers phase, on the same full-width granite-3-2b (bf16,
     ``paged-cuda``), each part with the launch counts set to 0 just
     before and read just after (the two float paged kernels, and no
     other, must launch): a. ``AsyncServer`` over ``async_serve``'s
     cluster of two engines sharing the weights, 32 requests of the
     three classes at 8/s plus 4 sessions of 3 turns, queue depth 16,
     shedding by deferral, one client cancelling mid-decode: every
     request terminal, every stream carrying its request's tokens, no
     page leaked, a prefix hit; attainment and TTFT p50/p99 per class,
     rejections, sheds and cancellations printed; b. ``serve.run_threaded``
     against ``serve.run_round_robin`` on one seed, two engines each:
     every request terminal, no page leaked, tokens/s of each, tokens
     equal across them; c. ``chaos`` ``combined`` (3 engines, virtual
     clock) with ``check_soak``'s no-fault baseline and replay: the
     planned hang and crash landed, nothing stranded or leaked on any
     engine, the dead and replaced ones included, at least one
     replacement and one migration, an identical replay, interactive
     attainment at least 0.5, ``memory_allocated`` before and after
     printed.  Tokens may part between two runs only at a near tie: the
     two tokens the best two of the logits recomputed alone, within the
     bf16 tolerance (``check_partings``, printed with the gap);
  7b. sim phase (``sim_phase``): a. the two-group swap and the head-change
     eviction scenarios of ``tests/test_torch_sim_engine_agreement.py`` on
     full-width granite-3-2b and h2o-danube-1.8b (one dense engine, the
     tests' fixed profiles) and in the port's ``ClusterSimulator``: equal
     admission, eviction and swap counts, only the dense decode kernel
     launched; b. granite calibrated on the page pool by
     ``calibrate_from_engine``, one engine serving the ``[drivers]`` mix
     (32 requests at 8/s, three classes) under the controller and agent,
     and the simulator on the same trace with that profile: per class
     the simulated against the served TTFT p50/p99 and completion p50
     with their ratio, recorded, not gated (both must finish every
     request); c. ``repro_torch.launch.slo_benchmark`` at 200 requests, a
     simulation over the paper's A100 profiles, not a measurement;
  7c. dense-family phase: qwen1.5-32b (40 heads on 40, QKV bias) and
     deepseek-67b (64 heads on 8) at full width with ``DENSE_FAMILY_LAYERS``
     layers, bf16, one after the other: the page-pool decode and prefill
     and the dense decode kernels (deepseek's int8 twins too) against their
     plain versions at the runs' shapes (head_dim 128, groups 1 and 8) and
     timed; 8 requests through chunked prefill on the page pool and 8
     through the single-shot prefill on the dense backend, each kernel
     launched exactly once a layer per decode step and chunk round and no
     other, tokens equal or parting only at near ties; deepseek with int8
     KV on both layouts;
  7d. MoE/VLM phase (``moe_vlm_phase``): qwen3-moe-30b-a3b whole (48
     layers, 128 experts top 8, 32 heads on 4), dbrx-132b (48 heads on 8,
     16 experts top 4) cut to ``MOE_VLM_LAYERS`` of its 40 layers and
     llava-next-34b (56 heads on 8, 2880 patch tokens) cut to 48 of 60,
     full width, bf16, one after the other: the attention kernels against
     their plain versions at their shapes (groups 8, 6 and 7, head_dim
     128; dbrx's int8 twins too; llava's dense decode over a 3009-column
     cache) and timed; qwen3-moe's 8 requests chunked on the page pool
     twice (bitwise equal tokens) and single-shot on the dense backend
     (the partings printed, not gated: capacity-bounded routing depends
     on the tokens routed together), its decode step's device and eager
     time beside its weight-read bound; dbrx's on float and int8 pages,
     its decode step timed too; llava's 4 requests with random patch
     embeddings through ``admit(..., extras=...)`` on the dense backend,
     and the page pool's refusal of them; launches exactly one a layer
     per decode step and chunk round, no other kernel;
  7e. hybrid/enc-dec phase (``hybrid_encdec_phase``): zamba2-1.2b (38
     mamba2 layers, the shared attention block at 6 sites, 32 heads on
     32) and whisper-medium (24 encoder and 24 decoder layers, 16 heads
     on 16, 1500 frames) whole, bf16, one after the other: the dense
     decode kernel and its int8 twin at the runs' shapes (group 1, D 64,
     8 slots over 545 and 65 columns) and the SSD scan at zamba2's
     single-shot prefills (1, L, 64 heads of 64, N 64, chunk 64) against
     their plain versions and timed; 8 requests on the dense backend
     under the controller and agent (two by ``admit(..., extras=...)``,
     six pulled with ``req.extras``; profiles by ``calibrate_from_engine``,
     whisper's through a prefill that adds zero frames to the calibration's
     prompts): zamba2's prompts 16-512 tokens, in float twice (bitwise
     equal) and with int8 KV; whisper's with random (1500, 1024) frames;
     every request terminal and served, launches exactly one dense decode
     kernel a site (6) or a decoder layer (24) per decode step and one SSD
     scan a layer (38) per admission, no other kernel; two requests
     evicted and resumed in each other's slot give the uninterrupted
     run's tokens; the page pool refuses both (construction, swap, a
     request with frames); a decode step's device and eager time beside
     its read bound, and one admission's;
  7f. hetero phase: the params placed through ``serve.shard_registry``
     (a one-device mesh on a one-rank ``nccl`` group): every leaf's
     placement is the one ``spec_for`` gives, and one engine's tokens for
     8 prompts with the placed params equal those without, bit for bit;
     then ``serve.run_threaded`` with ``--hetero`` over 3 instances of
     full-width granite-3-2b on the placed params: one calibration per
     tier ((16, 4), (8, 2), (4, 1) slots and burst), every request
     terminal, no page leaked, only the two float paged kernels launched;
  8. reference phase: reduced models in float32 on the card and on the
     CPU (the kernels' plain versions) with the same weights must give the
     same greedy tokens through chunked prefill, evict/resume and decode
     bursts: granite on the page pool (with prefix sharing), granite on
     the dense backend, chunked and through the single-shot prefill,
     h2o-danube on the dense backend with prompts past its 64-token
     rolling window, qwen1.5-32b (QKV bias, group 1) on the page pool and
     deepseek-67b (group 8) on the dense backend at head_dim 128,
     qwen3-moe-30b-a3b (group 8, 4 experts top 2) on the page pool,
     llava-next-34b (group 7) on the dense backend with patch embeddings
     on every request, and zamba2 (four layers, two sites) and whisper
     (frame embeddings on every request) on the dense backend through the
     single-shot prefill; granite on int8 pages must keep its
     logits within 1e-3 of the CPU's and may part from its tokens only at
     a near tie (``near_tie_parting``); so may mamba2 and zamba2 (dense
     backend, single-shot prefill through the SSD kernel on the card),
     whose float logits are checked the same way;
  9. training phase, through ``repro_torch.launch.train.train``, float32,
     AdamW, remat, ``use_pallas_attention`` set, full width, each model
     freed before the next, launch counts set to 0 just before each run
     and read just after (exactly two a step of the flash kernel per
     causal attention layer or hybrid site and of the SSD scan per mamba
     layer, the forward and the remat recompute; no other kernel): 3
     steps of granite-3-2b (batch 2, seq 512); one step of the same
     weights and batch with the flag off (step-0 loss within 1e-4
     relative, gradient norm within 1e-3); one step of h2o-danube-1.8b
     (D 80); then (``TRAIN_RUNS``) mamba2-130m whole (3 steps, 2 x 512),
     zamba2-1.2b whole (2 steps, 2 x 512; one more with the flag off,
     checked as granite's), whisper-medium whole (2 steps, 2 x 448, 1500
     random frames; the encoder's bidirectional attention plain),
     qwen3-moe-30b-a3b and llava-next-34b (2880 random patch embeddings
     before 1 x 512 text tokens) at full width and ``TRAIN_LAYERS``
     layers, 2 steps each: losses, gradient norms, step times, peak
     memory and launches printed, losses finite;
 10. training reference phase: each family reduced (2 layers, d_model
     256; h2o-danube's window 64 under 128 tokens) trained 3 steps on the
     card (the flash and SSD kernels) and on the CPU (their plain
     versions) from the same weights, tokens and modality extras: losses
     and final params within 1e-4 (``TRAIN_TOL``), launches exact;
 11. examples phase (``examples_phase``): the twins of
     ``examples/quickstart.py`` on granite-3-2b whole and of
     ``examples/multi_model_serving.py`` on granite-3-2b and
     h2o-danube-1.8b whole, bf16, on the dense backend: every request
     served, QLM grouping with fewer model swaps than the per-request
     order, the dense decode kernel launched exactly once a granite layer
     per granite decode step (h2o-danube's rolling window runs plain) and
     no other kernel; attainment, TTFTs, swaps and swap time printed;
 12. dry-run phase (``dryrun_phase``): ``launch/dryrun.py`` on the fake
     16 x 16 mesh for ``DRYRUN_PAIRS`` (per-device peak, flops, collective
     bytes, dropped shardings, fallbacks with their collective bytes and
     trace time printed: predictions, not measurements; each record's
     collective bytes by op beside the same record's before the
     vocab-parallel lookup and the one-axis head splits); granite
     decode_32k and zamba2 long_500k must shard their caches' ``kv_seq``
     and run the dense cache write with no fallback, and every record
     (qwen3-moe train_4k's baseline and ``g16`` too) must run the
     embedding lookup and its gradient and the k/v head split with no
     fallback (``check_sharding``); hillclimb's qwen3-moe train_4k
     ``g16``, ``g16_mb4`` and ``g16_mb4_seqshard_donate`` cut to 4 layers
     must run with no fallback, the microbatched step at most 2x the
     other's collective bytes, each record's bytes printed beside the
     same record's under torch 2.13 (``check_microbatching``); then on a
     1 x 1 fake mesh
     granite-3-2b's decode step at 8 x 32768 (bf16) and its train step
     at 2 x 512 (f32, AdamW, remat, the flash kernel's
     config), each beside the same step run for real on the card (the
     dense decode kernel, 40 launches; the flash kernel, 80): argument
     bytes equal exactly; the two peaks (and ``[train]``'s granite peak)
     printed side by side, not gated (the plain versions' temporaries are
     not the kernels'); beside each, the roofline's three terms of its 1
     x 1 record (``launch/roofline.py``, H100 constants) and the card's
     time (the decode step as CUDA-graph replays, the train step as a
     warm step on the host clock), with card / bound: the card's time
     must be at least the compute term and the record's bytes accessed
     at least its argument bytes (the memory ratio is not gated: the
     count is unfused);
 13. hillclimb phase (``hillclimb_phase``): ``launch/hillclimb.py``'s
     granite-decode target on the fake 16 x 16 mesh, its records
     written to an empty directory, both report lines (``pet``,
     ``kvquant8``) printed: predictions, each record held to
     ``check_sharding`` as granite's in the dry-run phase; the roofline's
     ``HBM_BYTES`` must not exceed the card's memory.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

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

# library -> (the kernel every one of its kernels must be, the instance
# name that marks an int8 one, which must be among them, or None): each
# with tensor-core instructions and no spill bytes
CORE_LIBRARIES = {
    "paged_decode_attention": ("decode_mma_kernel<", "Int8Source"),
    "decode_attention": ("decode_mma_kernel<", "Int8Source"),
    "paged_prefill_attention": ("prefill_mma_kernel<", "Int8Prefix"),
    "flash_attention": ("flash_mma_kernel<", None),
    "ssd_scan": ("ssd_mma_kernel<", None),
}


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
    kernel's SASS.  Every kernel of CORE_LIBRARIES must be its library's
    core kernel with tensor-core instructions, int8 instances among them
    where it has any, with no spills."""
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
        if lib in CORE_LIBRARIES:
            core, int8 = CORE_LIBRARIES[lib]
            spills = {short[k]: r["spill_bytes"] for k, r in res.items()}
            check(all(k.startswith(core) and n for k, n in named.items())
                  and (int8 is None or any(int8 in k for k in named)),
                  f"{lib}: a kernel off {core}..>, without HMMA/HGMMA, or no "
                  f"int8 instance: {named}")
            check(not any(spills.values()), f"{lib}: spills {spills}")


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


def compare(out, want, dtype, live=None, tol=TOL):
    """Max abs error and whether every element is within tol[dtype];
    ``live``, for a prefill output: each sequence's live rows, past which
    the output must be exact zeros (the plain version's are)."""
    zeros = live is None or not any(bool(out[b, :, n:].any())
                                    for b, n in enumerate(live))
    out, want = out.float(), want.float()
    err = (out - want).abs()
    ok = bool((err <= tol[dtype]["atol"] + tol[dtype]["rtol"]
               * want.abs()).all())
    return (float(err.max()) if err.numel() else 0.0), ok and zeros


def prefill_live(args) -> list:
    """Each sequence's live rows (``live_rows``) of a prefill kernel's
    ``args``: q (B, H, C, D) first, valid last."""
    from repro_torch.kernels.paged_prefill_attention import live_rows
    return live_rows(args[0].shape[2], args[-1]).tolist()


def prefill_work(H, D, C, starts, valid, live) -> dict:
    """What a paged prefill must do, for ``bound``: q read for the live
    rows, the whole (B, C) output written (zeros past the live rows), the
    chunk's k/v read for the valid rows, and 4 H D flops per (live row,
    visible key): the prefix, then the chunk's keys below valid, causal."""
    return dict(
        q_rows=sum(live), out_rows=len(valid) * C, kv_rows=sum(starts),
        chunk_rows=sum(valid),
        flops=4.0 * H * D * sum(n * s + v * (v + 1) / 2 + (n - v) * v
                                for s, v, n in zip(starts, valid, live)))


def check_case(failures, name, dtype, case, args) -> float:
    """Kernel ``name`` against its plain version on ``args`` (a prefill's
    every row: the live ones, and zeros past them); a disagreement is
    appended to ``failures``."""
    fn, plain = kernel_fns(name)
    live = prefill_live(args) if "prefill" in name else None
    err, ok = compare(fn(*args), plain(*args), dtype, live)
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
               table=0, ints=0, out_rows=None):
    """Bytes an attention call must move: q (``q_rows`` query tokens) and
    out (``out_rows``, default ``q_rows``), the live k/v rows (int8 plus
    one scale each when ``quant``), a prefill chunk's own k/v, the live
    table entries and the per-sequence ints."""
    kv_row = D + esize if quant else D * esize
    out_rows = q_rows if out_rows is None else out_rows
    return ((q_rows + out_rows) * H * D * esize + 2 * kv_rows * KVH * kv_row
            + 2 * chunk_rows * KVH * D * esize + 4 * (table + ints))


def _dequant(x, scale, dtype):
    return (x.float() * scale.float()[..., None]).to(dtype)


def _prefill_mask(q, S, st, vd):
    """The paged prefill's visibility over a gathered prefix of S
    positions (< starts) plus the chunk's own keys (causal, < valid), as
    one boolean SDPA mask (B, 1, C, S + C)."""
    B, _, C, _ = q.shape
    c = torch.arange(C, device="cuda")
    return torch.cat([
        (torch.arange(S, device="cuda")[None, :] < st[:, None])
        [:, None, :].expand(B, C, S),
        (c[None, :] <= c[:, None])[None] & (c[None, None, :]
                                            < vd[:, None, None])],
        dim=-1)[:, None]


def prefill_library(args, dtype):
    """SDPA computing the float paged prefill on ``args``: the gathered
    prefix (positions < starts) plus the chunk's own keys (causal, <
    valid), through one boolean mask."""
    from repro_torch.kernels.paged_decode_attention import gather_pages

    q, kp, vp, ck, cv, bt, st, vd = args
    mask = _prefill_mask(q, bt.shape[1] * kp.shape[2], st, vd)
    k_all = torch.cat([gather_pages(kp, bt).to(dtype), ck], dim=2)
    v_all = torch.cat([gather_pages(vp, bt).to(dtype), cv], dim=2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_all, v_all, attn_mask=mask, enable_gqa=True)


def prefill_two_calls(args, dtype):
    """What stands in for the int8 paged prefill without one PyTorch call:
    gather the prefix's int8 pages and scales and dequantize them, then
    SDPA over them and the chunk's keys under ``prefill_library``'s mask;
    timed as two calls, never as ``library_ms``."""
    from repro_torch.kernels.paged_decode_attention import gather_pages

    q, kq, vq, ks, vs, ck, cv, bt, st, vd = args
    mask = _prefill_mask(q, bt.shape[1] * kq.shape[2], st, vd)

    def run():
        k, v = (torch.cat([_dequant(gather_pages(x, bt), gather_pages(c, bt),
                                    dtype), chunk], dim=2)
                for x, c, chunk in ((kq, ks, ck), (vq, vs, cv)))
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    return run


FLOAT_DECODE = ("paged_decode_attention", "decode_attention")
INT8_DECODE = ("paged_decode_attention_quant", "decode_attention_quant")


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


def decode_two_calls(name, args):
    """What stands in for an int8 decode kernel ``name`` without one
    PyTorch call: gather the pages (paged) and dequantize, then SDPA over
    the length-masked KV; timed as two calls, never as ``library_ms``."""
    from repro_torch.kernels.paged_decode_attention import gather_pages

    q, kq, vq, ks, vs = args[:5]
    ln = args[-1]
    paged = name == "paged_decode_attention_quant"
    S = args[5].shape[1] * kq.shape[2] if paged else kq.shape[2]
    mask = (torch.arange(S, device="cuda")[None, :]
            < ln[:, None])[:, None, None]

    def rows(x, scale):
        if paged:
            return gather_pages(x, args[5]), gather_pages(scale, args[5])
        return x, scale

    def run():
        kv = [_dequant(*rows(x, c), q.dtype) for x, c in ((kq, ks), (vq, vs))]
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], *kv, attn_mask=mask, enable_gqa=True)
    return run


def decode_splits(name, args):
    """CTAs per (sequence, KV head) of the decode kernel ``name`` on
    ``args``, from its launch plan (None for a tree without one, or
    without one for int8)."""
    import inspect

    from repro_torch.kernels import common

    quant = name in INT8_DECODE
    if not hasattr(common, "decode_plan") or (
            quant and "quant" not in
            inspect.signature(common.decode_plan).parameters):
        return None
    q = args[0]
    B, H, D = q.shape
    if name.startswith("paged"):
        KVH, bs = args[1].shape[1:3]
        cap = args[-2].shape[1] * bs
    else:
        KVH, cap = args[1].shape[1:3]
    kw = {"quant": True} if quant else {}
    return common.decode_plan(B, H, KVH, cap, D, q.dtype, **kw).splits


def kernel_phase(shapes: dict):
    """Every kernel against its plain version over the cases below, then
    the timed records at the serving shapes.  Returns (records, failures)."""
    from repro_torch.kernels.paged_decode_attention import gather_pages

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, nb, N, bs, S = (shapes[k] for k in ("B", "nb", "N", "bs", "S"))
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
        f"serving B={B} S={S}": dict(
            lengths=[5, 40, 1, 0, 17, 33, 0, 16][:B], S=S),
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
                                              **kw))
            for case, kw in dense_cases.items():
                check_case(failures, "decode_attention" + sfx, dtype, case,
                           dense_case(rng, gen, dtype, quant=quant, **kw))

    # timings at the serving paths' shapes, in their dtype
    dtype, esize = torch.bfloat16, 2
    H, KVH, D = 32, 8, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = {}

    def timed(name, args, nbytes, flops, library=None):
        fn, plain = kernel_fns(name)
        err = check_case(failures, name, dtype, "timed serving shapes", args)
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
                    "two_call_ms": time_ms(decode_two_calls(
                        "paged_decode_attention_quant", args)),
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
                "its first chunk), so the int8 pages are not read; gather + "
                "dequantize, then SDPA: " + json.dumps({
                    "two_call_ms": time_ms(prefill_two_calls(args, dtype))}))
        else:
            library = prefill_library(args, dtype)
        # the prefix is empty, so no table entry is live
        work = prefill_work(H, D, C, [0] * B, valid.tolist(),
                            prefill_live(args))
        timed("paged_prefill_attention" + ("_quant" if quant else ""), args,
              attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=work["q_rows"],
                         out_rows=work["out_rows"], kv_rows=0, quant=quant,
                         chunk_rows=work["chunk_rows"], ints=2 * B),
              work["flops"], library)

    for quant in (False, True):
        args = dense_case(rng, gen, dtype, lengths.tolist(), S, quant)
        if quant:
            log("  decode_attention_quant: no single PyTorch call; "
                "dequantize, then SDPA: " + json.dumps({"two_call_ms": time_ms(
                    decode_two_calls("decode_attention_quant", args))}))
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
        f"dense decode B={B} S={S} live tokens={live}")
    long_context(rng, gen, failures)
    flash_phase(gen, failures, records)
    ssd_phase(gen, failures, records)
    return records, failures


def long_context(rng, gen, failures) -> None:
    """Every kernel where the KV read is large: decode over 8 x 4096 tokens
    (67 MB of bf16 KV, past the 50 MB L2; half that, plus scales, in int8),
    paged and dense, and a 128-token chunk over a 2048-token prefix for 4
    sequences; each checked against its plain version and timed beside its
    bound, bf16, the decode kernels with their split count and beside SDPA
    (float) or the two calls that dequantize and run SDPA (int8).  The
    float prefill also beside its plain version and SDPA,
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
                  d_bound, ""),
                 ("decode_attention" + sfx,
                  dense_case(rng, gen, dtype, [L] * n, L, quant), d_bound,
                  ""),
                 ("paged_prefill_attention" + sfx,
                  prefill_case(rng, gen, dtype, [2048] * 4, [128] * 4, 128,
                               quant), p_bound(4, 2048, 128, quant),
                  " B4 C128 prefix 2048")]
        if not quant:
            cases.append(("paged_prefill_attention",
                          prefill_case(rng, gen, dtype, [4096], [128], 128),
                          p_bound(1, 4096, 128, False),
                          " B1 C128 prefix 4096"))
        for name, args, (b, by), label in cases:
            check_case(failures, name, dtype, "long context" + label, args)
            fn, plain = kernel_fns(name)
            rec = {"ms": time_ms(lambda: fn(*args)), "bound_ms": b,
                   "bound_by": by}
            if name == "paged_prefill_attention":
                rec["plain_ms"] = time_ms(lambda: plain(*args))
                rec["library_ms"] = time_ms(prefill_library(args, dtype))
            if name in FLOAT_DECODE:
                rec["library_ms"] = time_ms(decode_library(name, args))
            if name in INT8_DECODE:
                rec["two_call_ms"] = time_ms(decode_two_calls(name, args))
            if name == "paged_prefill_attention_quant":
                rec["two_call_ms"] = time_ms(prefill_two_calls(args, dtype))
            if name in FLOAT_DECODE + INT8_DECODE:
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
    version (its wiring: the backward never reads the kernel's output),
    then the timed record at the training phase's shape (f32,
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
    flash_training_shapes(gen, failures)


# (B, H, KVH, L, D) of the training phase's flash calls, f32, causal
FLASH_TRAIN_CASES = {
    "granite train B2 L512": (2, 32, 8, 512, 64),
    "zamba2 train B2 L512": (2, 32, 32, 512, 64),
    "whisper train B2 L448": (2, 16, 16, 448, 64),
    "qwen3-moe train B2 L512": (2, 32, 4, 512, 128),
    "llava train B1 L3392": (1, 56, 8, 3392, 128),
}


def flash_training_shapes(gen, failures) -> None:
    """Flash attention as the training phase calls it (f32, causal): the
    Function's forward against the plain version and its gradients
    against autograd of the plain version (the Function's wiring, not the
    kernel: the backward recomputes the plain version); then the kernel's
    time beside
    its bound, the plain version's, SDPA's and the Function's backward
    (the plain version recomputed and differentiated), issued eagerly."""
    from repro_torch.kernels import flash_attention as fa

    dtype = torch.float32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case, (B, H, KVH, L, D) in FLASH_TRAIN_CASES.items():
        base = flash_case(gen, dtype, B, H, KVH, L, L, D)
        cot = torch.randn(base[0].shape, generator=gen, device="cuda")
        runs = []
        for fn in (fa.flash_attention, fa.flash_attention_plain):
            ts = [t.clone().requires_grad_() for t in base]
            out = fn(*ts)
            runs.append((out.detach(), torch.autograd.grad(out, ts, cot)))
        (out, got), (want, want_g) = runs
        del runs
        err, ok = compare(out, want, dtype)
        g_errs = [compare(a, b, dtype) for a, b in zip(got, want_g)]
        g_ok = all(o for _, o in g_errs)
        log(f"  flash_attention {case} f32: forward max_abs_err {err:.3e}; "
            f"gradients (dq, dk, dv) against autograd of the plain version: "
            f"max_abs_err {[f'{e:.3e}' for e, _ in g_errs]} "
            f"{'ok' if ok and g_ok else 'FAIL'}")
        if not (ok and g_ok):
            failures.append(("flash_attention", "training", case))
        del got, want_g, want

        q, k, v = base
        ts = [t.clone().requires_grad_() for t in base]
        out = fa.flash_attention(*ts)
        big = L > 2048                           # ~2.6 GB f32 score tensors
        reps = dict(iters=3, replays=3) if big else {}
        nbytes = 4 * D * L * B * (2 * H + 2 * KVH)
        bound_ms, by = bound(nbytes, 4.0 * B * H * D * L * (L + 1) / 2,
                             dtype)
        rec = {"max_abs_err": err,
               "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v),
                                   **reps),
               "bound_ms": bound_ms, "bound_by": by,
               "library_ms": time_ms(lambda: sdpa(
                   q, k, v, is_causal=True, enable_gqa=True), **reps),
               "backward_eager_ms": eager_ms(lambda: torch.autograd.grad(
                   out, ts, cot, retain_graph=True), iters=3 if big else 10)}
        log(f"  flash_attention {case} f32, the training call: "
            + json.dumps(rec) + "; backward_eager_ms: the plain version "
            "recomputed and differentiated, issued from Python (host "
            "dispatch included)")
        del out, ts


# (B, L, H, P, G, N, chunk) of the SSD scan cases: the JAX kernel tests'
# shapes (G > 1 in the third), mamba2-130m's serving prefill (a prompt of
# up to 64 tokens pads to one chunk), a long prefill, a batch, and
# zamba2's SSM widths at chunk 64 and at 128
SSD_CASES = {
    "(1,64,2,16,1,8,16)": (1, 64, 2, 16, 1, 8, 16),
    "(2,128,4,32,2,16,32)": (2, 128, 4, 32, 2, 16, 32),
    "groups (1,32,8,8,4,4,8)": (1, 32, 8, 8, 4, 4, 8),
    "mamba2 B1 L64": (1, 64, 24, 64, 1, 128, 64),
    "mamba2 B1 L512": (1, 512, 24, 64, 1, 128, 64),
    "mamba2 B1 L2048": (1, 2048, 24, 64, 1, 128, 64),
    "mamba2 B4 L512": (4, 512, 24, 64, 1, 128, 64),
    "zamba2 widths L256": (1, 256, 64, 64, 1, 64, 64),
    "zamba2 chunk 128 L256": (1, 256, 64, 64, 1, 64, 128),
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


def ssd_bound(dtype, B, L, H, P, G, N, Q, esize, *, state_in) -> tuple:
    """Each input read once and each output written once (x, y, B, C in
    ``esize`` bytes; dt, A and the states f32: the final state written,
    the initial one read only when ``state_in``, since a zero state is
    never loaded), and the products' flops: per chunk C.B^T over the
    visible half (j <= i), once per group, and per head the masked form
    times x, C times the state and the state update."""
    states = 2 if state_in else 1
    nbytes = (2 * B * L * H * P * esize + 2 * B * L * G * N * esize
              + 4 * (B * L * H + H) + states * 4 * B * H * N * P)
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

    long_f32 = {}
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
                if dtype == torch.float32 and case == "mamba2 B1 L2048":
                    long_f32["state in" if state is not None
                             else "zero state"] = {"y": err, "state": h_err}
    log("  ssd_scan f32 mamba2 B1 L2048, max |kernel - plain|: "
        + json.dumps(long_f32) + f" (tolerance {SSD_TOL[torch.float32]})")

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
        bound_ms, by = ssd_bound(dtype, B, L, H, P, G, N, Q, esize,
                                 state_in=True)
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
    ssd_training_shapes(gen, failures)


# the training phase's SSD shapes (f32, batch 2 of 512 tokens): mamba2-130m
# (24 heads of 64, N 128) and zamba2-1.2b (64 heads of 64, N 64), chunk 64
SSD_TRAIN_CASES = {"mamba2 train B2 L512": (2, 512, 24, 64, 1, 128, 64),
                   "zamba2 train B2 L512": (2, 512, 64, 64, 1, 64, 64)}


def ssd_training_shapes(gen, failures) -> None:
    """The SSD scan as training calls it (f32, zero state in, the state
    out): the Function's forward against the plain version and its
    gradients (a cotangent on y alone, as the loss gives) against autograd
    of the plain version, which checks the Function's wiring and not the
    kernel, since the backward recomputes the plain version; then the kernel's time beside its bound and the
    plain version's, and the Function's backward (the plain version
    recomputed and differentiated), issued eagerly."""
    from repro_torch.kernels import ssd_scan as ss

    dtype = torch.float32
    for case, (B, L, H, P, G, N, Q) in SSD_TRAIN_CASES.items():
        x, dt, A, Bm, Cm, _ = ssd_case(gen, dtype, B, L, H, P, G, N)
        base = (x, dt, A, Bm, Cm)
        gy = torch.randn(x.shape, generator=gen, device="cuda")
        runs = []
        for fn in (ss.ssd_scan, ss.ssd_scan_plain):
            ts = [t.clone().requires_grad_() for t in base]
            y, _ = fn(*ts, Q, None, return_state=True)
            runs.append((y.detach(), torch.autograd.grad(y, ts, gy)))
        (y, got), (want_y, want) = runs
        err, ok = compare(y, want_y, dtype, tol=SSD_TOL)
        g_errs = [compare(a, b, dtype) for a, b in zip(got, want)]
        g_ok = all(o for _, o in g_errs)
        log(f"  ssd_scan {case} f32: forward max_abs_err {err:.3e}; "
            f"gradients (x, dt, A, B, C) against autograd of the plain "
            f"version: max_abs_err {[f'{e:.3e}' for e, _ in g_errs]} "
            f"{'ok' if ok and g_ok else 'FAIL'}")
        if not (ok and g_ok):
            failures.append(("ssd_scan", "training", case))

        ts = [t.clone().requires_grad_() for t in base]
        y, _ = ss.ssd_scan(*ts, Q, None, return_state=True)
        bound_ms, by = ssd_bound(dtype, B, L, H, P, G, N, Q, 4,
                                 state_in=False)
        rec = {"max_abs_err": err,
               "ms": time_ms(lambda: ss.ssd_scan(*base, Q, None,
                                                 return_state=True)),
               "plain_ms": time_ms(lambda: ss.ssd_scan_plain(
                   *base, Q, None, return_state=True)),
               "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
               "backward_eager_ms": eager_ms(lambda: torch.autograd.grad(
                   y, ts, gy, retain_graph=True), iters=10)}
        log(f"  ssd_scan {case} f32, the training call: " + json.dumps(rec)
            + "; backward_eager_ms: the plain version recomputed and "
            "differentiated, issued from Python (host dispatch included)")


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------

def serving_shapes() -> dict:
    """The attention shapes the serve phases give the kernels: every slot
    in each call, the engine's page pool and block table (paged), the
    cache's ``max_seq_len`` columns (dense), and the chunk bucket covering
    the workload's longest prompt (23 tokens)."""
    from repro_torch.launch import serve
    ecfg = serve.engine_config(SERVE_ARGS, torch.bfloat16)
    return {"B": ecfg.max_slots, "bs": ecfg.block_size,
            "nb": ecfg.max_blocks_per_seq(), "N": ecfg.resolved_kv_blocks(),
            "S": ecfg.max_seq_len,
            "C": next(b for b in ecfg.resolved_buckets() if b >= 23)}


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
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
    """``model`` with its single-shot ``prefill`` counting its calls in
    ``counts[name]`` (a chunking engine calls the dense transformer's
    never)."""
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
            steps = (("decode step", lambda: model.decode_step_paged.eager(
                params, cache, tokens, lengths, bt)),
                ("prefill chunk round", lambda: model.prefill_chunk_paged(
                    params, cache, chunk, starts, valid, bt)))
        else:
            cache = model.init_cache(B, shapes["S"], torch.bfloat16, "cuda")
            steps = (("decode step", lambda: model.decode_step(
                params, cache, tokens, lengths)),
                ("prefill chunk round", lambda: model.prefill_chunk(
                    params, cache, chunk, starts, valid)))
        for name, fn in steps:
            device = time_ms(fn, iters=5, replays=4)
            eager = eager_ms(fn, iters=10)
            log(f"  {label} {name}: device {device:.3f} ms, eager "
                f"{eager:.3f} ms, host share {1 - device / eager:.3f}")
        if paged:
            replayed = eager_ms(lambda: model.decode_step_paged(
                params, cache, tokens, lengths, bt), iters=10)
            log(f"  {label} decode step as the engine calls it (a CUDA-graph "
                f"replay from Python): {replayed:.3f} ms")
        del cache
        torch.cuda.empty_cache()


def long_step_timings(model, quant, params) -> None:
    """Informational: one full-width decode step at 8 slots x 4096 tokens
    of context (each slot attends 4096 keys), on the page pool and on the
    dense cache, in float (``model``) and int8 KV (``quant``, the same
    weights), device time from CUDA-graph replays against the eager call.
    The caches (2.7 GB each in bf16, about half that in int8) are filled
    with random values directly, so no 4096-token prefill runs: float
    leaves from a normal, int8 leaves uniform in [-127, 127], their scales
    uniform in [1e-3, 0.05]."""
    B, L, bs = 8, 4096, 16
    nb = L // bs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    tokens = torch.arange(B, dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), L - 1, dtype=torch.int32, device="cuda")
    bt = torch.arange(B * nb, dtype=torch.int32, device="cuda").reshape(B, nb)
    for label, m in (("", model), (" int8", quant)):
        for layout, make, step in (
                ("page pool", lambda: m.init_paged_cache(
                    B * nb, bs, torch.bfloat16, "cuda"),
                 lambda c: m.decode_step_paged.eager(params, c, tokens,
                                                     lengths, bt)),
                ("dense", lambda: m.init_cache(B, L, torch.bfloat16, "cuda"),
                 lambda c: m.decode_step(params, c, tokens, lengths))):
            cache = make()
            for name, leaf in cache.items():
                if leaf.dtype == torch.int8:
                    leaf.random_(-127, 128, generator=gen)
                elif name.endswith("_scale"):
                    leaf.uniform_(1e-3, 0.05, generator=gen)
                else:
                    leaf.normal_(generator=gen)
            device = time_ms(lambda: step(cache), iters=3, replays=3)
            eager = eager_ms(lambda: step(cache), iters=5)
            log(f"  granite {layout}{label} decode step, 8 slots x {L} "
                f"tokens of context: device {device:.3f} ms, eager "
                f"{eager:.3f} ms, host share {1 - device / eager:.3f}")
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

    # fork_slot: clone a running decode onto its pages; the partial tail
    # page (39 tokens cached: the third page holds 7) is copied once, at
    # the next dispatch
    c = Request(prompt_tokens=rng.integers(0, vocab, size=37).tolist(),
                model=GRANITE, slo=1e9, max_new_tokens=8)
    check(eng.admit(c), "fork source not admitted")
    while eng.prefilling_slots():
        eng.step()
    eng.step()
    eng.step()
    cow0 = eng.stats.cow_copies
    clone = eng.fork_slot(eng.slots.index(c))
    cow_fork = eng.stats.cow_copies
    check(clone is not None and eng.stats.forks == 1 and cow_fork == cow0,
          "fork_slot copied a page")
    eng.step()
    cow1 = eng.stats.cow_copies
    for _ in range(20):
        if c.finished() and clone.finished():
            break
        eng.step()
    log(f"  fork_slot: forks {eng.stats.forks}, cow_copies before the fork "
        f"{cow0}, after it {cow_fork}, after the next dispatch {cow1}; "
        f"tokens source "
        f"{c.output_tokens} clone {clone.output_tokens}")
    check(cow1 == cow0 + 1, f"fork_slot: {cow1 - cow0} COW copies at the "
                            f"next dispatch")
    check(c.finished() and clone.finished()
          and clone.output_tokens == c.output_tokens,
          "fork_slot: the clone's tokens differ from the source's")
    check(eng.block_mgr.used_blocks == 0, "fork_slot: KV blocks leaked")


# ---------------------------------------------------------------------------
# drivers: the async front end, the threaded cluster, the chaos soak
# ---------------------------------------------------------------------------

PAGED_FLOAT = ("paged_decode_attention", "paged_prefill_attention")


def _expect_launches(label: str, launches: dict) -> None:
    check(all(launches[k] > 0 for k in PAGED_FLOAT)
          and not any(n for k, n in launches.items()
                      if k not in PAGED_FLOAT),
          f"{label}: expected launches of {PAGED_FLOAT} only, got "
          f"{launches}")


def _terminal(r) -> bool:
    return r.finished() or r.dropped()


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def parting(model, params, prompt, got, want):
    """Where two token streams of one prompt part, None if nowhere:
    (index, the two tokens' logits, the row's two best tokens and the
    second-best logit), the logits recomputed alone (one slot, the whole
    history in one prefill, over the real vocab)."""
    from repro_torch.core.request import Request
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        return None
    calls = []
    eng = ContinuousBatchingEngine(_recording(model, calls), params,
                                   EngineConfig(
                                       max_slots=1, max_seq_len=256,
                                       dtype=params["embed"].dtype,
                                       device=str(params["embed"].device)),
                                   model_name="m")
    r = Request(prompt_tokens=list(prompt) + list(want[:j]), model="m",
                slo=1e9, max_new_tokens=1)
    check(eng.admit(r), "parting: history not admitted")
    while not r.finished():
        eng.step()
    row = calls[-1][0][:model.cfg.vocab_size]
    top2 = row.topk(2)
    return (j, float(row[got[j]]), float(row[want[j]]),
            top2.indices.tolist(), float(top2.values[1]))


def check_partings(label, model, params, pairs) -> list:
    """``pairs``: (prompt, tokens, tokens) of one request in two runs,
    which saw it in batches of other sizes, whose products round
    differently.  Where two runs part, the two tokens must be the best
    two of the recomputed row, ties counted (each logit at least the
    row's second-best: in bf16 three tokens may share the best value, and
    ``topk`` then names any two of them), their logits apart by no more
    than the weights' dtype's kernel tolerance (``TOL``: atol + rtol x
    the larger logit): a near tie.  Each parting is logged with its gap.
    Returns the partings."""
    tol = TOL[params["embed"].dtype]
    found = []
    for prompt, got, want in pairs:
        p = parting(model, params, prompt, got, want)
        if p is None:
            continue
        j, l_got, l_want, best2, second = p
        gap = abs(l_got - l_want)
        bound = tol["atol"] + tol["rtol"] * max(abs(l_got), abs(l_want))
        log(f"  [{label}] tokens part at {j} of {len(want)}: tokens "
            f"{got[j]} / {want[j]}, logits {l_got:.4f} / {l_want:.4f}, gap "
            f"{gap:.4f} (near-tie bound {bound:.4f}), best two {best2}, "
            f"second-best logit {second:.4f}")
        check(min(l_got, l_want) >= second and gap <= bound,
              f"{label}: tokens part at {j} and it is not a near tie")
        found.append(p)
    return found


def drivers_async(registry) -> None:
    """The async front end (``AsyncServer``) over ``async_serve``'s cluster
    of two engines sharing one set of weights: the 32 requests of
    ``async_serve.build_requests`` (interactive and batch classes) at 8/s
    and 4 sessions of 3 turns (later turns carry the conversation as a
    prefix), queue depth 16, shedding by deferral, and one client that
    cancels mid-decode.  Every client reads its stream."""
    import asyncio

    from repro_torch.core.request import SLO_CLASSES
    from repro_torch.data.workload import SessionSpec, generate_sessions
    from repro_torch.launch import async_serve
    from repro_torch.launch.serve import calibrate_registry, engine_config
    from repro_torch.serving import AsyncServer, FrontendConfig, run_session

    args = argparse.Namespace(**{
        **vars(SERVE_ARGS), "backend": "paged-cuda", "instances": 2,
        "requests": 32, "rate": 8.0, "batch_new_tokens": 16,
        "slo_scale": 1.0, "reschedule_cooldown": 0.5})
    names = list(registry)
    np.random.seed(0)                # calibrate_from_engine's prompts
    hw = calibrate_registry(registry, engine_config(
        args, registry[names[0]][1]["embed"].dtype))
    engines, agents, _, controller = async_serve.build_cluster(
        args, registry, hw, names)
    server = AsyncServer(controller, agents, FrontendConfig(
        queue_depth=16, shed_policy="defer",
        interactive_slo_ceiling=SLO_CLASSES["interactive"]))
    pairs = async_serve.build_requests(args, names)
    victim = next(r for r, _ in pairs if r.slo_class != "interactive")
    sessions = generate_sessions(SessionSpec(
        n_sessions=4, turns=3, seed=0, model=names[0],
        slo_class="interactive", arrival_rate=2.0, think_time_s=0.05,
        max_new_tokens=16, vocab=100))
    streamed = {}

    async def client(req, offset):
        req.arrival_time = t_start + offset
        await asyncio.sleep(max(0.0, req.arrival_time - time.monotonic()))
        stream = await server.submit(req)
        got = streamed.setdefault(id(req), [])
        async for tok in stream:
            got.append(tok)
            if req is victim and len(got) == 3:
                stream.cancel()                  # mid-decode

    async def session(s):
        await asyncio.sleep(max(0.0, s.arrival_time - time.monotonic()))
        await run_session(server, s)

    async def go():
        async with server:
            tasks = [client(r, off) for r, off in pairs]
            for s in sessions:
                s.arrival_time += t_start
                tasks.append(session(s))
            await asyncio.wait_for(asyncio.gather(*tasks), 120.0)
            await asyncio.wait_for(server.drain(), 120.0)

    reset_launches()
    t_start = time.monotonic()
    asyncio.run(go())
    wall = time.monotonic() - t_start
    launches = read_launches()
    reqs = [r for r, _ in pairs]
    turns = [r for s in sessions for r in s.requests]
    now = time.monotonic()
    fs = server.stats
    log(f"  [async] {len(reqs)} requests + {len(turns)} session turns in "
        f"{wall:.2f} s: accepted {fs.accepted}, rejected {fs.rejected} "
        f"(backpressure {fs.rejected_backpressure}), expired {fs.expired}, "
        f"cancelled {fs.cancelled}, shed deferred {fs.shed_deferred} / "
        f"dropped {fs.shed_dropped}, max queue depth {fs.max_queue_depth}, "
        f"tokens streamed {fs.tokens_streamed}; prefix hits "
        f"{sum(e.stats.prefix_hits for e in engines)}; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    for cls in async_serve.CLASSES:
        ttfts = [r.ttft() for r in reqs + turns
                 if r.slo_class == cls and r.ttft() is not None]
        log(f"  [async] {cls}: attainment "
            f"{async_serve.class_attainment(reqs + turns, cls, now):.3f}, "
            f"served {len(ttfts)}, TTFT p50 {_pct(ttfts, 50)} s, p99 "
            f"{_pct(ttfts, 99)} s")
    check(all(_terminal(r) for r in reqs + turns),
          "async: a request is not terminal")
    check(len(turns) >= len(sessions), "async: a session sent no turn")
    check(all(streamed[id(r)] == list(r.output_tokens) for r in reqs),
          "async: a stream's tokens differ from the request's")
    check(victim.cancelled and fs.cancelled >= 1,
          "async: the client's cancellation did not land")
    check(all(e.block_mgr.used_blocks == 0 for e in engines),
          "async: KV blocks leaked")
    check(sum(e.stats.prefix_hits for e in engines) > 0,
          "async: no session turn hit the prefix cache")
    _expect_launches("async", launches)


def drivers_compare(registry) -> None:
    """``serve.run_threaded`` against ``serve.run_round_robin`` on one seed,
    two engines each: every request terminal, no block leaked, and each
    request's tokens equal across the drivers but at near ties."""
    from repro_torch.launch import serve

    args = argparse.Namespace(**{
        **vars(SERVE_ARGS), "backend": "paged-cuda", "instances": 2,
        "requests": 16, "rate": 8.0})
    runs = {}
    for threaded in (True, False):
        args.threaded = threaded
        np.random.seed(0)            # calibrate_from_engine's prompts
        reset_launches()
        stats, reqs, engines = serve.run_once(args, registry, list(registry))
        launches = read_launches()
        label = stats["driver"]
        log(f"  [drivers] {label}: served {stats['served']} of "
            f"{stats['requests']}, {stats['tokens']} tokens, tokens/s "
            f"{stats['tokens_per_s']:.2f}, mean TTFT {stats['mean_ttft_s']} "
            f"s, engine rounds {stats.get('engine_rounds')}, controller "
            f"ticks {stats.get('controller_ticks')}; launches "
            f"{ {k: n for k, n in launches.items() if n} }")
        check(all(_terminal(r) for r in reqs),
              f"{label}: a request is not terminal")
        check(all(e.block_mgr.used_blocks == 0 for e in engines),
              f"{label}: KV blocks leaked")
        _expect_launches(label, launches)
        runs[label] = (stats, reqs)
    (t_stats, t_reqs), (r_stats, r_reqs) = runs["threaded"], \
        runs["round-robin"]
    log(f"  [drivers] tokens/s threaded {t_stats['tokens_per_s']:.2f} vs "
        f"round-robin {r_stats['tokens_per_s']:.2f} "
        f"({t_stats['tokens_per_s'] / r_stats['tokens_per_s']:.3f}x)")
    model, params = registry[GRANITE]
    both = [(a.prompt_tokens, a.output_tokens, b.output_tokens)
            for a, b in zip(t_reqs, r_reqs)
            if a.output_tokens and b.output_tokens]
    check(bool(both), "drivers: no request served by both drivers")
    found = check_partings("drivers", model, params, both)
    log(f"  [drivers] {len(both)} of {len(t_reqs)} requests served by both "
        f"drivers compared, {len(found)} part")


def drivers_chaos(registry) -> None:
    """``chaos`` scenario ``combined`` (3 engines, virtual clock) at full
    width with ``check_soak``'s contract: the no-fault baseline and the
    replay.  Outputs may part from the baseline's only at near ties."""
    from repro_torch.launch import chaos

    args = argparse.Namespace(
        arch=GRANITE, instances=3, requests=24, rate=8.0, max_new_tokens=12,
        slots=4, seed=0, device=SERVE_ARGS.device, scenario="combined",
        plan_file=None,
        site="decode", kill_engine=1, kill_at=4, error_prob=0.0,
        hang_engine=0, hang_at=6, hang_grace=None, drain_engine=None,
        drain_at_round=None, drain_evict=False, replace_cooldown=0.5,
        shared_prefix=None, retry_budget=2, round_dt=0.05, max_rounds=3000,
        threaded=False, hetero=False, routing="solver", max_wall=60.0,
        attainment_floor=0.5, no_supervision=False, replay_check=True)
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.monotonic()
    stats = chaos.run_soak(args, registry=registry)
    failures = chaos.check_soak(args, stats, registry)
    wall = time.monotonic() - t0
    launches = read_launches()
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    log("  [chaos] " + json.dumps({k: v for k, v in stats.items() if k not in
                                   ("timeline", "outputs",
                                    "baseline_outputs")}))
    log(f"  [chaos] 3 soaks (faults, no-fault baseline, replay) in "
        f"{wall:.2f} s; timeline {len(stats['timeline'])} events; launches "
        f"{ {k: n for k, n in launches.items() if n} }; "
        f"memory_allocated {mem0} -> {mem1} bytes")
    parted = failures.pop("baseline", None)
    check(not failures, f"chaos: {failures}")
    planned = {(args.hang_engine, "hang"), (args.kill_engine, "crash")}
    check({(e["engine"], e["kind"]) for e in stats["timeline"]} == planned
          and stats["engine_failures"] >= 1 and stats["hangs"] >= 1,
          f"chaos: the planned faults {planned} did not land: "
          f"{stats['timeline']}")
    check(stats["replacements"] >= 1 and stats["migrations"] >= 1,
          "chaos: no replacement or no migration")
    check(stats.get("replay_identical") is True, "chaos: replay differs")
    _expect_launches("chaos", launches)
    if parted is not None:
        log(f"  [chaos] {parted}")
        base = stats["baseline_outputs"]
        prompts = [r.prompt_tokens for r in chaos.build_requests(args)]
        common = sorted(set(stats["outputs"]) & set(base), key=int)
        check(bool(common), f"chaos: {parted}")
        model, params = registry[GRANITE]
        check_partings("chaos", model, params, [
            (prompts[int(i)], stats["outputs"][i], base[i]) for i in common])


def drivers_phase(model, params) -> None:
    registry = {GRANITE: (model, params)}
    for part in (drivers_async, drivers_compare, drivers_chaos):
        t0 = time.monotonic()
        part(registry)
        log(f"  [drivers] {part.__name__} in {time.monotonic() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the simulator and the paper's baselines against the engine on the card
# ---------------------------------------------------------------------------

# the agreement scenarios' fixed profiles, as in
# tests/test_torch_sim_engine_agreement.py; the slow one makes a queued
# interactive group's estimated completion bust its 20 s TTFT SLO
SIM_HW = dict(prefill_time=0.05, decode_per_token=0.02, inefficiency=1.2,
              token_capacity=512, swap_time=0.2, model_max_tokens=64)
SIM_SLOW_HW = dict(prefill_time=0.05, decode_per_token=0.6,
                   inefficiency=1.2, token_capacity=80, swap_time=0.2,
                   model_max_tokens=8)


def _agreement_engine(registry, reqs, hw, max_slots, submit_late=None):
    """One dense (``"cuda"``) engine under the port's controller and agent
    with ``hw`` for every model, as the agreement tests drive it; returns
    the engine."""
    from repro_torch.core.global_scheduler import InstanceInfo
    from repro_torch.core.lso import QLMAgent
    from repro_torch.core.qlm import QLMConfig, QLMController
    from repro_torch.core.rwt_estimator import HardwareProfile
    from repro_torch.core.virtual_queue import VirtualQueue
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    names = list(registry)
    m0, p0 = registry[names[0]]
    eng = ContinuousBatchingEngine(m0, p0, EngineConfig(
        max_slots=max_slots, max_seq_len=64, attention_backend="cuda",
        dtype=p0["embed"].dtype, device="cuda"), model_name=names[0])
    vq = VirtualQueue(0)
    agent = QLMAgent(eng, vq, registry)
    info = InstanceInfo(0, {n: HardwareProfile(**hw) for n in names},
                        eng.model_name, vq)
    controller = QLMController([info], QLMConfig(avg_batch_size=max_slots,
                                                 reschedule_cooldown=0.0))
    now = time.monotonic()
    for r in reqs:
        controller.submit(r, now)
    late = submit_late[1] if submit_late else []
    for it in range(400):
        info.current_model = eng.model_name
        agent.run_iteration()
        if submit_late is not None and it == submit_late[0]:
            for r in late:
                controller.submit(r, time.monotonic())
        if all(r.finished() for r in list(reqs) + late):
            break
    return eng


def _agreement_sim(names, reqs, hw, max_slots) -> dict:
    from repro_torch.core.rwt_estimator import HardwareProfile
    from repro_torch.sim import ClusterSimulator
    return ClusterSimulator([{n: HardwareProfile(**hw) for n in names}],
                            "qlm", max_batch_requests=max_slots).run(reqs)


def sim_agreement(registry) -> None:
    """The two-group swap scenario and the head-change eviction scenario
    of the agreement tests, at full width on the dense backend (granite
    and h2o-danube swap on one engine) and in the port's simulator with
    the same fixed profiles: the same admission, eviction and swap
    counts.  Launch counts set to 0 just before each engine run and read
    just after: only the dense decode kernel (granite; h2o-danube's
    rolling window decodes in plain PyTorch, as the reference's)."""
    from repro_torch.core.request import make_request

    names = list(registry)

    def two_groups(now):
        rng = np.random.default_rng(0)
        out = []
        for i in range(8):
            r = make_request(rng.integers(0, 100, size=6).tolist(),
                             names[i % 2], "batch1", arrival_time=now,
                             max_new_tokens=3)
            r.true_output_tokens = 3
            out.append(r)
        return out

    reset_launches()
    reqs_e = two_groups(time.monotonic())
    eng = _agreement_engine(registry, reqs_e, SIM_HW, 4)
    launches = read_launches()
    m = _agreement_sim(names, two_groups(0.0), SIM_HW, 4)
    st = eng.stats
    log(f"  [sim] two groups: engine finished "
        f"{sum(r.finished() for r in reqs_e)}, evictions {st.evictions}, "
        f"swaps {st.model_swaps}; simulator completed {m['completed']}, "
        f"evictions {m['evictions']}, swaps {m['swaps']} (the cold load "
        f"included); launches {({k: n for k, n in launches.items() if n})}")
    check(all(r.finished() for r in reqs_e) and m["completed"] == 8.0,
          "sim: two groups: not every request served")
    check(st.evictions == m["evictions"] == 0,
          "sim: two groups: eviction counts differ")
    check(m["swaps"] - 1 == st.model_swaps == 1,
          "sim: two groups: swap counts differ")
    check(launches["decode_attention"] > 0 and not any(
        n for k, n in launches.items() if k != "decode_attention"),
        f"sim: two groups: launches {launches}")

    def batch(now):
        out = []
        for _ in range(2):
            r = make_request(list(range(8)), names[0], "batch2",
                             arrival_time=now, max_new_tokens=30)
            r.true_output_tokens = 30
            out.append(r)
        return out

    def interactive(now):
        r = make_request(list(range(8)), names[0], "interactive",
                         arrival_time=now, max_new_tokens=2)
        r.true_output_tokens = 2
        return r

    reset_launches()
    now = time.monotonic()
    batch_e, inter_e = batch(now), interactive(now)
    eng = _agreement_engine(registry, batch_e, SIM_SLOW_HW, 2,
                            submit_late=(3, [inter_e]))
    launches = read_launches()
    m = _agreement_sim(names, batch(0.0) + [interactive(0.1)], SIM_SLOW_HW,
                       2)
    log(f"  [sim] head change: engine evictions {eng.stats.evictions}, "
        f"simulator evictions {m['evictions']}, simulator completed "
        f"{m['completed']}; launches "
        f"{({k: n for k, n in launches.items() if n})}")
    check(inter_e.finished() and all(r.finished() for r in batch_e)
          and m["completed"] == 3.0, "sim: head change: not every request "
                                     "served")
    check(eng.stats.evictions == int(m["evictions"]) == 1,
          "sim: head change: eviction counts differ")
    check(launches["decode_attention"] > 0 and not any(
        n for k, n in launches.items() if k != "decode_attention"),
        f"sim: head change: launches {launches}")


def sim_calibration(registry) -> None:
    """The RWT calibration against what the card serves: granite on the
    page pool calibrated by ``calibrate_from_engine``, one engine under the
    controller and agent serving the ``[drivers]`` mix (32 requests at 8/s
    in the three classes, ``async_serve.build_requests``) on the wall
    clock, and ``ClusterSimulator`` with the calibrated profile on the
    same trace.  Per class, the simulated against the served TTFT p50 /
    p99 and completion p50 with their ratio: recorded, not gated; both
    must finish every request."""
    from repro_torch.launch import async_serve
    from repro_torch.launch.serve import calibrate_registry, engine_config
    from repro_torch.sim import ClusterSimulator

    args = argparse.Namespace(**{
        **vars(SERVE_ARGS), "backend": "paged-cuda", "instances": 1,
        "requests": 32, "rate": 8.0, "batch_new_tokens": 16,
        "slo_scale": 1.0, "reschedule_cooldown": 0.5})
    names = list(registry)
    np.random.seed(0)                # calibrate_from_engine's prompts
    reset_launches()
    hw = calibrate_registry(registry, engine_config(
        args, registry[names[0]][1]["embed"].dtype))
    engines, agents, infos, controller = async_serve.build_cluster(
        args, registry, hw, names)
    pairs = async_serve.build_requests(args, names)
    t_start = time.monotonic()
    for r, off in pairs:
        r.arrival_time = t_start + off
    pending = [r for r, _ in pairs]
    served = list(pending)
    while not all(_terminal(r) for r in served):
        now = time.monotonic()
        check(now - t_start < 120.0, "sim: the served trace timed out")
        while pending and pending[0].arrival_time <= now:
            controller.submit(pending.pop(0), now)
        for inst, eng, agent in zip(infos, engines, agents):
            inst.current_model = eng.model_name
            agent.run_iteration()
        controller.tick(time.monotonic())
        if not any(e.num_active() for e in engines) and pending:
            time.sleep(min(0.01, max(0.0, pending[0].arrival_time - now)))
    wall = time.monotonic() - t_start
    launches = read_launches()
    _expect_launches("sim calibration", launches)
    check(all(r.finished() for r in served),
          "sim: the engine did not finish every request")

    simulated = []
    for r, off in async_serve.build_requests(args, names):
        r.arrival_time = off
        r.true_output_tokens = r.max_new_tokens
        simulated.append(r)
    m = ClusterSimulator([dict(hw)], "qlm",
                         max_batch_requests=args.slots).run(simulated)
    check(m["completed"] == float(len(simulated)),
          "sim: the simulator did not finish every request")
    h = hw[names[0]]
    log(f"  [sim] calibrated {names[0]} on paged-cuda: prefill_time "
        f"{h.prefill_time:.4f} s per 1k prompt tokens, decode_per_token "
        f"{h.decode_per_token:.5f} s, token_capacity {h.token_capacity}; "
        f"served {len(served)} requests in {wall:.2f} s wall, simulated "
        f"makespan {max(r.completion_time for r in simulated):.2f} s")

    def stats(reqs, cls):
        rs = [r for r in reqs if r.slo_class == cls]
        ttft = [r.ttft() for r in rs]
        done = [r.completion_time - r.arrival_time for r in rs]
        return len(rs), _pct(ttft, 50), _pct(ttft, 99), _pct(done, 50)

    for cls in async_serve.CLASSES:
        n, *got = stats(served, cls)
        _, *sim = stats(simulated, cls)
        log(f"  [sim] {cls} ({n} requests): simulated / served TTFT p50 "
            f"{sim[0]:.4f} / {got[0]:.4f} s ({sim[0] / got[0]:.3f}x), p99 "
            f"{sim[1]:.4f} / {got[1]:.4f} s ({sim[1] / got[1]:.3f}x), "
            f"completion p50 {sim[2]:.4f} / {got[2]:.4f} s "
            f"({sim[2] / got[2]:.3f}x)")


def sim_phase(registry) -> None:
    """(a) count agreement on the card, (b) the calibration against the
    served latencies, (c) ``launch.slo_benchmark`` at 200 requests: a
    simulation over the paper's A100 profiles, not a measurement."""
    from repro_torch.launch import slo_benchmark

    for label, part in (("agreement", lambda: sim_agreement(registry)),
                        ("calibration", lambda: sim_calibration(
                            {GRANITE: registry[GRANITE]}))):
        t0 = time.monotonic()
        part()
        log(f"  [sim] {label} in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    results = slo_benchmark.main(["--requests", "200"])
    check(sorted(results) == sorted(slo_benchmark.POLICIES)
          and all(m["completed"] > 0 for m in results.values()),
          "sim: slo_benchmark")
    log(f"  [sim] slo_benchmark (a simulation on the paper's A100 profiles) "
        f"in {time.monotonic() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the rest of the dense family: full width, depth cut
# ---------------------------------------------------------------------------

DENSE_FAMILY = ("qwen1.5-32b", "deepseek-67b")
# full width, depth cut to fit one card beside the pools: 16 of 64 and 16
# of 95 layers (about 20 and 25 GB of bf16 weights)
DENSE_FAMILY_LAYERS = 16
DENSE_FAMILY_INT8 = "deepseek-67b"


# chunks longer than 128 rows, where the reference's q tiles (128 rows
# here) end inside the kernel's (64 // group rows): (C, starts, valid),
# valid at most 128 in some rows, 129 and past in others
LONG_CHUNKS = (
    (256, [0, 40, 300, 7, 0, 64], [1, 100, 128, 0, 129, 256]),
    (512, [0, 40, 300, 7, 0, 64], [130, 1, 300, 0, 383, 512]))


def dense_family_kernels(cfg, quant: bool, tag: str = "dense-family",
                         dense_lengths=None) -> None:
    """The page-pool decode and prefill and the dense decode kernels (their
    int8 twins too when ``quant``) against their plain versions at the
    dense-family runs' shapes: 8 slots, 16-token pages, 8 blocks a
    sequence, 64 pages, 32-token chunks, the 128-column dense cache (or,
    with ``dense_lengths``, a cache as long as the longest), the
    arch's heads and KV heads at head_dim 128, bf16; each timed beside its
    plain version, its bound and (float) SDPA.  The prefill kernels also
    at LONG_CHUNKS, checked only.  Every prefill row is compared, the
    padding rows past valid included."""
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dtype, esize = torch.bfloat16, 2
    B, nb, N, S, C = 8, 8, 64, 128, 32
    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    lengths = [5, 40, 1, 0, 17, 33, 100, 127]
    starts = [0, 32, 0, 0, 32, 0, 64, 96]
    valid = [32, 20, 5, 0, 32, 17, 9, 31]
    live = sum(lengths)
    d_lengths = dense_lengths or lengths
    if dense_lengths:
        S = max(dense_lengths)
    failures = []
    for q8 in (False, True) if quant else (False,):
        sfx = "_quant" if q8 else ""
        p_args = prefill_case(rng, gen, dtype, starts, valid, C, q8, H=H,
                              KVH=KVH, D=D, nb=nb, N=N)
        work = prefill_work(H, D, C, starts, valid, prefill_live(p_args))
        cases = [
            ("paged_decode_attention" + sfx,
             decode_case(rng, gen, dtype, lengths, q8, H=H, KVH=KVH, D=D,
                         nb=nb, N=N),
             attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=B, kv_rows=live,
                        quant=q8, table=sum(-(-n // 16) for n in lengths),
                        ints=B), 4.0 * H * D * live),
            ("paged_prefill_attention" + sfx, p_args,
             attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=work["q_rows"],
                        out_rows=work["out_rows"], kv_rows=work["kv_rows"],
                        quant=q8, chunk_rows=work["chunk_rows"],
                        table=sum(starts) // 16, ints=2 * B),
             work["flops"]),
            ("decode_attention" + sfx,
             dense_case(rng, gen, dtype, d_lengths, S, q8, H=H, KVH=KVH,
                        D=D),
             attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=B,
                        kv_rows=sum(d_lengths), quant=q8, ints=B),
             4.0 * H * D * sum(d_lengths))]
        for name, args, nbytes, flops in cases:
            case = f"{cfg.name} H{H} KVH{KVH} D{D}"
            if name.startswith("decode_attention"):
                case += f" S{S}"
            err = check_case(failures, name, dtype, case, args)
            fn, plain = kernel_fns(name)
            b, by = bound(nbytes, flops, dtype)
            rec = {"max_abs_err": err, "ms": time_ms(lambda: fn(*args)),
                   "plain_ms": time_ms(lambda: plain(*args)),
                   "bound_ms": b, "bound_by": by}
            if name in FLOAT_DECODE:
                rec["library_ms"] = time_ms(decode_library(name, args))
            elif name == "paged_prefill_attention":
                rec["library_ms"] = time_ms(prefill_library(args, dtype))
            log(f"  [{tag}] {name} at {cfg.name}'s shapes (group "
                f"{H // KVH}, D {D}"
                f"{f', S {S}' if name.startswith('decode_attention') else ''}"
                f"): " + json.dumps(rec))
        for lc, l_starts, l_valid in LONG_CHUNKS:
            args = prefill_case(rng, gen, dtype, l_starts, l_valid, lc, q8,
                                H=H, KVH=KVH, D=D)
            check_case(failures, "paged_prefill_attention" + sfx, dtype,
                       f"{cfg.name} group {H // KVH} C{lc} live "
                       f"{prefill_live(args)}", args)
            del args
    check(not failures, f"{tag} kernels disagree: {failures}")


def dense_family_run(label, model, params, backend, chunk, kernels,
                     prompts, *, tag="dense-family", max_seq_len=128,
                     extras=None) -> list:
    """One engine on ``backend`` (``chunk`` 0, or modality ``extras``, one
    dict a prompt: the single-shot prefill) admits the prompts at once and
    decodes 16 tokens each; launch counts set to 0 just before and read
    just after: each kernel of ``kernels`` (decode kernel first, then the
    prefill kernel, if any) exactly once a layer per decode step and per
    chunk round, no other kernel.  Returns the token streams."""
    from repro_torch.core.request import Request
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    eng = ContinuousBatchingEngine(model, params, EngineConfig(
        max_slots=8, max_seq_len=max_seq_len, block_size=16,
        prefill_chunk_tokens=chunk, attention_backend=backend,
        dtype=torch.bfloat16, device="cuda"), model_name="m")
    reqs = [Request(prompt_tokens=p, model="m", slo=1e9, max_new_tokens=16)
            for p in prompts]
    reset_launches()
    t0 = time.monotonic()
    for i, r in enumerate(reqs):
        check(eng.admit(r, extras=extras[i] if extras else None),
              f"{label}: not admitted")
    for _ in range(300):
        eng.step()
        if all(r.finished() for r in reqs):
            break
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    s, L = eng.stats, model.cfg.num_layers
    want = dict.fromkeys(KERNELS, 0)
    for name, per in zip(kernels, (s.decode_iterations, s.prefill_chunks)):
        want[name] = L * per
    log(f"  [{tag}] {label}: {s.prefills} prefills, "
        f"{s.prefill_chunks} chunk rounds, {s.decode_iterations} decode "
        f"steps in {wall:.2f} s (prefill {s.prefill_time:.3f} s, decode "
        f"{s.decode_time:.3f} s); launches "
        f"{({k: n for k, n in launches.items() if n})}")
    check(launches == want, f"{label}: launches {launches} != {want}")
    chunked = chunk > 0 and not extras
    check(s.prefill_chunks > 0 if chunked else s.prefill_chunks == 0,
          f"{label}: chunk rounds {s.prefill_chunks}")
    vocab = model.cfg.vocab_size
    check(all(r.finished() and len(r.output_tokens) == 16
              and all(0 <= t < vocab for t in r.output_tokens)
              for r in reqs), f"{label}: tokens")
    check(eng.block_mgr.used_blocks == 0, f"{label}: KV blocks leaked")
    return [r.output_tokens for r in reqs]


def dense_family_phase() -> None:
    """qwen1.5-32b (40 heads on 40, QKV bias) and deepseek-67b (64 heads on
    8) at full width, depth cut to DENSE_FAMILY_LAYERS, bf16, one after
    the other (each freed before the next): the kernels at their shapes
    against the plain versions, then 8 requests through chunked prefill
    on the page pool and 8 through the single-shot prefill on the dense
    backend, whose tokens may part only at near ties; deepseek also with
    int8 KV on both."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    rng = np.random.default_rng(4)
    for seed, arch in enumerate(DENSE_FAMILY):
        t0 = time.monotonic()
        full = get_arch(arch)
        cfg = dataclasses.replace(full, num_layers=DENSE_FAMILY_LAYERS)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(10 + seed)
        params = model.init(gen, torch.bfloat16, "cuda")
        if cfg.qkv_bias:               # zero at init: make them count
            for bp in params["blocks"]:
                for b in ("bq", "bk", "bv"):
                    bp["attn"][b].normal_(0.0, 0.5, generator=gen)
        torch.cuda.synchronize()
        log(f"  [dense-family] {arch}: {cfg.num_layers} of "
            f"{full.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads} heads on {cfg.num_kv_heads}, head_dim "
            f"{cfg.resolved_head_dim}, qkv_bias {cfg.qkv_bias}, "
            f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params "
            f"bf16, memory_allocated {torch.cuda.memory_allocated() / 1e9:.2f}"
            f" GB; init in {time.monotonic() - t0:.1f} s")
        quant = arch == DENSE_FAMILY_INT8
        dense_family_kernels(cfg, quant)
        vocab = cfg.vocab_size
        prompts = [rng.integers(0, vocab, size=int(n)).tolist()
                   for n in rng.integers(4, 60, size=8)]
        runs = [
            dense_family_run(f"{arch} paged-cuda chunked", model, params,
                             "paged-cuda", 32,
                             ("paged_decode_attention",
                              "paged_prefill_attention"), prompts),
            dense_family_run(f"{arch} cuda single-shot", model, params,
                             "cuda", 0, ("decode_attention",), prompts)]
        found = check_partings(arch, model, params,
                               list(zip(prompts, *runs)))
        log(f"  [dense-family] {arch}: chunked page-pool vs single-shot "
            f"dense tokens: {len(prompts) - len(found)} of {len(prompts)} "
            f"equal, {len(found)} part at near ties")
        if quant:
            qmodel = build_model(dataclasses.replace(cfg, kv_quant=True))
            q_runs = [
                dense_family_run(f"{arch} int8 paged-cuda chunked", qmodel,
                                 params, "paged-cuda", 32,
                                 ("paged_decode_attention_quant",
                                  "paged_prefill_attention_quant"), prompts),
                dense_family_run(f"{arch} int8 cuda single-shot", qmodel,
                                 params, "cuda", 0,
                                 ("decode_attention_quant",), prompts)]
            log(f"  [dense-family] {arch} int8: chunked vs single-shot "
                f"tokens equal in "
                f"{sum(a == b for a, b in zip(*q_runs))} of {len(prompts)}"
                f" requests (the chunked run reads its first chunk back as "
                f"int8, the single-shot prefill attends float keys)")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  [dense-family] {arch} in {time.monotonic() - t0:.1f} s")


MOE_VLM = ("qwen3-moe-30b-a3b", "dbrx-132b", "llava-next-34b")
# full width; depth cut only where one card cannot hold it beside the run:
# qwen3-moe whole (48 layers, 30.5 B params, ~61 GB of bf16); dbrx 8 of
# 40 layers (27.3 B, ~55 GB; whole it is 131.6 B, ~263 GB); llava 48 of 60
# layers (27.8 B, ~56 GB; whole it is 34.4 B, ~69 GB, too close to 80 GB
# beside the plain single-shot prefill's (1, 56, ~2900, ~2900) f32 scores)
MOE_VLM_LAYERS = {"qwen3-moe-30b-a3b": 48, "dbrx-132b": 8,
                  "llava-next-34b": 48}
# llava's dense cache: 2880 patch tokens + up to 60 prompt tokens + 16 new
VLM_MAX_SEQ = 3008


def _init_cut(arch: str, seed: int, tag: str):
    """``arch`` at full width with its depth cut to MOE_VLM_LAYERS (whole
    for an arch not listed there), bf16 weights from a seeded generator;
    logs the cut, the parameter count and ``memory_allocated``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    t0 = time.monotonic()
    full = get_arch(arch)
    cfg = dataclasses.replace(full, num_layers=MOE_VLM_LAYERS.get(
        arch, full.num_layers))
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20 + seed)
    params = model.init(gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    moe = cfg.moe
    log(f"  [{tag}] {arch}: {cfg.num_layers} of {full.num_layers} layers "
        f"(depth cut: {full.num_layers != cfg.num_layers}), d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads on {cfg.num_kv_heads} (group "
        f"{cfg.num_heads // cfg.num_kv_heads}), head_dim "
        f"{cfg.resolved_head_dim}"
        + (f", {moe.num_experts} experts top {moe.experts_per_token} of "
           f"width {moe.d_ff_expert}, capacity_factor {moe.capacity_factor}"
           if moe else "")
        + (f", {cfg.vision.num_patch_tokens} patch tokens" if cfg.vision
           else "")
        + (f", {cfg.ssm.num_heads(cfg.d_model)} SSD heads of "
           f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk "
           f"{cfg.ssm.chunk_size}, attention every {cfg.hybrid_attn_every} "
           f"layers" if cfg.ssm else "")
        + (f", encoder {cfg.encoder.num_layers} layers over "
           f"{cfg.encoder.num_frames} frames" if cfg.encoder else "")
        + f", {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params "
        f"bf16 ({cfg.param_count() / 1e9:.3f} B by the config, "
        f"{full.param_count() / 1e9:.3f} B at full depth), "
        f"memory_allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB; "
        f"init in {time.monotonic() - t0:.1f} s")
    return cfg, model, params, gen


def moe_step_timing(tag, label, model, params) -> None:
    """Informational: one decode step at 8 slots x 40 tokens on the page
    pool, device time from CUDA-graph replays against the eager call,
    beside its weight-read bound: the dense expert products read every
    expert's weights each step, as the reference's einsums do, so the
    bound is every weight but the embedding table (8 rows of it) over the
    memory rate."""
    B, bs, nb = 8, 16, 8
    cache = model.init_paged_cache(B * nb, bs, torch.bfloat16, "cuda")
    bt = torch.arange(B * nb, dtype=torch.int32, device="cuda").reshape(B, nb)
    tokens = torch.arange(B, dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), 40, dtype=torch.int32, device="cuda")
    fn = lambda: model.decode_step_paged.eager(params, cache, tokens, lengths,
                                               bt)
    device = time_ms(fn, iters=3, replays=3)
    eager = eager_ms(fn, iters=5)
    nbytes = sum(t.numel() * t.element_size() for name, t in params.items()
                 if name not in ("embed", "blocks"))
    nbytes += sum(t.numel() * t.element_size()
                  for t in _leaves(params["blocks"]))
    b = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  [{tag}] {label} decode step (8 x 40, page pool): device "
        f"{device:.3f} ms, eager {eager:.3f} ms, host share "
        f"{1 - device / eager:.3f}; weight-read bound {b:.3f} ms "
        f"({nbytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
        f"device / bound {device / b:.2f}")
    del cache
    torch.cuda.empty_cache()


def _differ(runs) -> list:
    """Index of each request whose two token streams differ, with where."""
    return [(i, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y))
            for i, (a, b) in enumerate(zip(*runs)) if a != b]


def _drop_counting(model, calls):
    """``model`` with each serving path appending to ``calls``, per call,
    its kind and the (token, choice) pairs its MoE layers dropped for
    capacity, summed over the layers, per row of its batch (B, L), zero on
    rows that hold no real token (a chunk round's rows at or past valid).
    Reads the keep masks that ``_dispatch_slots`` gives inside
    ``_keeps_recorded``."""
    k = model.cfg.moe.experts_per_token

    def rec(name, fn):
        def run(*args):
            del _KEEPS[:]
            out = fn(*args)
            tokens = args[1]["tokens"] if name == "prefill" else args[2]
            B, L = tokens.shape[0], (tokens.shape[1] if tokens.dim() == 2
                                     else 1)
            drops = (~torch.cat(_KEEPS)).view(-1, B * L, k).sum((0, 2))
            drops = drops.view(B, L)
            if name.startswith("prefill_chunk"):
                drops = drops * (torch.arange(L, device=drops.device)[None]
                                 < args[4][:, None])
            calls.append((name, drops))
            return out
        return run
    fns = {name: getattr(model, name) for name in (
        "prefill", "prefill_chunk", "decode_step", "prefill_chunk_paged",
        "decode_step_paged") if getattr(model, name) is not None}
    # a decode step replayed from its CUDA graph runs no Python, so it
    # gives no keep masks: the step runs op by op here
    fns["decode_step_paged"] = model.decode_step_paged.eager
    return dataclasses.replace(model, **{name: rec(name, fn)
                                         for name, fn in fns.items()})


_KEEPS = []


@contextlib.contextmanager
def _keeps_recorded():
    """Within: every ``moe._dispatch_slots`` call appends its keep mask
    (device tensor, no sync) to _KEEPS."""
    from repro_torch.models import moe

    dispatch = moe._dispatch_slots

    def recorded(*args):
        keep, slot = dispatch(*args)
        _KEEPS.append(keep)
        return keep, slot

    moe._dispatch_slots = recorded
    try:
        yield
    finally:
        moe._dispatch_slots = dispatch
        del _KEEPS[:]


def moe_drops(label, runs, n) -> list:
    """Each request's dropped (token, choice) pairs in each of ``runs``
    (label, calls of ``_drop_counting``), logged with each run's first
    prefill: a chunk round's row b and a decode step's row b are slot b,
    which request b holds (all were admitted at once into an empty
    engine); the single-shot prefills come one a request, in admission
    order.  Returns the per-request totals of each run."""
    totals = []
    for run, calls in runs:
        per = [0] * n
        shots = 0
        for name, drops in calls:
            rows = drops.sum(1).tolist()
            if name == "prefill":
                per[shots] += int(rows[0])
                shots += 1
            else:
                for b in range(min(n, len(rows))):
                    per[b] += int(rows[b])
        first = calls[0][1]
        log(f"  [moe-vlm] {label} {run}: first prefill ({calls[0][0]}, "
            f"batch {tuple(first.shape)}) dropped {int(first.sum())} "
            f"(token, choice) pairs on its real rows; dropped pairs a "
            f"request over the run (prefill and decode): {per}")
        totals.append(per)
    return totals


def qwen3_runs(tag, arch, cfg, model, params, prompts, paged) -> None:
    """qwen3-moe's serve runs: 8 requests chunked (32 tokens) on the page
    pool, twice (tokens bitwise equal: the MoE combine is ordered, no
    atomics), and through the single-shot prefill on the dense backend,
    each logging the (token, choice) pairs its MoE layers dropped for
    capacity.  With capacity-bounded routing a token's experts depend on
    every token routed beside it (a 32-token chunk round of 8 rows routes
    256 tokens at capacity 20, a single-shot prefill of L tokens L at
    capacity 8), so those two runs may part without a near tie, and are
    not gated.  Then both again with the capacity unbounded
    (``capacity_factor`` E / k: capacity T, no pair can drop, which the
    counts confirm): there a token's output depends on its own routing
    only, and the runs may part only at near ties (``check_partings``)."""
    from repro_torch.models import build_model

    def runs(label, m):
        calls = [[], []]
        with _keeps_recorded():
            out = [dense_family_run(f"{arch} paged-cuda chunked{label}",
                                    _drop_counting(m, calls[0]), params,
                                    "paged-cuda", 32, paged, prompts,
                                    tag=tag),
                   dense_family_run(f"{arch} cuda single-shot{label}",
                                    _drop_counting(m, calls[1]), params,
                                    "cuda", 0, ("decode_attention",),
                                    prompts, tag=tag)]
        drops = moe_drops(f"{arch}{label}", [
            ("paged-cuda chunked", calls[0]),
            ("cuda single-shot", calls[1])], len(prompts))
        return out, drops

    (chunked, single), drops = runs("", model)
    replay = dense_family_run(f"{arch} paged-cuda chunked (replay)", model,
                              params, "paged-cuda", 32, paged, prompts,
                              tag=tag)
    check(replay == chunked,
          f"{arch}: a replay of the chunked run gave other tokens")
    parts = _differ([chunked, single])
    log(f"  [{tag}] {arch}: chunked replay tokens equal; chunked page-pool "
        f"vs single-shot dense tokens equal in "
        f"{len(prompts) - len(parts)} of {len(prompts)} requests; "
        f"(request, first differing token, dropped pairs chunked / "
        f"single-shot) {[(i, j, drops[0][i], drops[1][i]) for i, j in parts]}"
        f": not gated, capacity-bounded routing depends on the batch")
    moe = cfg.moe
    unbounded = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.experts_per_token)))
    u_runs, u_drops = runs(", capacity unbounded", unbounded)
    check(not any(map(any, u_drops)),
          f"{arch}: pairs dropped at unbounded capacity: {u_drops}")
    found = check_partings(f"{arch} capacity unbounded", unbounded, params,
                           list(zip(prompts, *u_runs)))
    log(f"  [{tag}] {arch}, capacity unbounded: chunked page-pool vs "
        f"single-shot dense tokens: {len(prompts) - len(found)} of "
        f"{len(prompts)} equal, {len(found)} part at near ties")


def moe_vlm_phase() -> None:
    """qwen3-moe-30b-a3b (whole), dbrx-132b and llava-next-34b (full width,
    depth cut), bf16, one after the other, each freed before the next:
    the attention kernels at their shapes (GQA groups 8, 6, 7; head_dim
    128) against their plain versions, timed; then their serve paths with
    the launch counts set to 0 just before and read just after, each
    kernel exactly once a layer per decode step and chunk round.

    qwen3-moe: ``qwen3_runs``, chunked on the page pool and single-shot on
    the dense backend, at the config's capacity and unbounded.  dbrx: the
    same 8 requests chunked on float and on int8 pages.  llava: 4 requests with random patch embeddings through
    ``admit(..., extras=...)`` on the dense backend, single-shot; the page
    pool refuses them."""
    from repro_torch.core.request import Request
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    tag = "moe-vlm"
    rng = np.random.default_rng(7)
    for seed, arch in enumerate(MOE_VLM):
        t0 = time.monotonic()
        cfg, model, params, gen = _init_cut(arch, seed, tag)
        extras = None
        vocab = cfg.vocab_size
        if cfg.vision is None:
            prompts = [rng.integers(0, vocab, size=int(n)).tolist()
                       for n in rng.integers(4, 60, size=8)]
        else:
            prompts = [rng.integers(0, vocab, size=int(n)).tolist()
                       for n in rng.integers(4, 60, size=4)]
        paged = ("paged_decode_attention", "paged_prefill_attention")
        if arch == "qwen3-moe-30b-a3b":
            dense_family_kernels(cfg, False, tag)
            qwen3_runs(tag, arch, cfg, model, params, prompts, paged)
            moe_step_timing(tag, arch, model, params)
        elif arch == "dbrx-132b":
            dense_family_kernels(cfg, True, tag)
            dense_family_run(f"{arch} paged-cuda chunked", model, params,
                             "paged-cuda", 32, paged, prompts, tag=tag)
            qmodel = build_model(dataclasses.replace(cfg, kv_quant=True))
            dense_family_run(f"{arch} int8 paged-cuda chunked", qmodel,
                             params, "paged-cuda", 32,
                             ("paged_decode_attention_quant",
                              "paged_prefill_attention_quant"), prompts,
                             tag=tag)
            moe_step_timing(tag, arch, model, params)
        else:
            P = cfg.vision.num_patch_tokens
            dense_family_kernels(cfg, False, tag, dense_lengths=[
                P + 20, P + 75, P, 0, VLM_MAX_SEQ, 1, P + 119, P + 4])
            extras = [{"patch_embeds": torch.randn(
                (P, cfg.d_model), generator=gen, device="cuda"
            ).mul_(0.02).to(torch.bfloat16)} for _ in prompts]
            out = dense_family_run(
                f"{arch} cuda single-shot with patch embeddings", model,
                params, "cuda", 32, ("decode_attention",), prompts, tag=tag,
                max_seq_len=VLM_MAX_SEQ, extras=extras)
            log(f"  [{tag}] {arch}: first tokens "
                f"{[t[:4] for t in out]}; memory_allocated "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            pool = ContinuousBatchingEngine(model, params, EngineConfig(
                max_slots=1, max_seq_len=64, block_size=16, kv_blocks=4,
                attention_backend="paged-cuda", dtype=torch.bfloat16,
                device="cuda"), model_name="m")
            r = Request(prompt_tokens=prompts[0], model="m", slo=1e9,
                        max_new_tokens=4)
            r.extras = extras[0]
            check(not pool.can_admit(r), f"{arch}: the page pool took "
                                         f"a request with extras")
            try:
                pool.admit(Request(prompt_tokens=prompts[0], model="m",
                                   slo=1e9, max_new_tokens=4),
                           extras=extras[0])
                refused = False
            except ValueError:
                refused = True
            check(refused, f"{arch}: paged admit(extras=...) did not raise")
            log(f"  [{tag}] {arch}: paged-cuda refuses the request with "
                f"patch embeddings (can_admit false, admit ValueError)")
            del pool
        del model, params, extras
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"  [{tag}] {arch} in {time.monotonic() - t0:.1f} s")


HYBRID_ENCDEC = ("zamba2-1.2b", "whisper-medium")
# both whole, at full width and depth.  zamba2's dense caches hold its
# longest prompt (512) and 16 new tokens, plus room; whisper's decoder
# caches hold prompts of up to 32 tokens and 16 new ones, far below its
# 1500 frames, whose cross K/V each slot keeps whole
ZAMBA_MAX_SEQ, WHISPER_MAX_SEQ = 544, 64
ZAMBA_PROMPTS = (16, 40, 77, 128, 200, 333, 450, 512)


def _site_launches(cfg) -> int:
    """Dense decode launches per decode step: one per attention site of
    the hybrid, one per decoder layer of the encoder-decoder."""
    from repro_torch.models.hybrid import attn_sites
    return len(attn_sites(cfg)) if cfg.arch_type == "hybrid" \
        else cfg.num_layers


def _param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def hybrid_encdec_kernels(tag, cfg, lengths, S, ssd_lengths=()) -> None:
    """The dense decode kernel and its int8 twin at the run's shape (8
    slots, group 1, head_dim 64, a cache of ``S`` columns, the run's
    kv lengths) and, for the hybrid, the SSD scan at its single-shot
    prefill's shape (1, L, 64 heads of 64, N 64, chunk 64, zero state in,
    the final state out) for each padded prompt length in
    ``ssd_lengths``: each against its plain version, bf16, and timed
    beside its bound and (float decode) SDPA."""
    from repro_torch.kernels import ssd_scan as ss

    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dtype, esize = torch.bfloat16, 2
    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    failures = []
    for q8 in (False, True):
        name = "decode_attention" + ("_quant" if q8 else "")
        args = dense_case(rng, gen, dtype, lengths, S, q8, H=H, KVH=KVH,
                          D=D)
        err = check_case(failures, name, dtype,
                         f"{cfg.name} H{H} KVH{KVH} D{D} S{S}", args)
        fn, plain = kernel_fns(name)
        b, by = bound(attn_bytes(esize, H=H, KVH=KVH, D=D, q_rows=len(lengths),
                                 kv_rows=sum(lengths), quant=q8,
                                 ints=len(lengths)),
                      4.0 * H * D * sum(lengths), dtype)
        rec = {"max_abs_err": err, "ms": time_ms(lambda: fn(*args)),
               "plain_ms": time_ms(lambda: plain(*args)),
               "bound_ms": b, "bound_by": by,
               "library_ms": time_ms(decode_library(name, args))
               if not q8 else None}
        if q8:
            rec["two_calls_ms"] = time_ms(decode_two_calls(name, args))
        log(f"  [{tag}] {name} at {cfg.name}'s shape (8 slots, group "
            f"{H // KVH}, D {D}, S {S}, lengths {list(lengths)}): "
            + json.dumps(rec))
    if cfg.ssm is not None:
        s = cfg.ssm
        H_s, P, N, Q = s.num_heads(cfg.d_model), s.head_dim, s.d_state, \
            s.chunk_size
        for L in sorted(set(ssd_lengths)):
            x, dt, A, Bm, Cm, _ = ssd_case(gen, dtype, 1, L, H_s, P,
                                           s.n_groups, N)
            args = (x, dt, A, Bm, Cm, Q, None)
            y, h = ss.ssd_scan(*args, return_state=True)
            want_y, want_h = ss.ssd_scan_plain(*args, return_state=True)
            err, ok = compare(y, want_y, dtype, tol=SSD_TOL)
            h_err, h_ok = compare(h, want_h, torch.float32, tol=SSD_TOL)
            torch.cuda.synchronize()
            case = f"{cfg.name} (1,{L},{H_s},{P},{s.n_groups},{N},{Q})"
            log(f"  {'ssd_scan':30s} {str(dtype):15s} {case:32s} "
                f"max_abs_err y {err:.3e} final state {h_err:.3e} "
                f"{'ok' if ok and h_ok else 'FAIL'}")
            if not (ok and h_ok):
                failures.append(("ssd_scan", str(dtype), case))
            if L in (min(ssd_lengths), max(ssd_lengths)):
                b, by = ssd_bound(dtype, 1, L, H_s, P, s.n_groups, N, Q,
                                  esize, state_in=False)
                rec = {"max_abs_err": err,
                       "ms": time_ms(lambda: ss.ssd_scan(
                           *args, return_state=True)),
                       "plain_ms": time_ms(lambda: ss.ssd_scan_plain(
                           *args, return_state=True)),
                       "bound_ms": b, "bound_by": by, "library_ms": None}
                log(f"  [{tag}] ssd_scan at {cfg.name}'s prefill shape L "
                    f"{L}, bf16, zero state in, final state out: "
                    + json.dumps(rec))
    check(not failures, f"{tag} kernels disagree: {failures}")


def _calibrate(model, params, ecfg, name):
    """The controller's profile of ``model``: ``calibrate_from_engine`` on
    a throwaway engine.  Its prompts carry no extras, so an
    encoder-decoder is calibrated through a model whose prefill adds zero
    frames (its encoder then costs what real frames cost)."""
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.sim import calibrate_from_engine

    if model.cfg.encoder is not None:
        F = model.cfg.encoder.num_frames

        def prefill(p, batch, cache, _inner=model.prefill):
            if "frame_embeds" not in batch:
                batch = {**batch, "frame_embeds": torch.zeros(
                    (batch["tokens"].shape[0], F, model.cfg.d_model),
                    dtype=params["embed"].dtype, device="cuda")}
            return _inner(p, batch, cache)
        model = dataclasses.replace(model, prefill=prefill)
    np.random.seed(0)                # calibrate_from_engine's prompts
    eng = ContinuousBatchingEngine(model, params, ecfg, model_name=name)
    return calibrate_from_engine(
        eng, token_capacity=ecfg.resolved_kv_blocks() * ecfg.block_size)


def controlled_run(tag, label, model, params, prompts, extras, max_seq,
                   hw, direct=2) -> tuple:
    """One dense (``"cuda"``) engine of 8 slots under the port's
    controller and agent with the profile ``hw``: the first ``direct``
    requests enter through ``admit(..., extras=...)``, the rest through
    the controller, carrying their extras in ``req.extras`` for the
    agent's pulls; launch counts set to 0 just before and read just
    after.  Every request must reach a terminal state and be served; the
    dense decode kernel (int8 twin for ``kv_quant``) launches exactly
    once a site (a decoder layer) per decode step, the SSD scan once a
    layer per single-shot admission, no other kernel.  Returns (token
    streams, launches, engine stats)."""
    from repro_torch.core.global_scheduler import InstanceInfo
    from repro_torch.core.lso import QLMAgent
    from repro_torch.core.qlm import QLMConfig, QLMController
    from repro_torch.core.request import Request
    from repro_torch.core.virtual_queue import VirtualQueue
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    cfg = model.cfg
    name = cfg.name
    eng = ContinuousBatchingEngine(model, params, EngineConfig(
        max_slots=8, max_seq_len=max_seq, attention_backend="cuda",
        dtype=torch.bfloat16, device="cuda"), model_name=name)
    vq = VirtualQueue(0)
    agent = QLMAgent(eng, vq, {name: (model, params)})
    info = InstanceInfo(0, {name: hw}, name, vq)
    controller = QLMController([info], QLMConfig(avg_batch_size=8))
    reqs = [Request(prompt_tokens=list(p), model=name, slo=300.0,
                    max_new_tokens=16,
                    extras=None if i < direct or ex is None else ex)
            for i, (p, ex) in enumerate(zip(prompts, extras))]
    reset_launches()
    t0 = time.monotonic()
    for i, r in enumerate(reqs[:direct]):
        check(eng.admit(r, extras=extras[i]), f"{label}: not admitted")
    for r in reqs[direct:]:
        controller.submit(r, time.monotonic())
    for _ in range(2000):
        info.current_model = eng.model_name
        agent.run_iteration()
        controller.tick(time.monotonic())
        if all(_terminal(r) for r in reqs):
            break
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    s = eng.stats
    want = dict.fromkeys(KERNELS, 0)
    want["decode_attention_quant" if cfg.kv_quant else "decode_attention"] \
        = _site_launches(cfg) * s.decode_iterations
    if cfg.ssm is not None:
        want["ssd_scan"] = cfg.num_layers * s.prefills
    log(f"  [{tag}] {label}: {s.prefills} single-shot admissions "
        f"({direct} by admit(..., extras=...)), {s.decode_iterations} decode "
        f"steps, {s.evictions} evictions, {s.resumes} resumes in {wall:.2f} "
        f"s (prefill {s.prefill_time:.3f} s, decode {s.decode_time:.3f} "
        f"s); launches {({k: n for k, n in launches.items() if n})}")
    check(all(_terminal(r) for r in reqs), f"{label}: a request is not "
                                           f"terminal")
    check(all(r.finished() and len(r.output_tokens) == 16
              and all(0 <= t < cfg.vocab_size for t in r.output_tokens)
              for r in reqs), f"{label}: not every request served")
    check(launches == want, f"{label}: launches {launches} != {want}")
    check(eng.block_mgr.used_blocks == 0, f"{label}: KV blocks leaked")
    return [r.output_tokens for r in reqs], launches, s


def evict_resume_run(tag, label, model, params, prompts, extras,
                     max_seq) -> None:
    """The eight requests on one dense engine, uninterrupted, then again
    with two requests (slots 2 and 5) evicted after four decode steps and
    resumed in each other's slot: each must give the uninterrupted run's
    tokens, so every leaf of a slot (an encoder-decoder's cross K/V of
    every frame at ``max_seq`` below the frame count) went out and came
    back whole."""
    from repro_torch.core.request import Request
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    runs = []
    for evict in (False, True):
        eng = ContinuousBatchingEngine(model, params, EngineConfig(
            max_slots=8, max_seq_len=max_seq, attention_backend="cuda",
            dtype=torch.bfloat16, device="cuda"), model_name="m")
        reqs = [Request(prompt_tokens=list(p), model="m", slo=1e9,
                        max_new_tokens=16, extras=ex)
                for p, ex in zip(prompts, extras)]
        for r in reqs:
            check(eng.admit(r), f"{label}: not admitted")
        for _ in range(4):
            eng.step()
        if evict:
            a, b = reqs[2], reqs[5]
            check(eng.slots.index(a) == 2 and eng.slots.index(b) == 5,
                  f"{label}: slots")
            eng.evict_request(a.req_id)
            eng.evict_request(b.req_id)
            check(eng.admit(b) and eng.admit(a), f"{label}: not resumed")
            check(eng.slots.index(b) == 2 and eng.slots.index(a) == 5,
                  f"{label}: the resumes did not trade slots")
        for _ in range(100):
            eng.step()
            if all(r.finished() for r in reqs):
                break
        check(all(r.finished() for r in reqs), f"{label}: not finished")
        runs.append(([r.output_tokens for r in reqs], eng.stats.resumes))
    (plain, _), (got, resumes) = runs
    log(f"  [{tag}] {label}: two requests evicted after 4 decode steps and "
        f"resumed in each other's slot ({resumes} resumes): tokens equal "
        f"to the uninterrupted run's: {got == plain}")
    check(resumes == 2 and got == plain,
          f"{label}: evicted and resumed tokens {got} != {plain}")


def hybrid_encdec_timings(tag, cfg, model, params, max_seq, admission):
    """Informational: one decode step at 8 slots x 40 tokens, device time
    from CUDA-graph replays against the eager call, beside what it must
    read: every weight it uses (the hybrid's shared block once per site,
    as it does not stay in the 50 MB L2; the encoder-decoder's decoder and
    embedding) and the state it reads and writes (the hybrid's SSM states
    and conv histories; the cross K/V of every slot); and one single-shot
    admission (``admission``: (label, batch)) timed the same way."""
    B = 8
    cache = model.init_cache(B, max_seq, torch.bfloat16, "cuda")
    tokens = torch.arange(B, dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), 40, dtype=torch.int32, device="cuda")
    step = lambda: model.decode_step(params, cache, tokens, lengths)
    device = time_ms(step, iters=3, replays=3)
    eager = eager_ms(step, iters=5)
    if cfg.arch_type == "hybrid":
        nbytes = _param_bytes(params) + (_site_launches(cfg) - 1) \
            * _param_bytes(params["shared_attn"])
        nbytes += 2 * (cache["ssm"].numel() * 4
                       + cache["conv"].numel() * cache["conv"].element_size())
    else:
        nbytes = sum(_param_bytes(params[k]) for k in (
            "embed", "dec_blocks", "final_s", "final_b"))
        nbytes += 2 * cache["cross_k"].numel() * cache["cross_k"].element_size()
    kv = cache["kv"] if cfg.arch_type == "hybrid" else cache["self"]
    nbytes += 2 * kv["k"][:, :, :, :41].numel() * kv["k"].element_size()
    b = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  [{tag}] {cfg.name} decode step (8 x 40, dense): device "
        f"{device:.3f} ms, eager {eager:.3f} ms, host share "
        f"{1 - device / eager:.3f}; read bound {b:.3f} ms ({nbytes / 1e9:.3f}"
        f" GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), device / bound "
        f"{device / b:.2f}")
    del cache
    label, batch = admission
    cache1 = model.init_cache(1, max_seq, torch.bfloat16, "cuda")
    fill = lambda: model.prefill(params, batch, cache1)
    device = time_ms(fill, iters=2, replays=3)
    eager = eager_ms(fill, iters=5)
    log(f"  [{tag}] {cfg.name} single-shot admission, {label}: device "
        f"{device:.3f} ms, eager {eager:.3f} ms, host share "
        f"{1 - device / eager:.3f}")
    del cache1
    torch.cuda.empty_cache()


def _refusals(tag, model, params, extras) -> None:
    """The page pool refuses the family at construction and at a swap
    (before anything is flushed), and refuses a request with frames (a
    reduced granite holds the pool)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.request import Request
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    ecfg = EngineConfig(max_slots=2, max_seq_len=64, block_size=16,
                        kv_blocks=8, attention_backend="paged-cuda",
                        dtype=torch.bfloat16, device="cuda")
    try:
        ContinuousBatchingEngine(model, params, ecfg, model_name="m")
        refused = False
    except ValueError:
        refused = True
    check(refused, f"{model.cfg.name}: the page pool took it")
    g = build_model(get_arch(GRANITE).reduced(num_layers=1, d_model=64))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    pool = ContinuousBatchingEngine(g, g.init(gen, torch.bfloat16, "cuda"),
                                    ecfg, model_name="m")
    r = Request(prompt_tokens=[1, 2, 3], model="m", slo=1e9,
                max_new_tokens=4)
    check(pool.admit(r), "granite not admitted")
    try:
        pool.swap_model(model, params, "w")
        refused = False
    except ValueError:
        refused = True
    check(refused and pool.num_active() == 1,
          f"{model.cfg.name}: the page pool swapped to it")
    if extras is not None:
        w = Request(prompt_tokens=[1, 2, 3], model="m", slo=1e9,
                    max_new_tokens=4, extras=extras)
        check(not pool.can_admit(w), "the page pool took frames")
        try:
            pool.admit(Request(prompt_tokens=[1, 2, 3], model="m", slo=1e9,
                               max_new_tokens=4), extras=extras)
            refused = False
        except ValueError:
            refused = True
        check(refused, "paged admit(extras=...) did not raise")
    log(f"  [{tag}] paged-cuda refuses {model.cfg.name} at construction and "
        f"at a swap (nothing flushed)"
        + (", and a request with frames (can_admit false, admit "
           "ValueError)" if extras is not None else ""))


def hybrid_encdec_phase() -> dict:
    """zamba2-1.2b and whisper-medium whole (full width and depth), bf16,
    random weights from a seed, one after the other, each freed before
    the next: the kernels at their shapes, then 8 requests through the
    controller and agent on the dense backend (zamba2 twice in float,
    bitwise equal, and once with int8 KV; whisper with random frames of
    (1500, 1024) on every request), the eviction check, the page pool's
    refusals, and the step and admission times.  Returns the launches of
    the controlled runs, summed per kernel."""
    from repro_torch.models import build_model

    tag = "hybrid-encdec"
    rng = np.random.default_rng(22)
    total = dict.fromkeys(KERNELS, 0)
    for seed, arch in enumerate(HYBRID_ENCDEC):
        t0 = time.monotonic()
        cfg, model, params, gen = _init_cut(arch, 10 + seed, tag)
        vocab = cfg.vocab_size
        if cfg.arch_type == "hybrid":
            max_seq = ZAMBA_MAX_SEQ
            prompts = [rng.integers(0, vocab, size=n).tolist()
                       for n in ZAMBA_PROMPTS]
            extras = [None] * len(prompts)
            Q = cfg.ssm.chunk_size
            ssd_lengths = [-(-n // Q) * Q for n in ZAMBA_PROMPTS]
            admission = ("512 tokens", {"tokens": torch.arange(
                512, dtype=torch.int32, device="cuda")[None] % vocab})
        else:
            max_seq = WHISPER_MAX_SEQ
            prompts = [rng.integers(0, vocab, size=int(n)).tolist()
                       for n in rng.integers(4, 33, size=8)]
            F = cfg.encoder.num_frames
            extras = [{"frame_embeds": torch.randn(
                (F, cfg.d_model), generator=gen, device="cuda").to(
                    torch.bfloat16)} for _ in prompts]
            ssd_lengths = ()
            admission = (f"the encoder over {F} frames and a 32-token prompt",
                         {"tokens": torch.arange(32, dtype=torch.int32,
                                                 device="cuda")[None],
                          "frame_embeds": extras[0]["frame_embeds"][None]})
        lengths = [len(p) + 8 for p in prompts]
        hybrid_encdec_kernels(tag, cfg, lengths, max_seq, ssd_lengths)
        from repro_torch.serving import EngineConfig
        hw = _calibrate(model, params, EngineConfig(
            max_slots=8, max_seq_len=max_seq, attention_backend="cuda",
            dtype=torch.bfloat16, device="cuda"), cfg.name)
        log(f"  [{tag}] {cfg.name} profile (calibrate_from_engine"
            + (", zero frames added to its prompts" if cfg.encoder else "")
            + f"): prefill_time {hw.prefill_time:.4f} s per 1k tokens, "
            f"decode_per_token {hw.decode_per_token:.5f} s")
        runs = []
        variants = [("float", model)]
        if cfg.arch_type == "hybrid":
            variants += [("float replay", model),
                         ("int8 KV", build_model(dataclasses.replace(
                             cfg, kv_quant=True)))]
        for label, m in variants:
            out, launches, _ = controlled_run(
                tag, f"{arch} {label}", m, params, prompts, extras, max_seq,
                hw)
            runs.append(out)
            for k, n in launches.items():
                total[k] += n
        if cfg.arch_type == "hybrid":
            check(runs[1] == runs[0], f"{arch}: the replay is not bitwise")
            same = sum(a == b for a, b in zip(runs[0], runs[2]))
            log(f"  [{tag}] {arch}: the replay's tokens equal the first "
                f"run's; int8 KV against float: {same} of 8 requests equal "
                f"(not gated)")
        evict_resume_run(tag, f"{arch} eviction", model, params, prompts,
                         extras, max_seq)
        _refusals(tag, model, params,
                  extras[0] if cfg.encoder is not None else None)
        hybrid_encdec_timings(tag, cfg, model, params, max_seq, admission)
        log(f"  [{tag}] {arch}: memory_allocated "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del model, params, extras, admission
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"  [{tag}] {arch} in {time.monotonic() - t0:.1f} s")
    return total


def _engine_tokens(model, params, prompts) -> list:
    """Greedy tokens of ``prompts`` (12 new tokens each) from one
    page-pool engine, all admitted at once: a run that batches the same
    rows the same way every time."""
    from repro_torch.core.request import Request
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    eng = ContinuousBatchingEngine(model, params, EngineConfig(
        max_slots=len(prompts), max_seq_len=128, dtype=torch.bfloat16),
        model_name="m")
    reqs = [Request(prompt_tokens=pr, model="m", slo=1e9, max_new_tokens=12)
            for pr in prompts]
    for r in reqs:
        check(eng.admit(r), "placement check: admission refused")
    while not all(r.finished() for r in reqs):
        eng.steps()
    return [r.output_tokens for r in reqs]


def hetero_placement(registry) -> dict:
    """``serve.shard_registry`` on the card: each leaf's placement on the
    one-device mesh (a one-rank ``nccl`` group) against ``spec_for``'s,
    and 8 prompts' tokens with the placed params against those without,
    bit for bit.  Returns the placed registry."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve

    (model, params), = registry.values()
    mesh_lib.release()
    try:
        mesh = mesh_lib.make_local_mesh("cuda")
        placed = serve.placed_registry(registry, mesh)[GRANITE][1]
        specs = sh.spec_tree(mesh, params, model.param_axes(),
                             sh.ShardingRules.default())
        bad = []
        sh.map_leaves(lambda path, d, spec: None if (
            d.placements == sh.placements(mesh, spec)
            and d.to_local().is_cuda) else bad.append(path), placed, specs)
        n_leaves = sum(1 for _ in _leaves(params))
        kinds = sorted({str(d.placements) for d in _leaves(placed)})
        del placed
    finally:
        mesh_lib.release()
    check(not bad, f"hetero placement: leaves off their spec: {bad[:5]}")
    sharded = serve.shard_registry(registry)
    check(not torch.distributed.is_initialized(),
          "shard_registry left its process group")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 100, size=n).tolist()
               for n in (5, 17, 33, 9, 64, 2, 40, 21)]
    got = _engine_tokens(model, sharded[GRANITE][1], prompts)
    want = _engine_tokens(model, params, prompts)
    log(f"  [hetero] shard_registry: {n_leaves} leaves on a one-device "
        f"nccl mesh, each as spec_for places it ({kinds}); tokens of 8 "
        f"prompts with the placed params == without: {got == want}")
    check(got == want, "hetero: the placement changed the tokens")
    return sharded


def hetero_phase() -> None:
    """``serve --hetero --threaded`` over 3 instances on full-width
    granite-3-2b (bf16, page pool), launch counts set to 0 just before and
    read just after: the three tiers (slots x2 / x1 / x0.5, decode burst
    4 / 2 / 1) each calibrated once, every request terminal, no page
    leaked, only the two float paged kernels launched."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    model = build_model(get_arch(GRANITE))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    registry = {GRANITE: (model, model.init(gen, torch.bfloat16, "cuda"))}
    registry = hetero_placement(registry)
    args = argparse.Namespace(**{**vars(SERVE_ARGS), "hetero": True,
                                 "threaded": True, "instances": 3})
    tiers = []
    calibrate = serve.calibrate_registry

    def counting(reg, ecfg):
        tiers.append((ecfg.max_slots, ecfg.decode_burst))
        return calibrate(reg, ecfg)

    serve.calibrate_registry = counting
    np.random.seed(0)                # calibrate_from_engine's prompts
    try:
        reset_launches()
        stats, seen, engines = serve.run_threaded(args, registry, [GRANITE])
        launches = read_launches()
    finally:
        serve.calibrate_registry = calibrate
    log(f"  [hetero] tier calibrations (max_slots, decode_burst): {tiers}; "
        f"engines' slots {[e.cfg.max_slots for e in engines]}, bursts "
        f"{[e.cfg.decode_burst for e in engines]}, rounds "
        f"{stats['engine_rounds']}, tokens "
        f"{[e.stats.tokens_generated for e in engines]}")
    log("  [hetero] summarize: " + json.dumps(stats))
    check(tiers == [(16, 4), (8, 2), (4, 1)], f"hetero tiers {tiers}")
    check(len(seen) == 8 and all(_terminal(r) for r in seen),
          "hetero: a request is not terminal")
    check(stats["served"] >= 1, f"hetero: nothing served: {stats}")
    check(all(e.block_mgr.used_blocks == 0 for e in engines),
          "hetero: KV blocks leaked")
    _expect_launches("hetero", launches)
    del registry, engines
    gc.collect()
    torch.cuda.empty_cache()


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
    the page pool in float and int8, and on the dense backend for granite
    (chunked and single-shot prefill), for rolling-window h2o-danube
    (prompts up to 84 tokens, window 64) and for mamba2 (single-shot
    prefill through the SSD kernel); qwen1.5-32b (QKV bias, group 1) on
    the page pool and deepseek-67b (group 8) on the dense backend, both at
    head_dim 128; reduced qwen3-moe on the page pool and on the dense
    backend through the single-shot prefill, and reduced llava with patch
    embeddings on the dense backend (groups 8 and 7, head_dim 128);
    reduced zamba2 (four layers, two attention sites) and reduced whisper
    with frame embeddings on every request, on the dense backend through
    the single-shot prefill (group 1, head_dim 64).  Attention runs in
    float must give identical tokens; mamba2's and zamba2's (through the
    SSD kernel) may part only at a near tie, as an int8 run may.  An int8 run may part
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
    # the dense family at their groups (1 and 8) and head_dim 128
    qwen = get_arch("qwen1.5-32b").reduced(num_layers=2, d_model=512,
                                           num_heads=4, num_kv_heads=4)
    deepseek = get_arch("deepseek-67b").reduced(num_layers=2, d_model=1024,
                                                num_heads=8, num_kv_heads=1)
    danube = get_arch(DANUBE).reduced(**small)
    mamba = get_arch(MAMBA).reduced(num_layers=2, d_model=256)
    # MoE and VLM at their groups (8 and 7) and head_dim 128
    qwen3 = get_arch("qwen3-moe-30b-a3b").reduced(
        num_layers=2, d_model=1024, num_heads=8, num_kv_heads=1)
    llava = get_arch("llava-next-34b").reduced(
        num_layers=2, d_model=896, num_heads=7, num_kv_heads=1)
    # the hybrid (two sites) and the encoder-decoder at group 1, D 64
    zamba = get_arch("zamba2-1.2b").reduced(num_layers=4)
    whisper = get_arch("whisper-medium").reduced(num_layers=2)
    check(danube.sliding_window == 64, "reduced h2o-danube window")
    rng = np.random.default_rng(2)
    common = rng.integers(0, 100, size=24).tolist()
    prompts = [common + rng.integers(0, 100, size=n).tolist()
               for n in (5, 60, 1, 17)] + [rng.integers(0, 100, 9).tolist()]
    for label, cfg, backend, chunk in (
            ("granite, page pool", granite, "paged-cuda", 16),
            ("granite, int8 pages", dataclasses.replace(granite,
                                                        kv_quant=True),
             "paged-cuda", 16),
            ("granite, dense", granite, "cuda", 16),
            ("granite, dense single-shot prefill", granite, "cuda", 0),
            ("h2o-danube, dense rolling window", danube, "cuda", 16),
            ("qwen1.5-32b, page pool", qwen, "paged-cuda", 16),
            ("deepseek-67b, dense", deepseek, "cuda", 16),
            ("qwen3-moe-30b-a3b, page pool", qwen3, "paged-cuda", 16),
            ("qwen3-moe-30b-a3b, dense single-shot prefill", qwen3, "cuda",
             0),
            ("llava-next-34b, dense with patch embeddings", llava, "cuda",
             16),
            ("mamba2, dense single-shot prefill", mamba, "cuda", 16),
            ("zamba2-1.2b, dense single-shot prefill", zamba, "cuda", 16),
            ("whisper-medium, dense with frame embeddings", whisper, "cuda",
             16)):
        model = build_model(cfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        params = model.init(gen, torch.float32, "cuda")
        if cfg.qkv_bias:               # zero at init: make them count
            for bp in params["blocks"]:
                for b in ("bq", "bk", "bv"):
                    bp["attn"][b].normal_(0.0, 0.5, generator=gen)
        patches = [None] * len(prompts)
        if cfg.vision is not None:     # the same embeddings on both devices
            patches = [{"patch_embeds": (0.02 * rng.standard_normal(
                (cfg.vision.num_patch_tokens, cfg.d_model))).astype(
                    np.float32)} for _ in prompts]
        if cfg.encoder is not None:
            patches = [{"frame_embeds": rng.standard_normal(
                (cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)}
                for _ in prompts]
        outs = []
        for device, p in (("cuda", params),
                          ("cpu", _to_device(params, "cpu"))):
            calls = []
            eng = ContinuousBatchingEngine(
                _recording(model, calls), p, EngineConfig(
                    max_slots=4, max_seq_len=128, block_size=8,
                    prefill_chunk_tokens=chunk, decode_burst=4,
                    device=device,
                    attention_backend=backend, debug_invariants=True),
                model_name="m")
            reqs = [Request(prompt_tokens=pr, model="m", slo=1e9,
                            max_new_tokens=12, extras=ex)
                    for pr, ex in zip(prompts, patches)]
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
        check(got == want or ((cfg.kv_quant
                               or cfg.arch_type in ("ssm", "hybrid"))
                              and flip is not None),
              f"{label}: cuda {got} != cpu {want}")
        check(gs.resumes >= 1, f"{label}: the trace missed the resume")
        check(backend == "cuda" or gs.prefix_hits >= 1,
              f"{label}: the trace missed prefix sharing")


def _train_args(arch, steps, *extra):
    from repro_torch.launch import train as train_cli
    return train_cli.parse_args(["--arch", arch, "--steps", str(steps),
                                 "--log-every", "1", *extra])


# full width, f32 with AdamW (16 bytes a parameter: weights, gradients
# and two moments) and remat; the depth is cut only where that does not
# fit one card beside the activations: qwen3-moe-30b-a3b (0.62 B params
# a layer, 10 GB; 0.62 B, 10 GB of untied embedding and head) and
# llava-next-34b (0.56 B a layer, 9 GB; 0.97 B, 15 GB of embedding, head
# and projector; the plain attention backward over 3392 positions holds
# ~10 GB of f32 scores) at 4 layers.  dbrx-132b is not trained here: one
# layer holds 3.26 B params, 52 GB, and its embedding and head 20 GB
TRAIN_LAYERS = {"qwen3-moe-30b-a3b": 4, "llava-next-34b": 4}
# (arch, steps, batch, seq): the sequence counts text tokens (llava adds
# its 2880 patch tokens, whisper its 1500 frames to the encoder)
TRAIN_RUNS = ((MAMBA, 3, 2, 512), ("zamba2-1.2b", 2, 2, 512),
              ("whisper-medium", 2, 2, 448), ("qwen3-moe-30b-a3b", 2, 2, 512),
              ("llava-next-34b", 2, 1, 512))


def _train(cfg, args, params=None, extras=None) -> tuple:
    """``launch.train.train`` with the launch counts set to 0 just before
    and read just after; returns (result, counts)."""
    from repro_torch.launch import train as train_cli
    reset_launches()
    result = train_cli.train(cfg, args, params, extras)
    counts = read_launches()
    torch.cuda.synchronize()
    return result, counts


def _train_launches(cfg, steps: int) -> dict:
    """Every kernel's expected launches in ``steps`` remat steps: each
    mamba layer's SSD scan and, under the flag, each causal attention
    (a dense or MoE layer, a hybrid site, a decoder layer; an encoder's
    is bidirectional, plain ``_sdpa``) twice a step, the forward and the
    recompute; no serving kernel."""
    from repro_torch.models import hybrid

    want = dict.fromkeys(KERNELS, 0)
    if cfg.ssm is not None:
        want["ssd_scan"] = cfg.num_layers * 2 * steps
    if cfg.use_pallas_attention:
        sites = (len(hybrid.attn_sites(cfg)) if cfg.arch_type == "hybrid"
                 else 0 if cfg.arch_type == "ssm" else cfg.num_layers)
        want["flash_attention"] = sites * 2 * steps
    return want


def train_full(arch: str, steps: int, batch: int, seq: int, *,
               flag: bool = True) -> tuple:
    """``arch`` at full width (its depth cut to TRAIN_LAYERS) trained
    ``steps`` steps in f32 from the seeded weights, the memory freed and
    the peak reset just before; logs the cut, the leaf count, losses,
    gradient norms, step times, peak memory and launches, and checks the
    losses finite and the launches exact.  Returns (result, counts)."""
    from repro_torch.configs import get_arch

    full = get_arch(arch)
    cfg = dataclasses.replace(
        full, num_layers=TRAIN_LAYERS.get(arch, full.num_layers),
        use_pallas_attention=flag)
    args = _train_args(arch, steps, "--full", "--batch", str(batch),
                       "--seq", str(seq))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = _train(cfg, args)
    peak = torch.cuda.max_memory_allocated()
    res["peak_bytes"] = peak
    want = _train_launches(cfg, steps)
    log(f"  {arch} f32 B={batch} L={seq}, flag {'on' if flag else 'off'}: "
        f"{cfg.num_layers} of {full.num_layers} layers (depth cut: "
        f"{cfg.num_layers != full.num_layers}), {res['n_params'] / 1e9:.3f} "
        f"B params; losses {res['losses']}, grad norms {res['grad_norms']}, "
        f"step times (s, host clock, loss read back) {res['step_s']}, peak "
        f"memory {peak / 2**30:.2f} GiB; launches "
        f"{ {k: n for k, n in counts.items() if n} } (expected "
        f"{ {k: n for k, n in want.items() if n} })")
    check(all(np.isfinite(res["losses"])), f"{arch}: non-finite loss {res}")
    check(counts == want, f"{arch}: launches {counts} != {want}")
    return res, counts


def _same_step(label, on, off) -> None:
    """Step 0 with the flag off against the flag on: loss within 1e-4 and
    gradient norm within 1e-3, relative."""
    log(f"  {label} flag off, step 0: loss {off['losses'][0]} (flag on "
        f"{on['losses'][0]}), grad norm {off['grad_norms'][0]} (flag on "
        f"{on['grad_norms'][0]}), step time {off['step_s'][0]} s")
    check(abs(off["losses"][0] - on["losses"][0])
          <= 1e-4 * abs(off["losses"][0]), f"{label} step-0 loss: flag on "
          f"!= off")
    check(abs(off["grad_norms"][0] - on["grad_norms"][0])
          <= 1e-3 * abs(off["grad_norms"][0]), f"{label} grad norm: flag "
          f"on != off")


def training_phase(peaks: dict) -> dict:
    """Full-width training (f32, AdamW, remat), through the flash kernel
    under ``use_pallas_attention`` and through the SSD scan: 3 granite-3-2b
    steps, one step with the flag off from the same weights and batch, one
    h2o-danube-1.8b step; then each family of TRAIN_RUNS, zamba2 once more
    for one step with the flag off.  Returns the kernels' launches summed
    over the runs; ``peaks[GRANITE]`` takes granite's peak memory (bytes,
    with what earlier phases left allocated)."""
    # the serve phases' engines sit in reference cycles (engine, agent,
    # controller) that hold both models' weights until a collection
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  memory allocated before training: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    on, counts = train_full(GRANITE, 3, 2, 512)
    peaks[GRANITE] = on["peak_bytes"]
    add(counts)
    off, counts = train_full(GRANITE, 1, 2, 512, flag=False)
    add(counts)
    _same_step(GRANITE, on, off)
    add(train_full(DANUBE, 1, 2, 512)[1])
    for arch, steps, batch, seq in TRAIN_RUNS:
        on, counts = train_full(arch, steps, batch, seq)
        add(counts)
        if arch == "zamba2-1.2b":
            off, counts = train_full(arch, 1, batch, seq, flag=False)
            add(counts)
            _same_step(arch, on, off)
    return total


# the train-reference phase's families, reduced, every one held to the
# flash kernel's f32 tolerance, the SSD families too: after 3 steps
# their params part from the CPU's by at most 1.8e-5 (PERF.md §6)
TRAIN_REFERENCE = (GRANITE, DANUBE, MAMBA, "zamba2-1.2b", "whisper-medium",
                   "qwen3-moe-30b-a3b", "llava-next-34b")
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)


def training_reference_phase() -> None:
    """Each family of TRAIN_REFERENCE reduced (2 layers, d_model 256;
    h2o-danube's window 64 under its 128 tokens) trained 3 steps on the
    card (the flash kernel, the SSD kernel) and on the CPU (their plain
    versions) from the same weights, tokens and modality extras: losses
    and final params within TRAIN_TOL, launches exact.  Every family runs
    before any failure is raised."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.model_factory import materialize_batch
    from repro_torch.training.optimizer import tree_leaves

    small = dict(num_layers=2, d_model=256, num_heads=8, num_kv_heads=2)
    failures = []
    for name in TRAIN_REFERENCE:
        cfg = dataclasses.replace(get_arch(name).reduced(**small),
                                  use_pallas_attention=True)
        gen = torch.Generator()
        gen.manual_seed(4)
        cpu_params = build_model(cfg).init(gen, torch.float32, "cpu")
        cuda_params = _to_device(cpu_params, "cuda")
        extras = {k: v for k, v in materialize_batch(
            cfg, 4, 128, "train", gen, device="cpu").items() if k != "tokens"}
        results = []
        for device, params in (("cuda", cuda_params), ("cpu", cpu_params)):
            args = _train_args(name, 3, "--batch", "4", "--seq", "128",
                               "--device", device)
            results.append(_train(cfg, args, params,
                                  _to_device(extras, device)))
        (got, counts), (want, _) = results
        diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves(cuda_params), tree_leaves(cpu_params)))
        ok_params = all(torch.allclose(a.cpu(), b, **TRAIN_TOL)
                        for a, b in zip(tree_leaves(cuda_params),
                                        tree_leaves(cpu_params)))
        ok_losses = np.allclose(got["losses"], want["losses"], **TRAIN_TOL)
        expect = _train_launches(cfg, 3)
        log(f"  {name} reduced (window {cfg.sliding_window}, extras "
            f"{sorted(extras)}): cuda losses {got['losses']}, cpu "
            f"{want['losses']}; max |param diff| {diff:.3e} (tolerance "
            f"{TRAIN_TOL}); launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        for ok, what in ((counts == expect, f"launches {counts} != {expect}"),
                         (ok_losses, "losses part"),
                         (ok_params, f"params part by {diff}")):
            if not ok:
                failures.append(f"{name}: {what}")
    check(not failures, f"card training parts from the CPU: {failures}")


def _counting_decode(model, counts: dict, name: str):
    """``model`` with its dense ``decode_step`` counting its calls in
    ``counts[name]``."""
    def decode_step(*args):
        counts[name] = counts.get(name, 0) + 1
        return model.decode_step(*args)
    return dataclasses.replace(model, decode_step=decode_step)


def _dense_decode_launches(registry, calls: dict) -> dict:
    """Each kernel's expected launches from ``calls[name]`` dense decode
    steps: the dense decode kernel once a layer of a full-attention
    model; a sliding window's runs plain; nothing else."""
    want = dict.fromkeys(KERNELS, 0)
    want["decode_attention"] = sum(
        registry[n][0].cfg.num_layers * k for n, k in calls.items()
        if registry[n][0].cfg.sliding_window is None)
    return want


def examples_phase() -> dict:
    """The README's two examples at full width on the card (their twins
    ``launch/quickstart.py`` and ``launch/multi_model_serving.py``), launch
    counts set to 0 just before each and read just after.  Returns the
    launches summed."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import multi_model_serving as mms
    from repro_torch.launch import quickstart
    from repro_torch.models import build_model

    total = dict.fromkeys(KERNELS, 0)
    cfg = get_arch(GRANITE)
    calls = {}
    model = _counting_decode(build_model(cfg), calls, "granite")
    reset_launches()
    t0 = time.monotonic()
    res = quickstart.run(cfg, device="cuda", model=model)
    launches = read_launches()
    wall = time.monotonic() - t0
    reqs = res["requests"]
    want = _dense_decode_launches({"granite": (model, None)}, calls)
    st = res["stats"]
    log(f"  [examples] quickstart, {cfg.name} whole ({cfg.num_layers} "
        f"layers, bf16, dense): {len(reqs)} requests in {res['groups']} "
        f"groups, attainment {res['attainment']:.3f}, TTFTs (s) "
        f"{[round(r.ttft(), 4) for r in reqs]}, {st.decode_iterations} "
        f"decode steps in {st.decode_time:.3f} s, {st.prefill_chunks} "
        f"chunk rounds in {st.prefill_time:.3f} s, wall {wall:.1f} s "
        f"(weights drawn included); launches "
        f"{ {k: n for k, n in launches.items() if n} } (expected "
        f"{ {k: n for k, n in want.items() if n} })")
    check(all(r.finished() and len(r.output_tokens) == 6
              and all(0 <= t < cfg.vocab_size for t in r.output_tokens)
              for r in reqs), "quickstart: a request is unserved")
    check(launches == want, f"quickstart launches {launches} != {want}")
    for k, n in launches.items():
        total[k] += n
    del model, res, reqs
    gc.collect()
    torch.cuda.empty_cache()

    calls = {}
    registry = mms.build_registry("cuda", {n: get_arch(n)
                                           for n in mms.MODELS})
    registry = {n: (_counting_decode(m, calls, n), p)
                for n, (m, p) in registry.items()}
    reset_launches()
    t0 = time.monotonic()
    out = mms.main(["--device", "cuda"], registry=registry)
    launches = read_launches()
    wall = time.monotonic() - t0
    want = _dense_decode_launches(registry, calls)
    inter, qlm = out["interleaved"], out["qlm"]
    log(f"  [examples] multi-model, {' + '.join(mms.MODELS)} whole (bf16, "
        f"dense): per-request order {inter.model_swaps} swaps in "
        f"{inter.swap_time:.4f} s, QLM groups {qlm.model_swaps} swaps in "
        f"{qlm.swap_time:.4f} s; decode steps {calls}; wall {wall:.1f} s; "
        f"launches { {k: n for k, n in launches.items() if n} } (expected "
        f"{ {k: n for k, n in want.items() if n} })")
    check(qlm.model_swaps < inter.model_swaps,
          "multi-model: grouping did not cut the swaps")
    # serve() returns once every request has finished
    check(inter.tokens_generated == qlm.tokens_generated > 0,
          f"multi-model: the orders generated {inter.tokens_generated} and "
          f"{qlm.tokens_generated} tokens")
    check(launches == want, f"multi-model launches {launches} != {want}")
    for k, n in launches.items():
        total[k] += n
    del registry, out
    gc.collect()
    torch.cuda.empty_cache()
    return total


# (arch, shape) pairs of the dry run on the fake 16 x 16 mesh: a dense
# decode, an MoE train step, the hybrid's windowed long context
DRYRUN_PAIRS = ((GRANITE, "decode_32k"), ("qwen3-moe-30b-a3b", "train_4k"),
                ("zamba2-1.2b", "long_500k"))


def _dry_line(rec) -> str:
    mem, coll = rec["memory"], rec["collectives"]
    return (f"argument {mem['argument_bytes_per_device']} B, peak "
            f"{mem['peak_bytes_per_device'] / 2**30:.3f} GiB/dev, flops "
            f"{rec['cost']['flops_per_device']:.4g}/dev, collectives "
            f"{coll['bytes_by_op']} B in {coll['count_by_op']}, fallbacks "
            f"{rec['fallback_ops']} carrying "
            f"{rec['fallback_collective_bytes']} B at "
            f"{rec['fallback_sites']}, dropped_shardings "
            f"{rec['dropped_shardings']}, trace {rec['trace_s']} s")


# the ops of the dense cache write (models/attention.py::_write_dense),
# none of which may fall back
DENSE_WRITE_OPS = ("scatter", "gather", "where", "copy_")


# the ops of the embedding lookup and its gradient (models/layers.py::
# embed_tokens, distributed/local.py::vocab_lookup), none of which may
# fall back; and the functions of the head splits (models/attention.py:
# the k/v projections' and _sdpa's query groups), where no view may fall
# back
LOOKUP_OPS = ("index_put", "embedding", "aten.index.")
KV_SPLIT_SITES = ("(_split_heads)", "(_project_qkv)", "(_sdpa)",
                  "(_sdpa_local)")


def check_sharding(label: str, rec) -> None:
    """A record must run the embedding lookup, its gradient and the k/v
    head split with no fallback; one with a dense cache must also shard
    its ``kv_seq`` and run the cache write with no fallback."""
    fell = [op for op in rec["fallback_ops"]
            if any(w in op for w in LOOKUP_OPS)]
    check(not fell, f"{label}: the embedding lookup fell back: {fell}")
    split = [site for op, sites in rec["fallback_sites"].items()
             if "view" in op for site in sites
             if site.endswith(KV_SPLIT_SITES)]
    check(not split, f"{label}: the k/v head split fell back at {split}")
    if rec["shape"] == "train_4k":
        return
    fell = [op for op in rec["fallback_ops"]
            if any(w in op for w in DENSE_WRITE_OPS)]
    check(not any("kv_seq" in d for d in rec["dropped_shardings"]),
          f"{label}: kv_seq dropped: {rec['dropped_shardings']}")
    check(not fell, f"{label}: the dense cache write fell back: {fell}")


# the same records on this card (H100 80GB HBM3, torch 2.11) before the
# vocab-parallel lookup and the one-axis head splits, collective bytes by
# op, to print beside this run's: the table gathered whole by the
# lookup, the head splits' views and the lookup gradient's index_put
BEFORE_COLLECTIVES = {
    ("granite-3-2b", "decode_32k", ""): {
        "all-gather": 214827008, "all-reduce": 2703360,
        "reduce-scatter": 81920},
    ("qwen3-moe-30b-a3b", "train_4k", ""): {
        "all-gather": 17549834059776, "all-reduce": 2130253645128,
        "reduce-scatter": 113246208},
    ("qwen3-moe-30b-a3b", "train_4k", "g16"): {
        "all-gather": 1350291161088, "all-reduce": 1756994143560,
        "reduce-scatter": 113246208},
    ("zamba2-1.2b", "long_500k", ""): {
        "all-gather": 135274240, "all-reduce": 204952,
        "reduce-scatter": 1536},
}


def _beside_before(rec) -> str:
    now = rec["collectives"]["bytes_by_op"]
    then = BEFORE_COLLECTIVES[(rec["arch"], rec["shape"], rec["tag"])]
    return ", ".join(f"{op} {now.get(op, 0)} (before: {then.get(op, 0)})"
                     for op in sorted(set(now) | set(then)))


# the ops of the grouped MoE dispatch's pair axis (models/moe.py::
# _dispatch_groups, _combine_groups), none of which may fall back; the
# train step's one index_put is the embedding lookup's gradient
# (models/layers.py::embed_tokens), not the dispatch's
DISPATCH_OPS = ("sort", "searchsorted", "scatter", "gather", "cumsum",
                "repeat_interleave")


def check_dispatch(label: str, rec) -> None:
    """A record of the grouped MoE dispatch must run its pair-axis ops
    with no fallback."""
    fell = [op for op in rec["fallback_ops"]
            if any(w in op for w in DISPATCH_OPS)]
    check(not fell, f"{label}: the grouped dispatch fell back: {fell}")


# the depth at which [dryrun] holds qwen3-moe train_4k's g16_mb4 against
# g16: the residual's drift that multiplied the microbatched step's
# collectives showed from the second layer on
MICROBATCH_LAYERS = 4

# hillclimb's three qwen3-train variants at MICROBATCH_LAYERS layers under
# torch 2.13, collective bytes by op (the CPU's dry run of the tree that
# split the query heads over KV heads and groups, sent the MoE dispatch's
# gradient back as a partial sum, gathered a sequence-split residual once
# per sub-block and reduced each gradient once), to print beside this
# run's
AT_MICROBATCH_LAYERS_213 = {
    "g16": {"all-gather": 1207959552, "all-reduce": 6303952912,
            "reduce-scatter": 33570816},
    "g16_mb4": {"all-gather": 1224740864, "all-reduce": 6303977496,
                "reduce-scatter": 33570816},
    "g16_mb4_seqshard_donate": {"all-gather": 8204062720,
                                "all-reduce": 3888095256,
                                "reduce-scatter": 184565760},
}


def check_microbatching(dryrun, hillclimb) -> None:
    """hillclimb's three qwen3-train variants (``g16``, ``g16_mb4``,
    ``g16_mb4_seqshard_donate``) cut to ``MICROBATCH_LAYERS`` layers on
    the fake 16 x 16 mesh: no op falls back in any, and 4 microbatches
    issue at most twice the collective bytes of one step (the same
    tokens).  Each record's collective bytes are printed beside the same
    record's under torch 2.13."""
    recs = {}
    for variant in hillclimb.qwen3_train():
        variant = dict(variant)
        whole = variant.pop("config_transform")
        rec = dryrun.run_one(
            "qwen3-moe-30b-a3b", "train_4k", save=False,
            config_transform=lambda c: dataclasses.replace(
                whole(c), num_layers=MICROBATCH_LAYERS), **variant)
        recs[rec["tag"]] = rec
        log(f"  [dryrun] qwen3-moe-30b-a3b train_4k {rec['mesh']} "
            f"{rec['tag']} at {MICROBATCH_LAYERS} of 48 layers "
            f"(prediction): " + _dry_line(rec))
        now = rec["collectives"]["bytes_by_op"]
        then = AT_MICROBATCH_LAYERS_213[rec["tag"]]
        log(f"  [dryrun] {rec['tag']} at {MICROBATCH_LAYERS} layers, "
            f"collective bytes by op: " + ", ".join(
                f"{op} {now.get(op, 0)} (torch 2.13: {then.get(op, 0)})"
                for op in sorted(set(now) | set(then)))
            + f"; total {sum(now.values())} (torch 2.13: "
            f"{sum(then.values())})")
    one, four = (recs[t]["collectives"]["total_bytes"]
                 for t in ("g16", "g16_mb4"))
    log(f"  [dryrun] qwen3-moe-30b-a3b train_4k at {MICROBATCH_LAYERS} "
        f"layers: collective bytes g16 {one}, g16_mb4 {four}, ratio "
        f"{four / one:.4f} (at most 2)")
    for tag, rec in recs.items():
        check(not rec["fallback_ops"],
              f"dry run qwen3-moe-30b-a3b train_4k {tag} at "
              f"{MICROBATCH_LAYERS} layers fell back: {rec['fallback_ops']}")
    check(four <= 2 * one, f"dry run qwen3-moe-30b-a3b train_4k: 4 "
          f"microbatches issue {four} B of collectives, one step {one}")


def _card_step(label, dry, fn, args, want) -> dict:
    """``fn(*args)`` once on the card, launch counts set to 0 just before
    and read just after, against the dry run's record ``dry`` of the same
    step: argument bytes equal exactly; both peaks printed (the card's
    less what was allocated beside the arguments), not gated.  Returns
    the launches."""
    arg_bytes = sum(t.numel() * t.element_size() for t in _leaves(args)
                    if isinstance(t, torch.Tensor))
    torch.cuda.synchronize()
    beside = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    fn(*args)
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - beside
    mem = dry["memory"]
    log(f"  [dryrun] {label}: argument bytes dry run "
        f"{mem['argument_bytes_per_device']} / card {arg_bytes}; peak dry "
        f"run {mem['peak_bytes_per_device'] / 2**30:.3f} GiB / card "
        f"{peak / 2**30:.3f} GiB (card less {beside / 2**30:.3f} GiB "
        f"allocated beside the arguments; gap "
        f"{(mem['peak_bytes_per_device'] - peak) / 2**30:+.3f} GiB); "
        f"step {step_s:.3f} s (host clock, first call); launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    check(mem["argument_bytes_per_device"] == arg_bytes,
          f"{label}: argument bytes differ")
    check(launches == want, f"{label}: launches {launches} != {want}")
    return launches


def dryrun_phase(train_peak: int) -> dict:
    """``launch/dryrun.py`` on the fake production mesh (with qwen3-moe
    train_4k's ``g16`` too), then granite's decode and train steps on a
    1 x 1 fake mesh against the same steps on the card.  Returns the card
    steps' launches summed."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import build_model
    from repro_torch.models.model_factory import materialize_batch
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_train_step

    mesh_lib.release()
    try:
        for arch, shape in DRYRUN_PAIRS:
            rec = dryrun.run_one(arch, shape, save=False)
            log(f"  [dryrun] {arch} {shape} {rec['mesh']} (prediction): "
                + _dry_line(rec))
            log(f"  [dryrun] {arch} {shape} collective bytes by op: "
                + _beside_before(rec))
            check_sharding(f"dry run {arch} {shape}", rec)
            check(rec["applicable"] and rec["cost"]["flops_per_device"] > 0
                  and rec["memory"]["peak_bytes_per_device"]
                  >= rec["memory"]["argument_bytes_per_device"] > 0,
                  f"dry run {arch} {shape}: {rec}")
        # hillclimb's qwen3-train g16: the dispatch in 16 data-aligned
        # groups, shard-local under this torch too
        g16 = next(hillclimb.qwen3_train())
        rec = dryrun.run_one("qwen3-moe-30b-a3b", "train_4k", save=False,
                             **g16)
        log(f"  [dryrun] qwen3-moe-30b-a3b train_4k {rec['mesh']} "
            f"{rec['tag']} (prediction): " + _dry_line(rec))
        log("  [dryrun] qwen3-moe-30b-a3b train_4k g16 collective bytes by "
            "op: " + _beside_before(rec))
        check_dispatch("dry run qwen3-moe-30b-a3b train_4k g16", rec)
        check_sharding("dry run qwen3-moe-30b-a3b train_4k g16", rec)
        check_microbatching(dryrun, hillclimb)
        mesh_lib.release()
        one = mesh_lib.make_debug_mesh(1, 1)
        decode = dryrun.run_one(
            GRANITE, "decode_32k", mesh=one, save=False,
            shape_transform=lambda s: dataclasses.replace(s, global_batch=8))
        log(f"  [dryrun] {GRANITE} decode 8 x 32768 {decode['mesh']}: "
            + _dry_line(decode))
        train = dryrun.run_one(
            GRANITE, "train_4k", mesh=one, save=False, dtype=torch.float32,
            config_transform=lambda c: dataclasses.replace(
                c, use_pallas_attention=True),
            shape_transform=lambda s: dataclasses.replace(
                s, global_batch=2, seq_len=512))
        log(f"  [dryrun] {GRANITE} train 2 x 512 f32 {train['mesh']}: "
            + _dry_line(train))
    finally:
        mesh_lib.release()

    total = dict.fromkeys(KERNELS, 0)
    cfg = get_arch(GRANITE)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(gen, torch.bfloat16, "cuda")
    cache = model.init_cache(8, 32768, torch.bfloat16, "cuda")
    data = materialize_batch(cfg, 8, 32768, "decode", gen, torch.bfloat16,
                             "cuda")
    want = dict.fromkeys(KERNELS, 0)
    want["decode_attention"] = cfg.num_layers
    decode_args = (params, cache, data["tokens"], data["lengths"])
    with torch.no_grad():
        got = _card_step("decode 8 x 32768 bf16", decode, model.decode_step,
                         decode_args, want)
        card_ms = time_ms(lambda: model.decode_step(*decode_args), iters=5,
                          replays=4)
    roofline_check("decode 8 x 32768 bf16", decode, card_ms,
                   "device, CUDA-graph replays")
    for k, n in got.items():
        total[k] += n
    del params, cache, data, decode_args
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, use_pallas_attention=True)
    tmodel = build_model(tcfg)
    params = tmodel.init(gen, torch.float32, "cuda")
    opt = AdamW(learning_rate=1e-4)
    state = opt.init(params)
    batch = materialize_batch(tcfg, 2, 512, "train", gen, torch.float32,
                              "cuda")
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = cfg.num_layers * 2
    step = make_train_step(tmodel, opt, remat=True)
    got = _card_step("train 2 x 512 f32", train, step,
                     (params, state, batch), want)
    t0 = time.monotonic()
    step(params, state, batch)
    torch.cuda.synchronize()
    roofline_check("train 2 x 512 f32", train,
                   (time.monotonic() - t0) * 1e3,
                   "a warm step on the host clock")
    log(f"  [dryrun] [train]'s granite peak (3 steps, with what earlier "
        f"phases left allocated): {train_peak / 2**30:.3f} GiB")
    for k, n in got.items():
        total[k] += n
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return total


def roofline_check(label, rec, card_ms: float, how: str) -> None:
    """The roofline's three terms of the 1 x 1 dry-run record ``rec``
    (``launch/roofline.py``, raw terms, H100 constants) beside the card's
    time of the same step.  Fails if the card beat the compute term (no
    card beats its peak) or the record reads fewer bytes than its
    arguments; the memory ratio is not gated (the byte count is
    unfused, an upper estimate)."""
    from repro_torch.launch import roofline
    a = roofline.analyze(rec, correct=False)
    bound_ms = a["bound_s"] * 1e3
    log(f"  [hillclimb] {label} (1 x 1 record, predictions): compute "
        f"{a['compute_s'] * 1e3:.4f} ms, memory {a['memory_s'] * 1e3:.4f} "
        f"ms ({rec['cost']['bytes_accessed_per_device']:.6g} B), "
        f"collective {a['collective_s'] * 1e3:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({a['dominant']}); card {card_ms:.4f} ms "
        f"({how}); card / bound {card_ms / bound_ms:.3f}, card / compute "
        f"{card_ms / (a['compute_s'] * 1e3):.3f}")
    check(card_ms >= a["compute_s"] * 1e3,
          f"{label}: the card's {card_ms} ms beat the compute term")
    check(rec["cost"]["bytes_accessed_per_device"]
          >= rec["memory"]["argument_bytes_per_device"],
          f"{label}: bytes accessed below the argument bytes")


def hillclimb_phase() -> None:
    """``launch/hillclimb.py --target granite-decode`` on the fake 16 x 16
    mesh, its records written to an empty directory (no earlier run's
    cached record is read); both report lines printed; and the
    roofline's HBM size within the card's."""
    from repro_torch.launch import dryrun, hillclimb, roofline
    from repro_torch.launch import mesh as mesh_lib

    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  [hillclimb] roofline HBM_BYTES {roofline.HBM_BYTES:.6g} B, "
        f"the card's total_memory {total} B")
    check(roofline.HBM_BYTES <= total, "HBM_BYTES exceeds the card's memory")
    out = ROOT / "build" / "hillclimb"
    shutil.rmtree(out, ignore_errors=True)
    saved = dryrun.OUT_DIR
    dryrun.OUT_DIR = out
    mesh_lib.release()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            hillclimb.run(["granite-decode"])
    finally:
        dryrun.OUT_DIR = saved
        mesh_lib.release()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  [hillclimb] {line.strip()}"
            + (" (prediction)" if "tag=" in line else ""))
    for path in sorted(out.glob("*.json")):
        rec = json.loads(path.read_text())
        log(f"  [hillclimb] {rec['tag']}: dropped_shardings "
            f"{rec['dropped_shardings']}, fallback_ops {rec['fallback_ops']}"
            f", fallback_collective_bytes "
            f"{rec['fallback_collective_bytes']} of "
            f"{rec['collectives']['total_bytes']} collective bytes")
        check_sharding(f"hillclimb {rec['tag']}", rec)
    reports = [line for line in lines if line.lstrip().startswith("tag=")]
    check([line.split()[0] for line in reports]
          == ["tag=pet", "tag=kvquant8"]
          and not any("cached" in line for line in reports),
          f"hillclimb granite-decode: {lines}")
    check(sorted(p.name for p in out.iterdir()) == [
        "granite-3-2b__decode_32k__pod16x16__kvquant8.json",
        "granite-3-2b__decode_32k__pod16x16__pet.json"],
        f"hillclimb records: {list(out.iterdir())}")
    shutil.rmtree(out)


# a round's hot path with a blocking upload, for the probe
_UPLOAD_FIXTURE = """
import torch


class Engine:
    def _decode_round(self, a):
        return torch.tensor(a, device="cuda")
"""


def lint_phase() -> None:
    """The port's lint over ``src/repro_torch`` with the baseline (0
    findings) and its self-test; then the probe of its blocking-upload
    rule: with ~50 ms of work queued, a blocking ``torch.tensor(a,
    device="cuda")`` on the host clock, the same copy from pinned memory
    with ``non_blocking=True``, and the engine's ``_to_device``.  Fails
    if the rule flags blocking uploads and they did not wait, or the
    reverse, or if the pinned copies waited."""
    from repro_torch.analysis import lint
    from repro_torch.serving.engine import ContinuousBatchingEngine

    src = str(ROOT / "src" / "repro_torch")
    check(lint.main([src, "--baseline", str(ROOT / "qlint_baseline.json")])
          == 0, "the port's lint has findings")
    check(lint.main([src, "--self-test"]) == 0, "the lint's self-test failed")
    fixture = ROOT / "build" / "lint_probe" / "engine.py"
    fixture.parent.mkdir(parents=True, exist_ok=True)
    fixture.write_text(_UPLOAD_FIXTURE)
    flagged = any("host->device" in f.message
                  for f in lint.lint_file(str(fixture)))
    shutil.rmtree(fixture.parent)

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        a @ a
    end.record()
    torch.cuda.synchronize()
    n = max(1, int(np.ceil(50.0 / (start.elapsed_time(end) / 10))))
    host = np.arange(8 * 2048, dtype=np.int32)  # a block table's size
    pinned = torch.from_numpy(host).pin_memory()
    engine = SimpleNamespace(device=torch.device("cuda"))

    def queued_ms(upload) -> tuple:
        upload()                                # warm the host allocator
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            a @ a
        t0 = time.perf_counter()
        out = upload()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        check(np.array_equal(out.cpu().numpy(), host), "probe copy differs")
        return host_ms, start.elapsed_time(end)

    times = {
        "blocking torch.tensor(a, device='cuda')":
            queued_ms(lambda: torch.tensor(host, device="cuda")),
        "pinned .to('cuda', non_blocking=True)":
            queued_ms(lambda: pinned.to("cuda", non_blocking=True)),
        "the engine's _to_device":
            queued_ms(lambda: ContinuousBatchingEngine._to_device(engine,
                                                                  host)),
    }
    waited = {k: host_ms > 0.5 * work for k, (host_ms, work) in times.items()}
    for k, (host_ms, work) in times.items():
        log(f"  [lint] probe: {k}: {host_ms:.3f} ms on the host with "
            f"{work:.3f} ms of work queued ({n} bf16 8192^3 products); "
            f"waited {waited[k]}")
    blocking, *repaired = waited.values()
    log(f"  [lint] the rule flags blocking uploads: {flagged}; they "
        f"waited: {blocking}")
    check(flagged == blocking, "the blocking-upload rule disagrees with "
                               "the probe")
    check(not any(repaired), "a pinned non_blocking upload waited")
    del a
    torch.cuda.empty_cache()


def decode_timings(src: Path) -> int:
    """``--decode-timings [SRC]``: only the decode kernels, float and
    int8, and the granite decode steps, with the ``repro_torch`` package
    under ``SRC`` (default: this checkout's ``src``), so that another
    tree's kernels (a ``git archive`` of a parent commit) are timed by the
    same code in the same call.  Each kernel against its plain version,
    then its device time and SDPA's (float) or the dequantize-then-SDPA
    two calls' (int8) at the serving shape and at 8 x 4096 (bf16), then
    the full-width granite decode step, float and int8, at 40 and at 4096
    tokens of context, on the page pool and the dense cache.  The last
    line is the records' JSON."""
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
            ("serving", serve_lengths, shapes["nb"], shapes["S"]),
            ("8 x 4096", [4096] * 8, 256, 4096)):
        for name in FLOAT_DECODE + INT8_DECODE:
            quant = name in INT8_DECODE
            args = (decode_case(rng, gen, dtype, lengths, quant, nb=nb,
                                N=max(len(lengths) * nb, shapes["N"]))
                    if name.startswith("paged")
                    else dense_case(rng, gen, dtype, lengths, S, quant))
            err = check_case(failures, name, dtype, label, args)
            fn, _ = kernel_fns(name)
            rec = {"ms": time_ms(lambda: fn(*args))}
            if quant:
                rec["two_call_ms"] = time_ms(decode_two_calls(name, args))
            else:
                rec["library_ms"] = time_ms(decode_library(name, args))
            rec.update(splits=decode_splits(name, args), max_abs_err=err)
            records[f"{name} {label}"] = rec
            log(f"  {name} {label}: " + json.dumps(rec))
    check(not failures, f"kernels disagree with their plain versions: "
                        f"{failures}")
    cfg = get_arch(GRANITE)
    gen.manual_seed(0)
    model = build_model(cfg)
    quant = build_model(dataclasses.replace(cfg, kv_quant=True))
    params = model.init(gen, torch.bfloat16, "cuda")
    step_timings((("granite paged", (model, params), True),
                  ("granite paged int8", (quant, params), True),
                  ("granite dense", (model, params), False),
                  ("granite dense int8", (quant, params), False)))
    long_step_timings(model, quant, params)
    print(json.dumps(records), flush=True)
    return 0


def kernel_timings(src: Path) -> int:
    """``--kernel-timings [SRC]``: the paged prefill kernels, float and
    int8, the SSD scan and the steps that run them, with the
    ``repro_torch`` package under ``SRC`` (default: this checkout's
    ``src``), so that another tree's kernels (a ``git archive`` of a
    parent commit) are timed by the same code in the same call.  Each
    kernel against its plain version, then its device time (bf16): the
    prefill twins at the serving shape and at 4 x 128 queries over a
    2048-token prefix, beside SDPA (float) or the two calls that gather,
    dequantize and run SDPA (int8); the SSD scan (state in and out) at
    mamba2's widths, L 64, 512 and 2048 and B 4 L 512, beside its plain
    version; the f32 SSD error at L 2048 against the plain version and,
    for both, against the plain version evaluated in f64; then
    the full-width granite page-pool chunk rounds, float and int8, and
    mamba2's 64- and 512-token single-shot prefills.  The last line is
    the records' JSON."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import build_model

    log(f"[kernel-timings] repro_torch from {src}")
    build.build(["paged_prefill_attention", "ssd_scan"])
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = serving_shapes()
    B, nb, N, C = (shapes[k] for k in ("B", "nb", "N", "C"))
    dtype, failures, records = torch.bfloat16, [], {}
    valid = rng.integers(4, 24, size=B)
    valid[-2:] = 0
    for quant in (False, True):
        name = "paged_prefill_attention" + ("_quant" if quant else "")
        fn, _ = kernel_fns(name)
        for label, args in (
                ("serving", prefill_case(rng, gen, dtype, [0] * B,
                                         valid.tolist(), C, quant, nb=nb,
                                         N=N)),
                ("4 x 2048", prefill_case(rng, gen, dtype, [2048] * 4,
                                          [128] * 4, 128, quant))):
            err = check_case(failures, name, dtype, label, args)
            rec = {"ms": time_ms(lambda: fn(*args)), "max_abs_err": err}
            if quant:
                rec["two_call_ms"] = time_ms(prefill_two_calls(args, dtype))
            else:
                rec["library_ms"] = time_ms(prefill_library(args, dtype))
            records[f"{name} {label}"] = rec
            log(f"  {name} {label}: " + json.dumps(rec))
    for case in ("mamba2 B1 L64", "mamba2 B1 L512", "mamba2 B1 L2048",
                 "mamba2 B4 L512"):
        Bs, L, H, P, G, Ns, Q = SSD_CASES[case]
        x, dt, A, Bm, Cm, init = ssd_case(gen, dtype, Bs, L, H, P, G, Ns)
        args = (x, dt, A, Bm, Cm, Q, init)
        y, h = ss.ssd_scan(*args, return_state=True)
        want_y, want_h = ss.ssd_scan_plain(*args, return_state=True)
        err, ok = compare(y, want_y, dtype, tol=SSD_TOL)
        _, h_ok = compare(h, want_h, torch.float32, tol=SSD_TOL)
        rec = {"ms": time_ms(lambda: ss.ssd_scan(*args, return_state=True)),
               "plain_ms": time_ms(lambda: ss.ssd_scan_plain(
                   *args, return_state=True)), "max_abs_err": err}
        if not (ok and h_ok):
            failures.append(("ssd_scan", str(dtype), case))
        records[f"ssd_scan {case}"] = rec
        log(f"  ssd_scan {case} bf16, state in and out: " + json.dumps(rec))
    x, dt, A, Bm, Cm, init = ssd_case(gen, torch.float32,
                                      *SSD_CASES["mamba2 B1 L2048"][:-1])
    y, h = ss.ssd_scan(x, dt, A, Bm, Cm, 64, init, return_state=True)
    want_y, want_h = ss.ssd_scan_plain(x, dt, A, Bm, Cm, 64, init,
                                       return_state=True)
    def err(a, b):
        return float((a.double() - b.double()).abs().max())
    rec = {"y": err(y, want_y), "state": err(h, want_h)}
    true_y, true_h = ss.ssd_scan_plain(
        *(t.double() for t in (x, dt, A, Bm, Cm)), 64, init.double(),
        return_state=True)
    if true_h.dtype == torch.float64:    # a plain version that computes f64
        rec.update({"y kernel - f64": err(y, true_y),
                    "y plain - f64": err(want_y, true_y),
                    "state kernel - f64": err(h, true_h),
                    "state plain - f64": err(want_h, true_h),
                    "max |y|": float(true_y.abs().max())})
    records["ssd_scan f32 L2048 error"] = rec
    log("  ssd_scan f32 mamba2 B1 L2048, state in, max |kernel - plain| and "
        "both against the plain version in f64: "
        + json.dumps(records["ssd_scan f32 L2048 error"]))
    check(not failures, f"kernels disagree with their plain versions: "
                        f"{failures}")
    cfg = get_arch(GRANITE)
    gen.manual_seed(0)
    model = build_model(cfg)
    quant = build_model(dataclasses.replace(cfg, kv_quant=True))
    params = model.init(gen, torch.bfloat16, "cuda")
    step_timings((("granite paged", (model, params), True),
                  ("granite paged int8", (quant, params), True)))
    del params
    torch.cuda.empty_cache()
    m_cfg = get_arch(MAMBA)
    gen.manual_seed(2)
    m_model = build_model(m_cfg)
    ssm_step_timings(m_model, m_model.init(gen, torch.bfloat16, "cuda"))
    print(json.dumps(records), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--decode-timings"]:
        return decode_timings(Path(sys.argv[2]) if len(sys.argv) > 2
                              else ROOT / "src")
    if sys.argv[1:2] == ["--kernel-timings"]:
        return kernel_timings(Path(sys.argv[2]) if len(sys.argv) > 2
                              else ROOT / "src")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    t_run = time.monotonic()
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

    log("[lint] the port's lint over src/repro_torch; blocking-upload probe")
    t0 = time.monotonic()
    lint_phase()
    log(f"[lint] ok in {time.monotonic() - t0:.1f} s")

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
    long_step_timings(g_model, g_quant, g_params)
    ssm_step_timings(m_model, m_params)
    log(f"[step] in {time.monotonic() - t0:.1f} s")

    log("[long-prompt] 64-token chunks, prefix sharing, COW, fork_slot")
    t0 = time.monotonic()
    long_prompt_phase(g_model, g_params)
    log(f"[long-prompt] ok in {time.monotonic() - t0:.1f} s")

    log("[drivers] async front end, threaded vs round-robin, chaos soak")
    t0 = time.monotonic()
    drivers_phase(g_model, g_params)
    log(f"[drivers] ok in {time.monotonic() - t0:.1f} s")

    log("[sim] the simulator against the engine, the paper's baselines")
    t0 = time.monotonic()
    sim_phase({GRANITE: (g_model, g_params), DANUBE: (d_model, d_params)})
    log(f"[sim] ok in {time.monotonic() - t0:.1f} s")
    # the serve loop's last registry holds both models' weights too
    del models, registry, g_params, d_params, m_params
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[dense-family] {', '.join(DENSE_FAMILY)}: full width, "
        f"{DENSE_FAMILY_LAYERS} layers, bf16")
    t0 = time.monotonic()
    dense_family_phase()
    log(f"[dense-family] ok in {time.monotonic() - t0:.1f} s")

    log(f"[moe-vlm] {', '.join(MOE_VLM)}: full width, layers "
        f"{MOE_VLM_LAYERS}, bf16")
    t0 = time.monotonic()
    moe_vlm_phase()
    log(f"[moe-vlm] ok in {time.monotonic() - t0:.1f} s")

    log(f"[hybrid-encdec] {', '.join(HYBRID_ENCDEC)}: whole, bf16")
    t0 = time.monotonic()
    for k, n in hybrid_encdec_phase().items():
        launches[k] = launches.get(k, 0) + n
    log(f"[hybrid-encdec] ok in {time.monotonic() - t0:.1f} s")

    log("[hetero] serve --hetero --threaded, 3 instances, granite-3-2b")
    t0 = time.monotonic()
    hetero_phase()
    log(f"[hetero] ok in {time.monotonic() - t0:.1f} s")

    log("[reference] cuda engine vs cpu engine, reduced models, float32")
    t0 = time.monotonic()
    reference_phase()
    log(f"[reference] ok in {time.monotonic() - t0:.1f} s")

    log("[train] full width, float32, use_pallas_attention, every family")
    t0 = time.monotonic()
    train_peaks = {}
    for k, n in training_phase(train_peaks).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[train] ok in {time.monotonic() - t0:.1f} s")

    log("[train-reference] cuda vs cpu training, reduced models, float32")
    t0 = time.monotonic()
    training_reference_phase()
    log(f"[train-reference] ok in {time.monotonic() - t0:.1f} s")

    log("[examples] quickstart and multi-model twins, full width, bf16")
    t0 = time.monotonic()
    for k, n in examples_phase().items():
        launches[k] = launches.get(k, 0) + n
    log(f"[examples] ok in {time.monotonic() - t0:.1f} s")

    log("[dryrun] fake 16 x 16 mesh; 1 x 1 against the card")
    t0 = time.monotonic()
    for k, n in dryrun_phase(train_peaks[GRANITE]).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[dryrun] ok in {time.monotonic() - t0:.1f} s")

    log("[hillclimb] granite-decode on the fake 16 x 16 mesh")
    t0 = time.monotonic()
    hillclimb_phase()
    log(f"[hillclimb] ok in {time.monotonic() - t0:.1f} s")
    log(f"[total] {time.monotonic() - t_run:.1f} s")

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
