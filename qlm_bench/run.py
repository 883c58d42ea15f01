"""Run one cell of ``BENCHMARK.json`` once and print its result line.

  python qlm_bench/run.py --workload granite-3-2b.mixed-slo --seed 7 \
      --seconds 30 --trace 0

Run from the repository root (the harness puts ``src`` and the root on
``sys.path`` itself).  With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones, read with
``torch.profiler`` over a slice of the window.  The last line of standard
output is one JSON object; the last lines of standard error are the
numbers compared for ``correct``, each beside its limit.  Exits non-zero,
printing no result, without CUDA or with fewer cards than the cell asks
for, and if ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name, whole, is one of
    FORBIDDEN: ``repro_torch`` passes, ``repro.serving`` does not."""
    names = list(sys.modules) if names is None else names
    return sorted({name for name in names
                   if name.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from qlm_bench import harness, trace

    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3

    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), spec=spec, t_process=T_PROCESS)
    leaked = forbidden_modules()
    if leaked:
        print(f"loaded in this process: {', '.join(leaked)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if out["trace"] is not None:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = trace.breakdown(out["trace"])
    line["power_limit_w"] = power_limit()
    line["kv_pool"] = out["kv_pool"]
    line["checks"] = out["checks"]
    print(json.dumps(line), flush=True)
    return 0


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread: {exc}"


if __name__ == "__main__":
    sys.exit(main())
