"""The readings that a cell's correctness limit is set from: for each seed,
one run of the cell (set-up, lead-in, window) and, on the same sample of
requests finished in the window, ``check.judge`` twice: on the port's
served tokens (the lower readings) and on the tokens that the reference
computed in float8 e4m3 puts first (the control, the upper readings),
which has to come out not correct.  One JSON line a seed.

  python qlm_bench/control.py --workload granite-3-2b.mixed-slo \
      --seconds 30 --seeds 101 102 103
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from qlm_bench import check, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, args.workload)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.traffic_of(cell)
    rule = config["check"]
    for seed in args.seeds:
        t = time.monotonic()
        params = harness.make_params(config, seed, "cuda")
        out = harness.measure(spec, args.workload, config, traffic, params,
                              seed, args.seconds, False, "cuda", t_process=t)
        window = out["run"].window
        t_ref = time.monotonic()
        port = check.judge(config, params, out["requests"], seed, window)
        t_ref = time.monotonic() - t_ref
        control = check.judge(config, params, out["requests"], seed, window,
                              "fp8")
        line = {"seed": seed, "port": port["readings"],
                "port_correct": port["correct"],
                "requests": len(port["picked"]), "reference_s": t_ref,
                "limits": rule["limits"], "control": control["readings"],
                "control_correct": control["correct"],
                "kv_pool": out["kv_pool"],
                "memory_peak_bytes": out["memory_peak_bytes"],
                "backlog": out["run"].backlog,
                "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        print(json.dumps(line), flush=True)
        del params, out, port, control
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
