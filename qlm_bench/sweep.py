"""The knee sweep: one cell's mix at each of several rates, in one process
(the weights made once, a fresh cluster per rate), printing one JSON line
per rate with the client's numbers, the requests in the system at the
window's start and end, and the page pool's use.  The knee is the highest
rate at which the requests in the system at the window's end still fit in
the engine's slots: above it a queue forms behind full slots.

  python qlm_bench/sweep.py --workload granite-3-2b.mixed-slo --seed 11 \
      --seconds 30 --rates 1 2 3 4 5
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

READINGS = ("tokens_per_s", "slo_attainment", "itl_p99_ms",
            "interactive_ttft_p90_s", "decode_round_ms",
            "controller_ms_per_tick")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--lead-in", type=float, default=None,
                    help="the lead-in's seconds, in place of the mix's")
    args = ap.parse_args(argv)

    import torch

    from qlm_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, args.workload)
    config = harness.load_json("configs", cell["config"])
    spec = dict(spec, end_to_end=[{"name": n, "unit": ""} for n in READINGS])
    params = harness.make_params(config, args.seed, "cuda")
    for rate in args.rates:
        traffic = harness.traffic_of(cell)
        traffic["rate"] = rate
        if args.lead_in is not None:
            traffic["lead_in_s"] = args.lead_in
        out = harness.measure(spec, args.workload, config, traffic, params,
                              args.seed, args.seconds, False, "cuda")
        run = out["run"]
        judged = sum(1 for s in run.seen if s.cls == "interactive"
                     and run.window[0] <= s.due <= run.window[1]
                     and s.due + s.ttft_s <= run.window[1])
        line = {"rate": rate, "seed": args.seed, "seconds": args.seconds,
                **{k: v["value"] for k, v in out["metrics"].items()},
                "backlog_start": run.backlog[0], "backlog_end": run.backlog[1],
                "interactive_judged": judged, "kv_pool": out["kv_pool"],
                "setup_s": run.setup_s,
                "memory_peak_bytes": out["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
