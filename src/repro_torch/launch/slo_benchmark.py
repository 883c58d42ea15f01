"""Paper-scale SLO benchmark on the cluster simulator (twin of
``examples/slo_benchmark.py``): QLM against vLLM-FCFS, EDF and SHEPHERD on
the multi-model workload W_B (the paper's Figs. 12/13 conditions at a
reduced request count).

The output is a simulation over the paper's A100 profiles
(``sim/profiles.py``: published vLLM-era latencies of its testbed), not a
measurement of any card.  ``sim.calibrate_from_engine`` builds a profile
from an engine instead.

  PYTHONPATH=src python -m repro_torch.launch.slo_benchmark [--requests 800]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

from repro_torch.data.workload import workload_b
from repro_torch.sim import ClusterSimulator, profiles_for

MODELS = ["mistral-7b-ft", "llama-70b-ft1", "vicuna-13b-ft",
          "llama-70b-ft2", "vicuna-13b-ft2"]
POLICIES = ("vllm", "edf", "shepherd", "qlm")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=800)
    ap.add_argument("--rate", type=float, default=25.0)
    ap.add_argument("--instances", type=int, default=4)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    """Print one line per policy and the QLM-vs-vLLM gains; returns each
    policy's metrics dict."""
    args = parse_args(argv)
    print(f"simulation on the paper's A100 profiles (not a measurement): "
          f"W_B, {args.requests} requests @ {args.rate}/s, "
          f"{args.instances}x A100, models={len(MODELS)}")
    print(f"{'policy':10s} {'SLO':>6s} {'req/s':>7s} {'tok/s':>8s} "
          f"{'swaps':>6s} {'evict':>6s} {'util':>6s} {'wall':>6s}")
    results = {}
    for policy in POLICIES:
        reqs = workload_b(arrival_rate=args.rate, n_requests=args.requests,
                          seed=42)
        sim = ClusterSimulator(
            [profiles_for("a100", MODELS) for _ in range(args.instances)],
            policy)
        t0 = time.monotonic()
        m = sim.run(reqs)
        results[policy] = m
        print(f"{policy:10s} {m['slo_attainment']:6.1%} "
              f"{m['throughput_rps']:7.2f} {m['token_throughput']:8.0f} "
              f"{m['swaps']:6.0f} {m['evictions']:6.0f} "
              f"{m['device_utilization']:6.1%} {time.monotonic()-t0:5.1f}s")

    gain = results["qlm"]["throughput_rps"] / results["vllm"]["throughput_rps"]
    dslo = results["qlm"]["slo_attainment"] - results["vllm"]["slo_attainment"]
    print(f"\nQLM vs vLLM: {gain:.1f}x throughput, +{dslo:.0%} SLO attainment "
          f"(simulated)")
    print("(paper: 20-400% throughput, 40-90% SLO attainment gains)")
    return results


if __name__ == "__main__":
    main()
