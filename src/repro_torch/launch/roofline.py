"""Roofline terms of the port's dry-run records (PyTorch twin of
``benchmarks/roofline.py``).

Per (arch x shape) record of ``launch/dryrun.py`` (per device):

    compute term    = flops_per_device / PEAK_FLOPS
    memory term     = bytes_accessed_per_device / HBM_BW
    collective term = collective bytes per device / LINK_BW

The constants are one NVIDIA H100 SXM5's (NVIDIA H100 Tensor Core GPU
datasheet, SXM5 column, dense rates): 989 TFLOP/s bf16, 3.35 TB/s HBM3,
80 GB of HBM.  The link is the per-GPU InfiniBand NDR port, 400 Gb/s =
50 GB/s: the production mesh's 16-wide ``"model"`` axis spans two 8-GPU
NVLink nodes, so a ring over it is paced by its inter-node hop, not by
NVLink's 900 GB/s.

The record's byte count is unfused (one term per aten op, see
``launch/comm_analysis.py``), so the memory term is an upper estimate;
its collectives are DTensor's, the replicated fallbacks' gathers among
them (``fallback_ops``).  ``MODEL_FLOPS`` = 6 N D for a train step and
2 N D for forward-only shapes (N active params; D the tokens the step
processes, by the shape's name).  Every term is a prediction from a dry
run, not a measurement.

  PYTHONPATH=src python -m repro_torch.launch.roofline
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12          # bf16 dense, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 50e9               # bytes/s, one InfiniBand NDR port per GPU
HBM_BYTES = 80e9             # per GPU

EXPERIMENTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "experiments")
DRYRUN_DIR = os.path.join(EXPERIMENTS, "dryrun_torch")


SHAPE_TOKENS = {
    "train_4k": 256 * 4096,
    "prefill_32k": 32 * 32768,
    "decode_32k": 128,        # ONE new token per sequence
    "long_500k": 1,
}


def model_flops(rec: Dict) -> float:
    """6·N·D for training; forward-only shapes use 2·N·D (D = tokens
    actually processed by the step)."""
    n = rec["model_active_params"]
    d = SHAPE_TOKENS[rec["shape"]]
    factor = 6.0 if rec["shape"] == "train_4k" else 2.0
    return factor * n * d


def analyze(rec: Dict, correct: bool = True) -> Optional[Dict]:
    if not rec.get("applicable", False) or "cost" not in rec:
        return None
    n_chips = rec["n_chips"]
    flops_dev = rec["cost"]["flops_per_device"]
    bytes_dev = rec["cost"]["bytes_accessed_per_device"]
    coll_dev = rec["collectives"]["total_bytes"]  # per-device program
    mf = model_flops(rec)
    hlo_global = flops_dev * n_chips
    # the reference scales both terms up where the analytic 6·N·D exceeds
    # the counted flops (XLA:CPU counts a loop body once); kept for
    # equal tables, though the port's count runs every iteration
    undercount = max(1.0, mf / hlo_global) if (hlo_global and correct) else 1.0
    flops_dev_c = flops_dev * undercount
    bytes_dev_c = bytes_dev * undercount
    t_compute = flops_dev_c / PEAK_FLOPS
    t_memory = bytes_dev_c / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", ""),
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(terms.values()),
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "scan_undercount_corrected": undercount > 1.0,
        "useful_flops_ratio": min(mf / (hlo_global * undercount), 1.0)
                              if hlo_global else 0.0,
        "peak_gib_per_device": rec["memory"]["peak_bytes_per_device"] / 2**30,
        "fits_hbm": rec["memory"]["peak_bytes_per_device"] <= HBM_BYTES,
        "collective_breakdown": rec["collectives"]["bytes_by_op"],
        "dropped_shardings": rec.get("dropped_shardings", []),
    }


def load_records(mesh: str = "pod16x16", tag: str = "") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("mesh") == mesh and r.get("tag", "") == tag:
            recs.append(r)
    return recs


def roofline_table(mesh: str = "pod16x16", tag: str = "") -> List[Dict]:
    rows = []
    for rec in load_records(mesh, tag):
        a = analyze(rec)
        if a is None:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh"), "skipped": True,
                         "reason": rec.get("skip_reason", "")})
        else:
            rows.append(a)
    return rows


def format_table(rows: List[Dict]) -> str:
    lines = [f"{'arch':24s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
             f"{'collect':>10s} {'bound':>9s} {'useful':>7s} {'GiB/dev':>8s} fits"]
    for r in rows:
        if r.get("skipped"):
            lines.append(f"{r['arch']:24s} {r['shape']:12s} {'—':>10s} "
                         f"(skipped: sub-quadratic attention required)")
            continue
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} "
            f"{r['compute_s']*1e3:9.2f}ms {r['memory_s']*1e3:9.2f}ms "
            f"{r['collective_s']*1e3:9.2f}ms {r['dominant']:>9s} "
            f"{r['useful_flops_ratio']:6.1%} {r['peak_gib_per_device']:8.2f} "
            f"{'Y' if r['fits_hbm'] else 'OVER'}")
    return "\n".join(lines)


def main() -> List:
    rows = roofline_table()
    print(format_table(rows))
    os.makedirs(EXPERIMENTS, exist_ok=True)
    with open(os.path.join(EXPERIMENTS, "roofline_table_torch.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    done = [r for r in rows if not r.get("skipped")]
    if not done:
        return [("roofline_table", "0", "no dry-run records analyzed")]
    n_fit = sum(1 for r in done if r["fits_hbm"])
    return [("roofline_table", "0",
             f"{len(done)} pairs analyzed, {n_fit} fit "
             f"{HBM_BYTES / 1e9:.0f} GB HBM, "
             f"dominant: {max(set(r['dominant'] for r in done), key=[r['dominant'] for r in done].count)}")]


if __name__ == "__main__":
    main()
