"""One run of ``run.py`` that also prints where the traced slice's time
went by the program's own spans (``program_trace.py``).

  python3 qlm_bench/program_breakdown.py --workload W --seed N \
      --seconds 51 --trace 1 [--out breakdown.jsonl]

Takes ``run.py``'s arguments and prints its result line unchanged; then,
on standard error and into ``--out`` as one JSON object: host seconds by
span (whole and self), device and idle seconds by span (self, and under
each span), the share of the device time joined to a program span, and
the harness's idle by its own spans beside the program's.  A tree whose
program records no spans prints the result line alone.
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

# run.py notes the process's start when it is imported (``setup_s``):
# before torch loads with the harness
from qlm_bench import run  # noqa: E402
from qlm_bench import harness, program_trace  # noqa: E402


def summary(out: dict) -> dict:
    """The breakdown of a run that ``harness.run_cell`` returned."""
    r = out["run"]
    pt = vars(r).get("program_trace")
    if pt is None:
        return {}
    dev, idle = pt["device_by_chain"], pt["idle_by_chain"]
    names = sorted(pt["host_s"])
    joined = None
    if dev is not None and pt["device_s"] > 0:
        joined = 100.0 * sum(t for c, t in dev.items() if c) / pt["device_s"]
    return {
        "window_s": r.trace["window_s"] if r.trace else None,
        "busy_s": r.trace["busy_s"] if r.trace else None,
        "device_s": pt["device_s"], "launches": pt["launches"],
        "device_joined_pct": joined,
        "host_s": pt["host_s"], "host_self_s": pt["host_self_s"],
        "n": pt["n"], "counts": pt["counts"],
        "device_self_s": program_trace.innermost(dev),
        "device_under_s": None if dev is None else {
            n: program_trace.under(dev, lambda x, n=n: x == n)
            for n in names},
        "idle_self_s": program_trace.innermost(idle),
        "idle_under_s": None if idle is None else {
            n: program_trace.under(idle, lambda x, n=n: x == n)
            for n in names},
        "harness_idle_s": r.trace["idle_by_span"] if r.trace else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default=None)
    own, rest = ap.parse_known_args(argv)
    got = {}
    run_cell = harness.run_cell

    def keep(*args, **kwargs):
        got["out"] = run_cell(*args, **kwargs)
        return got["out"]

    harness.run_cell = keep
    try:
        rc = run.main(rest)
    finally:
        harness.run_cell = run_cell
    if "out" in got:
        line = json.dumps({"breakdown_by_program_span": summary(got["out"])})
        print(line, file=sys.stderr, flush=True)
        if own.out:
            Path(own.out).parent.mkdir(parents=True, exist_ok=True)
            with open(own.out, "a") as fh:
                fh.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
