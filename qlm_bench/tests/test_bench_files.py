"""A configuration, a traffic mix, a cell's values and a metric dropped in
as new files are picked up by name, with no edit to a file that exists."""
import copy
import json
import shutil

from qlm_bench import generator, harness
from qlm_bench.tests.small import SEED, one_thread, small


def test_new_files_are_picked_up(tmp_path):
    bench = tmp_path / "qlm_bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec, config, traffic = small("granite-3-2b.mixed-slo")
    config = copy.deepcopy(config)
    config["name"] = "tiny-granite"
    (bench / "configs" / "tiny-granite.json").write_text(json.dumps(config))
    traffic = copy.deepcopy(traffic)
    traffic["rate"] = 1.0
    (bench / "traffic" / "chat-short.json").write_text(json.dumps(traffic))
    (bench / "cells" / "tiny-granite.chat-short.json").write_text(
        json.dumps({"rate": 6.0}))
    (bench / "metrics" / "requests_seen.py").write_text(
        "def read(run, qualifier=None):\n"
        "    return float(len(run.seen))\n")
    before = {p: p.read_bytes() for p in harness.BENCH.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    spec = copy.deepcopy(spec)
    spec["workloads"].append({"name": "tiny-granite.chat-short",
                              "config": "tiny-granite",
                              "traffic": "chat-short", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "requests_seen", "unit": "count",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-granite.chat-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    got = harness.traffic_of(harness.cell_of(spec, "tiny-granite.chat-short"),
                             bench)
    assert got["rate"] == 6.0
    with one_thread():
        out = harness.run_cell("tiny-granite.chat-short", SEED, 1.0, False,
                               device="cpu", bench=bench)
    assert out["correct"]
    # the mix's rate 1/s was replaced by the cell's 6/s
    vocab = config["model"]["vocab_size"]
    at_6 = len(generator.schedule(got, SEED, 1.0, vocab))
    at_1 = len(generator.schedule(traffic, SEED, 1.0, vocab))
    assert out["metrics"]["requests_seen"]["value"] == at_6 > at_1
    assert "tokens_per_s" in out["metrics"]
    after = {p: p.read_bytes() for p in harness.BENCH.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after
