"""The port's roofline and hillclimb driver (``repro_torch.launch.
roofline``, ``repro_torch.launch.hillclimb``) and the dry run's byte count
(``launch/comm_analysis.py``):

* ``roofline.analyze`` equals ``benchmarks/roofline.py``'s ``analyze`` on
  the same records, with the reference's four constants set to the
  port's (H100) ones; so do its table and its JSON;
* ``DeviceCounter``'s bytes equal a hand count for a linear layer on fake
  1 x 1 and 1 x 2 meshes (a sharded weight halves its term, views add
  nothing) and for an in-place op;
* each hillclimb target runs on a fake 2 x 2 mesh at a reduced config
  and shape, writes one tagged record per variant (bytes accessed at
  least the argument bytes) and reads them back on a second run; the
  CLI prints the granite-decode report lines.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib

import pytest
import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.launch import dryrun, hillclimb, roofline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.comm_analysis import DeviceCounter

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONSTANTS = ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_BYTES")


@pytest.fixture
def ref_roofline(monkeypatch):
    """``benchmarks/roofline.py`` loaded by path, its constants the
    port's."""
    spec = importlib.util.spec_from_file_location(
        "ref_roofline", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in CONSTANTS:
        monkeypatch.setattr(mod, name, getattr(roofline, name))
    return mod


def _small(shape):
    return dataclasses.replace(shape, global_batch=8, seq_len=8)


def _reduced(get_arch):
    return lambda arch: get_arch(arch).reduced(num_layers=1, d_model=64,
                                               vocab_size=128)


@pytest.fixture(scope="module")
def climbed(tmp_path_factory):
    """Every target on a fake 2 x 2 mesh at a reduced config and shape:
    (records dir, first run's output, second run's output)."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "OUT_DIR", out)
        mp.setattr(dryrun, "get_arch", _reduced(dryrun.get_arch))
        mesh_lib.release()
        try:
            mesh = mesh_lib.make_debug_mesh(2, 2)
            for _ in range(2):
                with contextlib.redirect_stdout(io.StringIO()) as buf:
                    hillclimb.run(list(hillclimb.TARGETS), mesh=mesh,
                                  shape_transform=_small)
                runs.append(buf.getvalue().splitlines())
        finally:
            mesh_lib.release()
    return (out, *runs)


def _records(out):
    return [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]


# ---------------------------------------------------------------------------
# roofline against the reference
# ---------------------------------------------------------------------------

def _synthetic():
    base = {"arch": "granite-3-2b", "shape": "train_4k", "mesh": "pod16x16",
            "tag": "", "applicable": True, "n_chips": 256,
            "cost": {"flops_per_device": 1.0e12,
                     "bytes_accessed_per_device": 4.0e11,
                     "transcendentals": None},
            "collectives": {"bytes_by_op": {"all-gather": 3.0e9},
                            "total_bytes": 3.0e9},
            "memory": {"peak_bytes_per_device": 9.0e10},
            "model_active_params": 2.5e9, "dropped_shardings": ["x"]}
    return [base,
            {**base, "shape": "decode_32k", "tag": "pet",
             "memory": {"peak_bytes_per_device": 2.0e10}},
            {**base, "cost": {**base["cost"], "flops_per_device": 0.0}},
            {"arch": "granite-3-2b", "shape": "long_500k", "mesh": "pod16x16",
             "tag": "", "applicable": False, "skip_reason": "full attention"}]


@pytest.mark.parametrize("correct", [True, False])
def test_analyze_equals_the_references(ref_roofline, climbed, correct):
    recs = _synthetic() + _records(climbed[0])
    assert len(recs) == 4 + 13
    for rec in recs:
        assert roofline.analyze(rec, correct) == \
            ref_roofline.analyze(rec, correct), rec.get("tag")
    # the undercount correction fired on the synthetic train record
    assert roofline.analyze(recs[0])["scan_undercount_corrected"]


def test_table_and_json_equal_the_references(ref_roofline, tmp_path,
                                             monkeypatch, climbed):
    records = tmp_path / "dryrun_torch"
    records.mkdir()
    for i, rec in enumerate(_synthetic() + _records(climbed[0])):
        (records / f"r{i:02d}.json").write_text(json.dumps(rec))
    for mod in (roofline, ref_roofline):
        monkeypatch.setattr(mod, "DRYRUN_DIR", str(records))
    for mesh, tag in (("pod16x16", ""), ("mesh2x2", "pet")):
        rows = roofline.roofline_table(mesh, tag)
        assert rows and rows == ref_roofline.roofline_table(mesh, tag)
        assert roofline.format_table(rows) == \
            ref_roofline.format_table(rows)
    monkeypatch.setattr(roofline, "EXPERIMENTS", str(tmp_path))
    (summary,) = roofline.main()
    assert summary[0] == "roofline_table" and "fit 80 GB HBM" in summary[2]
    table = json.loads((tmp_path / "roofline_table_torch.json").read_text())
    assert table == ref_roofline.roofline_table()


def test_the_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.HBM_BYTES) == (989e12, 3.35e12, 50e9, 80e9)


# ---------------------------------------------------------------------------
# DeviceCounter's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(1, 1), (1, 2)], ids=["1x1", "1x2"])
def test_bytes_of_a_linear_layer_by_hand(dims):
    """(4, 8, 64) @ (32, 64)^T in f32, the weight sharded over "model":
    the product reads x and the weight's shard and writes the output's
    shard; the transpose and the reshapes around the product add 0."""
    mesh_lib.release()
    try:
        mesh = mesh_lib.make_debug_mesh(*dims)
        x = distribute_tensor(torch.empty(4, 8, 64, device="meta"), mesh,
                              [Replicate(), Replicate()])
        w = distribute_tensor(torch.empty(32, 64, device="meta"), mesh,
                              [Replicate(), Shard(0)])
        with DeviceCounter() as counter:
            y = F.linear(x, w)
        m = dims[1]
        assert y.placements == (Replicate(), Shard(2))
        assert counter.bytes_accessed == 4 * (4 * 8 * 64 + 32 * 64 // m
                                              + 4 * 8 * 32 // m)
        assert counter.flops == 2 * 4 * 8 * 64 * 32 // m
    finally:
        mesh_lib.release()


def test_bytes_of_in_place_and_view_ops():
    x = torch.empty(16, 8, device="meta")
    y = torch.empty(16, 8, device="meta")
    with DeviceCounter() as counter:
        x.add_(y)                    # x read and written, y read
    assert counter.bytes_accessed == 3 * 16 * 8 * 4
    with DeviceCounter() as counter:
        x.t().view(8, 16)[0]
        torch.empty(1024, device="meta")
    assert counter.bytes_accessed == 0


# ---------------------------------------------------------------------------
# the hillclimb targets on a fake 2 x 2 mesh
# ---------------------------------------------------------------------------

def _tags(gen):
    return [v["tag"] for v in gen()]


def test_every_target_writes_one_tagged_record_per_variant(climbed):
    out, first, _ = climbed
    recs = _records(out)
    want = {(arch, shape, tag) for arch, shape, gen in
            hillclimb.TARGETS.values() for tag in _tags(gen)}
    assert {(r["arch"], r["shape"], r["tag"]) for r in recs} == want
    assert len(recs) == len(want) == 2 + 8 + 3
    for r in recs:
        assert r["mesh"] == "mesh2x2" and r["applicable"]
        assert r["cost"]["bytes_accessed_per_device"] >= \
            r["memory"]["argument_bytes_per_device"] > 0
    reports = [line for line in first if line.startswith("  tag=")]
    assert len(reports) == 13
    assert all("fallbacks=" in line for line in reports)
    # the MoE ranks its pairs by counts (no searchsorted), and the
    # grouped dispatch runs on each device's own groups: no op of its
    # sort, ranking, scatter or combine falls back
    dispatch = ("searchsorted", "sort", "scatter", "gather", "cumsum")
    for r in recs:
        assert set(r["fallback_collective_bytes"]) == set(r["fallback_ops"])
        if r["arch"] == "qwen3-moe-30b-a3b":
            assert "aten.searchsorted.Tensor" not in r["fallback_ops"]
            assert not [op for op in r["fallback_ops"]
                        if any(w in op for w in dispatch)], r["tag"]


def test_the_targets_are_the_references():
    ref = (ROOT / "src" / "repro" / "launch" / "hillclimb.py").read_text()
    for key, (arch, shape, gen) in hillclimb.TARGETS.items():
        assert f'"{key}": ("{arch}", "{shape}", {gen.__name__})' in ref
        tags = _tags(gen)
        at = [ref.index(f'tag="{t}"') for t in tags]
        assert at == sorted(at), key


def test_a_second_run_reads_the_cached_records(climbed):
    _, first, second = climbed
    cached = [line for line in second if line.startswith("  tag=")]
    assert len(cached) == 13 and all(line.endswith("(cached)")
                                     for line in cached)
    strip = [line.replace("   (cached)", "") for line in cached]
    assert strip == [line for line in first if line.startswith("  tag=")]


def test_the_cli_prints_the_granite_decode_lines(tmp_path, monkeypatch,
                                                 capsys):
    """On the fake 16 x 16 production mesh, at a reduced config."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "get_arch", _reduced(dryrun.get_arch))
    mesh_lib.release()
    try:
        hillclimb.main(["--target", "granite-decode"])
    finally:
        mesh_lib.release()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "=== granite-decode: granite-3-2b × decode_32k ==="
    assert [line.split()[0] for line in out[1:]] == ["tag=pet",
                                                    "tag=kvquant8"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "granite-3-2b__decode_32k__pod16x16__kvquant8.json",
        "granite-3-2b__decode_32k__pod16x16__pet.json"]
