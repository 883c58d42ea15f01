"""The port's lint (``repro_torch.analysis.lint``): twins of
``tests/test_qlint.py``.  The framework-neutral rules (blocking-in-async,
unguarded-div, waivers, fingerprints, the baseline gate and the JSON
report) give the reference's findings on the same text; host-sync-in-
hot-path knows torch's syncs and blocking uploads; retrace-hazard flags
graph capture and compiles per iteration or round; the reference's two
JAX-only rules are absent; the port's tree is clean and the self-test
flags an injected ``torch.cuda.synchronize()``."""
import json
import textwrap

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint


def _write(tmp_path, src, name="mod.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


def _lint(tmp_path, src, name="mod.py"):
    return lint.lint_file(str(_write(tmp_path, src, name)))


def _active(findings):
    return [f for f in findings if not f.waived]


def _rules(findings):
    return [f.rule for f in _active(findings)]


def _key(findings):
    return [(f.rule, f.line, f.col, f.message, f.waived, f.waive_reason)
            for f in findings]


# ---------------------------------------------------------------------------
# parity with the reference on its framework-neutral fixtures
# ---------------------------------------------------------------------------

SHARED = {
    "time_sleep_in_coroutine": """
        import time

        async def poll():
            time.sleep(0.1)
    """,
    "queue_get_in_coroutine": """
        import queue

        inbox = queue.Queue()

        async def pump():
            return inbox.get()
    """,
    "engine_step_unless_offloaded": """
        import asyncio

        async def serve(engine, loop):
            engine.step()
            await loop.run_in_executor(None, lambda: engine.steps(4))
    """,
    "sync_code_never_flagged": """
        import time

        def warmup():
            time.sleep(0.1)
    """,
    "unguarded_counter_division": """
        def attainment(self):
            return self.met / self.scored
    """,
    "div_guarded_by_ternary": """
        def attainment(self):
            return self.met / self.scored if self.scored else 1.0
    """,
    "div_guarded_by_early_return": """
        def attainment(self):
            if not self.scored:
                return 1.0
            return self.met / self.scored
    """,
    "div_len_denominator": """
        def mean_ttft(served):
            return sum(served) / len(served)
    """,
    "div_max_rebind": """
        def rate(done, total):
            total = max(total, 1)
            return done / total
    """,
    "trailing_waiver_with_reason": """
        class Engine:
            def _decode_round(self):
                return self.lengths.item()  # qlint: disable=host-sync-in-hot-path -- single documented sync per round
    """,
    "standalone_waiver_covers_next_line": """
        class Engine:
            def _decode_round(self):
                # qlint: disable=host-sync-in-hot-path -- warmup only
                return self.lengths.item()
    """,
    "waiver_missing_reason": """
        class Engine:
            def _decode_round(self):
                return self.lengths.item()  # qlint: disable=host-sync-in-hot-path
    """,
    "waiver_for_other_rule": """
        class Engine:
            def _decode_round(self):
                return self.lengths.item()  # qlint: disable=unguarded-div -- wrong rule
    """,
    "item_in_hot_path": """
        class Engine:
            def _decode_round(self):
                n = self.lengths.item()
                return n
    """,
    "silent_outside_hot_path": """
        class Engine:
            def _decode_round(self):
                return 0

            def debug_dump(self):
                return self.lengths.item()
    """,
    "numpy_conversion_waived": """
        import numpy as np

        class Engine:
            def _prefill_chunk_round(self, req):
                return np.asarray(req.prompt_tokens)  # qlint: disable=host-sync-in-hot-path -- host prompt list -> array
    """,
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_rules_give_the_references_findings(tmp_path, name):
    p = _write(tmp_path, SHARED[name])
    got = lint.lint_file(str(p))
    want = ref_lint.lint_file(str(p))
    assert _key(got) == _key(want)
    assert [f.fingerprint for f in got] == [f.fingerprint for f in want]


def test_fingerprint_is_line_independent_and_the_references():
    a = lint.Finding("unguarded-div", "m.py", 3, 4, "division by `x`")
    b = lint.Finding("unguarded-div", "m.py", 90, 0, "division by `x`")
    c = lint.Finding("unguarded-div", "m.py", 3, 4, "division by `y`")
    assert a.fingerprint == b.fingerprint != c.fingerprint
    assert a.fingerprint == ref_lint.Finding(
        "unguarded-div", "m.py", 3, 4, "division by `x`").fingerprint


_VIOLATION = """
def attainment(self):
    return self.met / self.scored
"""


def _baseline_flow(main, tmp_path, capsys):
    """The reference's baseline test as a sequence of (exit code, output)
    and the baseline file's contents."""
    mod = tmp_path / "m.py"
    mod.write_text(_VIOLATION)
    base = tmp_path / "baseline.json"
    base.unlink(missing_ok=True)
    steps = [main([str(mod), "--baseline", str(base)]),
             main([str(mod), "--baseline", str(base), "--write-baseline"]),
             main([str(mod), "--baseline", str(base)])]
    written = json.loads(base.read_text())
    mod.write_text("x = 1\n\n" + _VIOLATION +
                   "\ndef r(self):\n    return self.ok / self.count\n")
    capsys.readouterr()
    steps.append(main([str(mod), "--baseline", str(base)]))
    return steps, written, capsys.readouterr().out


def test_baseline_gate_is_the_references(tmp_path, capsys):
    got = _baseline_flow(lint.main, tmp_path, capsys)
    want = _baseline_flow(ref_lint.main, tmp_path, capsys)
    assert got == want
    steps, written, out = got
    assert steps == [1, 0, 0, 1] and len(written["fingerprints"]) == 1
    assert "self.count" in out and "self.scored" not in out


def test_json_report_is_the_references(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("def f(self):\n"
                   "    return self.a / self.scored  "
                   "# qlint: disable=unguarded-div -- test fixture\n")
    reports = []
    for main in (lint.main, ref_lint.main):
        report = tmp_path / "report.json"
        assert main([str(mod), "--baseline", str(tmp_path / "b.json"),
                     "--json", str(report)]) == 0
        reports.append(json.loads(report.read_text()))
    assert reports[0] == reports[1]
    assert reports[0]["summary"] == {"active": 0, "waived": 1,
                                     "baselined": 0}


# ---------------------------------------------------------------------------
# host-sync-in-hot-path: torch's syncs, reached through helpers
# ---------------------------------------------------------------------------

def _through_helpers(body):
    """A hot entry -> self-method -> module function whose body is
    ``body`` (one statement on ``x``)."""
    return f"""
        import numpy as np
        import torch

        def _pull(x):
            {body}

        class Engine:
            def _decode_round(self):
                return self._helper()

            def _helper(self):
                return _pull(self.lengths)
    """


TORCH_SYNCS = {
    "item": ("return x.item()", ".item()"),
    "tolist": ("return x.tolist()", ".tolist()"),
    "cpu": ("return x.cpu()", ".cpu()"),
    "cpu_numpy": ("return x.cpu().numpy()", ".cpu()"),
    "to_cpu": ('return x.to("cpu")', '.to("cpu")'),
    "numpy": ("return x.numpy()", ".numpy()"),
    "synchronize": ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    "stream_synchronize": ("x.synchronize()", ".synchronize()"),
    "np_asarray": ("return np.asarray(x)", "numpy.asarray()"),
    "bool_of_tensor": ("done = torch.any(x)\n            return bool(done)",
                       "bool(done)"),
    "int_of_torch_call": ("return int(torch.argmax(x))",
                          "int(torch.argmax(...))"),
    "torch_tensor_upload": ('return torch.tensor(x, device="cuda")',
                            "torch.tensor(..., device=...)"),
    "as_tensor_upload": ("return torch.as_tensor(x, device=dev)",
                         "torch.as_tensor(..., device=...)"),
    "to_device_upload": ("return x.to(self_device)", ".to(<device>)"),
    "cuda_upload": ("return x.cuda()", ".cuda(<device>)"),
}


@pytest.mark.parametrize("name", sorted(TORCH_SYNCS))
def test_torch_sync_in_hot_path_is_flagged_through_helpers(tmp_path, name):
    body, text = TORCH_SYNCS[name]
    fs = _active(_lint(tmp_path, _through_helpers(body)))
    assert [f.rule for f in fs] == ["host-sync-in-hot-path"], fs
    assert text in fs[0].message and "`_pull`" in fs[0].message


@pytest.mark.parametrize("name", sorted(TORCH_SYNCS))
def test_the_same_calls_outside_the_hot_path_are_silent(tmp_path, name):
    src = _through_helpers(TORCH_SYNCS[name][0]).replace(
        "def _decode_round", "def _warmup") + """
            def _prefill_chunk_round(self):
                return 0
    """
    assert _rules(_lint(tmp_path, src)) == []


def test_a_waived_torch_sync_is_silent(tmp_path):
    fs = _lint(tmp_path, """
        import torch

        class Engine:
            def _decode_round(self):
                torch.cuda.synchronize()  # qlint: disable=host-sync-in-hot-path -- documented timed-region sync
    """)
    assert _rules(fs) == [] and len(fs) == 1 and fs[0].waived


@pytest.mark.parametrize("body", [
    "return x.to(dev, non_blocking=True)",
    "return x.pin_memory().cuda(non_blocking=True)",
    "return x.to(torch.int32)",
    "return x.to(self.cfg.dtype)",
    "return torch.tensor(x)",
    "return torch.tensor(x, device=\"cpu\")",
    "return int(x[0])",
], ids=["non_blocking", "pinned_cuda", "dtype_cast", "dtype_attr",
        "host_tensor", "cpu_tensor", "int_of_host_value"])
def test_non_syncing_calls_in_the_hot_path_are_silent(tmp_path, body):
    assert _rules(_lint(tmp_path, _through_helpers(body))) == []


# ---------------------------------------------------------------------------
# retrace-hazard: capture and compile once, never per iteration or round
# ---------------------------------------------------------------------------

def test_torch_compile_in_a_loop_is_flagged(tmp_path):
    fs = _lint(tmp_path, """
        import torch

        def build(fns):
            out = []
            for f in fns:
                out.append(torch.compile(f))
            return out
    """)
    assert _rules(fs) == ["retrace-hazard"]
    assert "inside a loop" in fs[0].message


def test_graph_capture_in_a_round_is_flagged(tmp_path):
    fs = _lint(tmp_path, """
        import torch

        class Engine:
            def _decode_round(self):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    self._step()
                g.replay()
    """)
    assert _rules(fs) == ["retrace-hazard", "retrace-hazard"]
    assert all("`_decode_round`" in f.message for f in fs)


def test_capture_once_at_construction_is_clean(tmp_path):
    fs = _lint(tmp_path, """
        import torch

        class Engine:
            def __init__(self):
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self._step()

            def _decode_round(self):
                self.graph.replay()
    """)
    assert _rules(fs) == []


# ---------------------------------------------------------------------------
# the two rules torch has no counterpart of
# ---------------------------------------------------------------------------

def test_the_jax_only_rules_are_absent(tmp_path):
    assert "use-after-donate" not in lint.RULES
    assert "pallas-traced-branch" not in lint.RULES
    assert set(lint.RULES) == set(ref_lint.RULES) - {
        "use-after-donate", "pallas-traced-branch"}
    donate = _lint(tmp_path, """
        import jax

        class Engine:
            def __init__(self, f):
                self._step_fn = jax.jit(f, donate_argnums=(0,))

            def go(self, tok):
                out = self._step_fn(self.cache, tok)
                return self.cache
    """)
    branch = _lint(tmp_path, """
        def decode_kernel(q_ref, acc):
            x = q_ref
            if x > 0:
                return acc
            return acc
    """, name="kernels/attn.py")
    assert donate == [] and branch == []


# ---------------------------------------------------------------------------
# the port's tree + self-test
# ---------------------------------------------------------------------------

def test_the_ports_tree_is_clean():
    assert lint.main(["src/repro_torch", "--baseline",
                      "qlint_baseline.json"]) == 0


def test_self_test_flags_an_injected_synchronize(capsys):
    assert lint.main(["src/repro_torch", "--self-test"]) == 0
    out = capsys.readouterr().out
    assert "self-test OK" in out and "torch.cuda.synchronize()" in out


def test_the_engines_documented_syncs_are_waived():
    """Each round's result copy and the one timed-region sync are waived
    with a reason; no blocking upload is left in the engine."""
    fs = lint.lint_file("src/repro_torch/serving/engine.py")
    hot = [f for f in fs if f.rule == "host-sync-in-hot-path"]
    assert hot and all(f.waived and f.waive_reason for f in hot)
    assert not any("host->device" in f.message for f in hot)
    messages = " ".join(f.message for f in hot)
    for fn in ("_sync", "_prefill_chunk_round", "_decode_round",
               "_decode_burst_round", "_extract_cache", "_extract_pages"):
        assert f"`{fn}`" in messages, fn
