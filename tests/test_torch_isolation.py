"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX, the reference package or its
``benchmarks``; the plain-Python modules it copies stay equal to their
reference sources (after the import rewrite and the rewordings listed in
``REWORDED``, with the port's tracing lines and the additions listed in
``ADDED`` taken out); and its entry points refuse to fall back to the
CPU when CUDA is missing."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

# verbatim copies: equal to the reference after the import rewrite
COPIES = ["configs/base.py", "configs/granite_3_2b.py",
          "configs/h2o_danube_1_8b.py", "configs/mamba2_130m.py",
          "core/__init__.py",
          "core/request.py", "core/rwt_estimator.py",
          "core/request_group.py", "core/solver.py", "core/virtual_queue.py",
          "core/global_scheduler.py", "core/routing.py", "core/qlm.py",
          "core/lso.py", "serving/kv_cache.py", "analysis/invariants.py",
          "training/data_pipeline.py", "core/autoscale.py",
          "serving/faults.py", "serving/cluster.py", "serving/frontend.py",
          "data/__init__.py", "data/sharegpt_synth.py", "data/workload.py",
          "serving/__init__.py", "core/policies.py", "core/priority.py",
          "sim/profiles.py", "sim/simulator.py", "configs/qwen1_5_32b.py",
          "configs/deepseek_67b.py", "configs/qwen3_moe_30b_a3b.py",
          "configs/dbrx_132b.py", "configs/llava_next_34b.py",
          "configs/zamba2_1_2b.py", "configs/whisper_medium.py",
          "configs/registry.py"]


def _rewrite(src: str) -> str:
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.", src,
                  flags=re.M)


# copies whose reference text numbers the reference's own change
# requests: the port's copy words those notes without the numbers and is
# otherwise equal (each pattern must match exactly once in the reference)
REWORDED = {
    "core/autoscale.py": [(r"\(the PR \d+ ``--admit-drain slo``",
                           "(the ``--admit-drain slo``")],
    "serving/faults.py": [(r"the pool-reset path PR \d+ gates;",
                           "the gated pool-reset path;")],
    "serving/frontend.py": [(r"PR \d+'s prefix index", "the prefix index")],
}


# the port's spans (``repro_torch/tracing.py``): a copy may import the
# recorder and carry ``@tracing.spanned(...)`` decorators, which record
# only under a profiler; both are taken out before the comparison
TRACING = re.compile(r"^from repro_torch import tracing\n"
                     r"|^[ \t]*@tracing\.spanned\((?:[^()]|\([^()]*\))*\)\n",
                     re.M)

# what a copy adds to its reference, each exactly once: the queue-wait
# timestamp the engine stamps at a request's first admission
ADDED = {
    "core/request.py": [
        "    # when a slot first took the request, on the engine's clock: "
        "the end\n"
        "    # of its wait in the queue.  Kept across eviction, resume and\n"
        "    # restart(), as first_token_time is\n"
        "    admit_time: Optional[float] = None\n",
        "\n        ``admit_time`` is kept likewise: the request left the "
        "queue then."],
}


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots


def test_importing_every_module_loads_no_jax():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        .replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m.rstrip('.'))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_its_reference(rel):
    ref = _rewrite((REF / rel).read_text())
    for pattern, words in REWORDED.get(rel, []):
        ref, n = re.subn(pattern, words, ref)
        assert n == 1, pattern
    port = TRACING.sub("", (PORT / rel).read_text())
    for added in ADDED.get(rel, []):
        assert port.count(added) == 1, added
        port = port.replace(added, "")
    assert port == ref


def test_engine_without_cuda_raises_instead_of_using_the_cpu(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_registry
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_arch("granite-3-2b").reduced(num_layers=1,
                                                         d_model=64))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(model, params, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_registry(["granite-3-2b"])


def test_train_tiny_without_cuda_raises(monkeypatch):
    from repro_torch.launch import train_tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_tiny.main(["--small", "--steps", "1"])
