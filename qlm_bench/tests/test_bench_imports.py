"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (``repro_torch`` passes, ``repro`` does not); the
reference, its families and the counting import nothing of the port."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    bad = set(_imports(path)) & FORBIDDEN
    assert not bad, (path, bad)


@pytest.mark.parametrize("name", ["reference.py", "counting.py",
                                  "generator.py", "weights.py"] + sorted(
    str(p.relative_to(BENCH)) for p in (BENCH / "families").glob("*.py")))
def test_the_yardstick_imports_nothing_of_the_port(name):
    assert "repro_torch" not in set(_imports(BENCH / name))


def test_the_check_is_by_whole_name():
    from qlm_bench import run
    names = ["repro_torch", "repro_torch.serving", "jaxtyping", "reproduce",
             "repro", "repro.serving.engine", "jax.numpy", "flax", "jaxlib"]
    assert run.forbidden_modules(names) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.serving.engine"]


def test_the_harness_loads_no_jax():
    """A small run in a fresh process: neither JAX nor the JAX package is
    loaded once the window has closed."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from qlm_bench.tests.small import run_small\n"
        "from qlm_bench import run\n"
        "out = run_small('granite-3-2b.mixed-slo', seconds=0.5)\n"
        "print(out['correct'], run.forbidden_modules())\n"
        % (str(BENCH.parent / "src"), str(BENCH.parent)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "granite-3-2b.mixed-slo", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=240,
        cwd=BENCH.parent)
    assert res.returncode != 0 and res.stdout.strip() == ""
