"""Nothing the benchmark runs imports JAX or the JAX package, the
reference imports nothing of the program, and nothing reads under the
JAX package's results folder. Module names are compared by their
top-level name, whole: ``fks_tpu_torch`` is the program, ``fks_tpu`` the
JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SOURCES = sorted(p for p in (ROOT / "portbench").rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    names = set(imported(path))
    assert not names & set(harness.FORBIDDEN), names
    if "reference" in path.relative_to(ROOT / "portbench").parts:
        assert "fks_tpu_torch" not in names


def test_whole_name_comparison():
    mods = dict(sys.modules)
    try:
        sys.modules["fks_tpu_torch_fake"] = sys
        sys.modules["jaxon"] = sys
        assert harness.forbidden_modules() == []
        sys.modules["fks_tpu.sub"] = sys
        assert harness.forbidden_modules() == ["fks_tpu.sub"]
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_no_path_under_the_jax_results():
    for path in SOURCES + sorted((ROOT / "portbench").rglob("*.json")):
        if "tests" in path.relative_to(ROOT / "portbench").parts:
            continue
        assert "benchmarks" not in path.read_text(), path


def test_a_run_loads_no_jax_module():
    """The loops, the reference and every metric reader, imported in a
    fresh interpreter with the program, leave no forbidden module."""
    code = (
        "import importlib, sys\n"
        "from portbench import harness\n"
        "import portbench.run, portbench.loops.search\n"
        "import portbench.reference.flat_sim, portbench.tools.control\n"
        "import fks_tpu_torch.funsearch.device_evolution\n"
        "import fks_tpu_torch.sim.fused, fks_tpu_torch.sim.flat\n"
        "for p in (harness.BENCH / 'metrics').glob('*.py'):\n"
        "    harness.read_metric(p.stem, {})\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
