"""The port stands alone: no module of fks_tpu_torch, and not
chip_smoke.py, imports JAX or the fks_tpu package; chip_smoke.py refuses
to run without the card or outside a checkout."""
import ast
import pathlib
import shutil
import subprocess
import sys

import jax  # noqa: F401  (the scan itself needs neither framework)
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "fks_tpu"}


def imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def port_files():
    files = sorted((ROOT / "fks_tpu_torch").rglob("*.py"))
    assert len(files) > 15
    return files + [ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_fks_tpu():
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in port_files() for mod, line in imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_scan_covers_the_read_back_and_tool_modules():
    """The read-back modules, the lint and the profiling tools are port
    files like any other: the scan reaches them."""
    files = set(port_files())
    for rel in ("tools/profile_step.py", "tools/measure_tiers.py",
                "tools/__init__.py", "analysis/lint.py", "obs/compare.py",
                "obs/exporter.py", "obs/history.py", "obs/report.py"):
        assert ROOT / "fks_tpu_torch" / rel in files, rel


def test_chip_smoke_is_scanned_and_clean():
    """chip_smoke.py runs on the card machine, where JAX is not installed:
    the scan covers it, and it imports neither JAX nor fks_tpu."""
    smoke = ROOT / "chip_smoke.py"
    assert smoke in port_files()
    roots = {mod for mod, _ in imported_roots(smoke)}
    assert "fks_tpu_torch" in roots and not roots & FORBIDDEN


def test_scan_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom fks_tpu.sim import flat\n"
                     "import fks_tpu_torch\n")
    assert [m for m, _ in imported_roots(probe)] == [
        "jax", "fks_tpu", "fks_tpu_torch"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")


def test_chip_smoke_fails_without_card(no_card):
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


CONTROL_PLANE = ("pipeline/__init__.py", "pipeline/controller.py",
                 "pipeline/drills.py", "pipeline/faults.py",
                 "pipeline/state.py", "resilience/drain.py",
                 "resilience/drills.py", "portfolio/fleet.py",
                 "obs/recorder.py", "obs/report.py", "utils/logging.py")


def test_control_plane_modules_are_scanned_and_import():
    """The control plane's modules are in the scan, and each imports on
    its own with neither JAX nor fks_tpu among its imports."""
    import importlib

    scanned = set(port_files())
    for rel in CONTROL_PLANE:
        path = ROOT / "fks_tpu_torch" / rel
        assert path in scanned, rel
        assert not {m for m, _ in imported_roots(path)} & FORBIDDEN, rel
        mod = "fks_tpu_torch." + rel[:-3].replace("/", ".").replace(
            ".__init__", "")
        importlib.import_module(mod)
