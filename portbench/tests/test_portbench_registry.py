"""Cells, configurations, mixes and metrics resolve by name, and a cell
added as files runs without an edit to any file that was there."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def bench():
    return harness.load_benchmark(ROOT)


def test_every_cell_resolves_to_its_files():
    b = bench()
    for cell in b["workloads"]:
        cfg = harness.load_json("configs", cell["config"])
        mix = harness.load_json("traffic", cell["traffic"])
        assert cfg["name"] == cell["config"]
        assert harness.loop(mix).run
        assert harness.metrics_of(b, cell["name"], False)
        assert harness.metrics_of(b, cell["name"], True)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(group):
    for m in bench()[group]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert harness.read_metric(m["name"], {}) is None


def test_metrics_of_a_cell_follow_workloads_lists():
    b = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
         "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.metrics_of(b, "x", False)] == \
        ["a", "b"]
    assert [m["name"] for m in harness.metrics_of(b, "y", False)] == ["a"]
    assert harness.metrics_of(b, "x", True) == []


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.find_cell(bench(), "no-such-cell")


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_cell_added_as_files_runs_without_edits(tmp_path):
    """A new configuration (the default cluster under the first 120 pods
    of the trace), a new mix and a new per-layer metric, added as files
    and entries in a copy; the copy's harness runs the new cell on the
    CPU with no existing file changed."""
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "openb16.json").read_text())
    cfg["name"] = "openb16-tiny"
    (pb / "configs" / "openb16-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "search-fused-pop256.json")
                     .read_text())
    mix.update(pop=6, warmup_generations=1, check_parts=2)
    (pb / "traffic" / "search-fused-pop6.json").write_text(json.dumps(mix))
    (pb / "metrics" / "search.generations.py").write_text(
        "def read(rec):\n    return rec.get('generations')\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "openb16-tiny", "source": "x",
                         "file": "portbench/configs/openb16-tiny.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny", "config": "openb16-tiny",
                           "traffic": "search-fused-pop6", "chips": 1,
                           "why": "test"})
    next(m for m in b["end_to_end"] if m["name"] == "cand_evals_per_s")[
        "workloads"].append("tiny")
    b["per_layer"].append({"name": "search.generations", "unit": "gen",
                           "better": "higher", "source": "program_counter",
                           "layer": "evolution search",
                           "moves": "cand_evals_per_s",
                           "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "line, rec = harness.run_cell(Path('.'), 'tiny', 7, 0.5, False, "
        "device='cpu', overrides={'max_pods': 120})\n"
        "print(json.dumps(line))\n")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"cand_evals_per_s", "setup_s"}
    assert line["attempted"] % 6 == 0 and line["attempted"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
