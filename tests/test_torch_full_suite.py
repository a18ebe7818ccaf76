"""The port's CI gate runner (fks_tpu_torch.tools.run_full_suite) against
fks_tpu's ``tools/run_full_suite.py``, on the CPU.

- the gates are fks_tpu's 15, under its names and in its order;
- with ``subprocess.run`` replaced by a recorder answering every command
  as a passing (then as a failing) one would, both runners' evidence rows
  have the same keys and every gate the same detail keys;
- each gate's command lines are fks_tpu's with the port's module
  (``python -m fks_tpu_torch.cli``), but for the divergences the runner
  names (the evolve's ``--first-pods``, ``cli loadgen`` for ``bench.py
  --stage loadgen``, the port's tests in the pytest step); on the card
  ``--cpu`` is dropped, the mesh gates take the card count and the
  layout gate deals 8 logical shards;
- the cheap gates run for real with ``--cpu``: obs, trends, trace, scale.

The pytest step is never run here (the recorder answers it).
"""
import ast
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

import pytest

from fks_tpu_torch.tools import run_full_suite as pt

ROOT = pathlib.Path(__file__).resolve().parent.parent
PY = sys.executable


def load_fks_tpu_runner():
    spec = importlib.util.spec_from_file_location(
        "fks_tpu_tools_run_full_suite", ROOT / "tools" / "run_full_suite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def answer(cmd, passing):
    """What a passing (or failing) run of ``cmd`` prints and returns."""
    if not passing:
        return 3, "", "failed on purpose"
    text = " ".join(cmd)
    if "trends" in cmd and "regressed" in text:
        return 1, "ALERT: evals_per_sec dropped\n", ""
    if "portfolio" in cmd:
        return 0, json.dumps({"max_drift": 0.0, "mixed_max_drift": 0.0,
                              "swap": {"compiles": 0}, "n_slots": 4}), ""
    if "layout" in cmd:
        root = cmd[cmd.index("--history-root") + 1]
        pathlib.Path(root, "layouts.json").write_text("{}")
        return 0, json.dumps({"layouts_probed": 4, "parity_max_abs": 0.0,
                              "best_mesh_shape": "8x1"}), ""
    if "loadgen" in cmd:
        return 0, json.dumps({"requests": 9, "completed": 9, "errors": 0,
                              "loadgen_shed_rate": 0.0,
                              "loadgen_fairness_index": 0.99}), ""
    if "pytest" in cmd:
        return 0, "12 passed, 3 skipped in 1.0s\n", ""
    if cmd[:2] == ["git", "rev-parse"]:
        return 0, "abc1234\n", ""
    return 0, "", ""


@pytest.fixture
def recorded(monkeypatch):
    """``subprocess.run`` replaced: every command is recorded and
    answered by ``answer`` (``recorded["passing"]`` picks the answer)."""
    state = {"calls": [], "passing": True}

    def fake_run(cmd, **kw):
        state["calls"].append(list(cmd))
        rc, out, err = answer(list(cmd), state["passing"])
        return subprocess.CompletedProcess(cmd, rc, out, err)

    monkeypatch.setattr(subprocess, "run", fake_run)
    return state


def run_both(recorded, tmp_path, monkeypatch, port_argv=("--cpu",)):
    """(fks_tpu's row, its commands, the port's row, its commands)."""
    fk = load_fks_tpu_runner()
    monkeypatch.setattr(fk, "OUT", str(tmp_path / "fk.jsonl"))
    recorded["calls"].clear()
    fk.main()
    fk_calls = list(recorded["calls"])
    fk_row = json.loads((tmp_path / "fk.jsonl").read_text().splitlines()[-1])
    recorded["calls"].clear()
    pt.main([*port_argv, "--out", str(tmp_path / "pt.jsonl")])
    pt_calls = list(recorded["calls"])
    pt_row = json.loads((tmp_path / "pt.jsonl").read_text().splitlines()[-1])
    return fk_row, fk_calls, pt_row, pt_calls


def test_gates_are_fks_tpu_gates_in_its_order():
    tree = ast.parse((ROOT / "tools" / "run_full_suite.py").read_text())
    defined = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name.endswith("_gate")]
    (main,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == "main"]
    called = [n.value.func.id for n in main.body
              if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
              and getattr(n.value.func, "id", "").endswith("_gate")]
    assert sorted(called) == sorted(defined)
    assert list(pt.GATES) == called
    for name in pt.GATES:
        assert callable(getattr(pt, name))


@pytest.mark.parametrize("passing", [True, False], ids=["pass", "fail"])
def test_row_and_gate_keys_equal_fks_tpu(recorded, tmp_path, monkeypatch,
                                         passing):
    recorded["passing"] = passing
    fk_row, _, pt_row, _ = run_both(recorded, tmp_path, monkeypatch)
    assert set(pt_row) == set(fk_row)
    for name in pt.GATES:
        assert set(pt_row[name]) == set(fk_row[name]), name
        assert pt_row[name]["ok"] == fk_row[name]["ok"] == passing, name
    assert pt_row["rc"] == fk_row["rc"]
    if passing:
        assert pt_row["passed"] == fk_row["passed"] == 12
        assert pt_row["summary"] == fk_row["summary"]


def _normal(cmd):
    """A command with fks_tpu's module renamed to the port's and each
    temporary directory replaced by its last two path parts."""
    out = []
    for a in cmd:
        a = "fks_tpu_torch.cli" if a == "fks_tpu.cli" else a
        a = re.sub(r"^/.*/(tmp[^/]+)(/[^/]+)?$",
                   lambda m: "TMP" + (m.group(2) or ""), a)
        out.append(a)
    return out


def test_gate_commands_are_fks_tpu_commands(recorded, tmp_path,
                                            monkeypatch):
    _, fk_calls, _, pt_calls = run_both(recorded, tmp_path, monkeypatch)
    fk_calls = [_normal(c) for c in fk_calls]
    pt_calls = [_normal(c) for c in pt_calls]
    # the divergences the runner names, one by one
    (fk_load,) = [c for c in fk_calls if "bench.py" in " ".join(c)]
    assert fk_load[1:] == [str(ROOT / "bench.py"), "--stage", "loadgen"]
    (pt_load,) = [c for c in pt_calls if "loadgen" in c]
    assert pt_load[:4] == [PY, "-m", "fks_tpu_torch.cli", "loadgen"]
    assert pt_load[4:] == ["--cpu", "--engine", "flat", "--tenants",
                           "a:closed:2,b:closed:2", "--duration", "2",
                           "--http", "--max-pods", "8", "--max-batch", "2",
                           "--run-dir", "TMP/loadgen"]
    (fk_test,) = [c for c in fk_calls if "pytest" in c]
    (pt_test,) = [c for c in pt_calls if "pytest" in c]
    assert fk_test[-2:] == pt_test[-2:] == ["-m", "slow or not slow"]
    files = [a for a in pt_test if a.startswith("tests/")]
    assert files == pt.test_files(True)
    assert "tests/test_torch_full_suite.py" in files
    assert all(re.match(r"tests/test_torch_\w+\.py$", f) for f in files)
    (pt_evolve,) = [c for c in pt_calls if "evolve" in c]
    i = pt_evolve.index("--first-pods")
    assert pt_evolve[i + 1] == "256"
    del pt_evolve[i:i + 2]
    # the rest: fks_tpu's commands with the port's module, in its order
    rest_fk = [c for c in fk_calls if c not in (fk_load, fk_test)]
    rest_pt = [c for c in pt_calls if c not in (pt_load, pt_test)]
    assert rest_pt == rest_fk
    assert len(rest_pt) == 22  # git and 21 gate commands


def test_gate_commands_on_the_card(recorded, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    _, fk_calls, _, pt_calls = run_both(recorded, tmp_path, monkeypatch,
                                        port_argv=())
    assert not any("--cpu" in c for c in pt_calls)
    # fks_tpu's gates always pass --cpu (but to the host-only commands)
    assert all("--cpu" in c for c in fk_calls
               if "fks_tpu.cli" in c and not {"trends", "compare",
                                              "spans"} & set(c))
    devices = [c[c.index("--devices") + 1] for c in pt_calls
               if "--devices" in c]
    assert devices == ["1"] * 4  # sharded serve, memory, portfolio, layout
    (layout,) = [c for c in pt_calls if "layout" in c]
    assert layout[layout.index("--logical-shards") + 1] == "8"
    (test,) = [c for c in pt_calls if "pytest" in c]
    assert test[-2:] == ["-m", "gpu"]


def test_test_files_on_the_card():
    """On the card: the files with gpu-marked tests that import neither
    the reference nor another test module."""
    files = pt.test_files(False)
    assert "tests/test_torch_gpu.py" in files
    assert "tests/test_torch_cli.py" not in files
    assert set(files) < set(pt.test_files(True))
    for f in files:
        src = (ROOT / f).read_text()
        assert "pytest.mark.gpu" in src
        assert not re.search(r"^(import|from) (jax|fks_tpu|tests)\b", src,
                             re.M)


def test_out_under_benchmarks_is_refused(capsys):
    assert pt.main(["--cpu", "--out",
                    str(ROOT / "benchmarks" / "results" / "x.jsonl")]) == 2
    assert "under benchmarks/" in capsys.readouterr().err


def test_steady_captures_count_after_the_first_served_request(tmp_path):
    (tmp_path / "metrics.jsonl").write_text("\n".join(json.dumps(r) for r in [
        {"ts": 1.0, "kind": "layout_ledger"},
        {"ts": 5.0, "kind": "serve_request"},
        {"ts": 6.0, "kind": "serve_request"}]) + "\n")
    (tmp_path / "events.jsonl").write_text("\n".join(json.dumps(r) for r in [
        {"ts": 2.0, "kind": "compile"}, {"ts": 3.0, "kind": "compile"},
        {"ts": 5.5, "kind": "compile"}, {"ts": 7.0, "kind": "span"}]) + "\n")
    assert pt._steady_captures(str(tmp_path)) == 1
    assert pt._steady_captures(str(tmp_path / "none")) == 0


#: what each cheap gate returns when it passes (fks_tpu's keys)
PASSING = {
    "obs_gate": {"ok": True, "schema_rc": 0, "compare_rc": 0},
    "trends_gate": {"ok": True, "clean_rc": 0, "regressed_rc": 1,
                    "alerts": 1},
    "trace_gate": {"ok": True, "rc": 0},
    "scale_gate": {"ok": True, "rc": 0},
}


@pytest.mark.parametrize("gate", sorted(PASSING))
def test_cheap_gates_pass_on_the_cpu(gate):
    assert getattr(pt, gate)(cpu=True) == PASSING[gate]


def test_gate_time_limit_reads_as_exit_124(monkeypatch):
    def slow(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))

    monkeypatch.setattr(subprocess, "run", slow)
    got = pt.scale_gate(cpu=True)
    assert got["ok"] is False and got["rc"] == 124
    assert "timed out after 600 s" in got["err"]
