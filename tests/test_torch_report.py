"""Reading runs back: ``report``, ``export-metrics``, ``spans``, ``layout``
(view) and ``watch --once`` of the port against fks_tpu's, on the same
run directories, in both directions.

Three run directories: the golden fixture (tests/fixtures/golden_run,
with serve traces, layout rows and every metric kind the report
renders), one the port's ``evolve --fake-llm --profile --run-dir``
writes and one fks_tpu's writes (both on the micro workload, two
generations). Each command runs through both CLIs on each directory:
the printed text and the exit code must be identical — fks_tpu reads the
port's directory and the port reads fks_tpu's. ``spans`` covers every
mode: the list, ``--trace`` (a whole id, an unambiguous prefix, an
ambiguous one), ``--slowest``, ``--check-complete`` and
``--critical-path``. Heartbeat ages read one fixed clock in both
exporters.
"""
import contextlib
import io
import json
import pathlib
import time
import types

import pytest

import fks_tpu.cli as fk_cli
import fks_tpu.obs.exporter as fk_exporter
import fks_tpu.obs.report as fk_report
import fks_tpu_torch.cli as pt_cli
import fks_tpu_torch.obs.exporter as pt_exporter
import fks_tpu_torch.obs.report as pt_report
from fks_tpu_torch.testing import port_workload

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = str(ROOT / "tests" / "fixtures" / "golden_run")


def run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def run_dirs(micro_workload, tmp_path_factory):
    """{"golden", "pt", "fk"}: the golden run dir and the evolve run dirs
    each package writes on the micro workload."""
    base = tmp_path_factory.mktemp("runs")
    dirs = {"golden": GOLDEN}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk_cli, "_parse_workload",
                   lambda args: ("micro", micro_workload))
        mp.setattr(pt_cli, "_parse_workload",
                   lambda args: port_workload(micro_workload))
        for tag, cli in (("fk", fk_cli), ("pt", pt_cli)):
            d = base / tag
            rc, out, _ = run(cli, ["evolve", "--cpu", "--fake-llm",
                                   "--generations", "2", "--profile",
                                   "--run-dir", str(d)])
            assert rc == 0 and "device-time attribution" in out
            dirs[tag] = str(d)
    return dirs


@pytest.fixture
def fixed_clock(monkeypatch):
    now = time.time()
    for mod in (fk_exporter, pt_exporter):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: now, sleep=time.sleep))
    return now


def trace_ids(run_dir):
    rows = [json.loads(ln) for ln in
            (pathlib.Path(run_dir) / "events.jsonl").read_text()
            .splitlines() if ln.strip()]
    return sorted({r["trace_id"] for r in rows
                   if r.get("kind") == "trace_span"})


COMMANDS = {
    "report": lambda d: ["report", d],
    "export-metrics": lambda d: ["export-metrics", d],
    "watch-once": lambda d: ["watch", d, "--once"],
    "layout-view": lambda d: ["layout", "--run-dir", d],
    "spans-list": lambda d: ["spans", d],
    "spans-trace": lambda d: ["spans", d, "--trace", trace_ids(d)[0]],
    "spans-trace-prefix": lambda d: ["spans", d, "--trace",
                                     trace_ids(d)[-1][:-3]],
    "spans-trace-ambiguous": lambda d: ["spans", d, "--trace",
                                        trace_ids(d)[0][:2]],
    "spans-trace-missing": lambda d: ["spans", d, "--trace", "nope"],
    "spans-slowest": lambda d: ["spans", d, "--slowest", "3"],
    "spans-check-complete": lambda d: ["spans", d, "--check-complete"],
    "spans-critical-path": lambda d: ["spans", d, "--critical-path"],
    "spans-critical-path-strict": lambda d: [
        "spans", d, "--critical-path", "--min-fraction", "1.01"],
}


@pytest.mark.parametrize("command", sorted(COMMANDS))
@pytest.mark.parametrize("which", ["golden", "pt", "fk"])
def test_same_text_and_exit_code(which, command, run_dirs, fixed_clock):
    argv = COMMANDS[command](run_dirs[which])
    got = run(pt_cli, argv)
    want = run(fk_cli, argv)
    assert got == want


@pytest.mark.parametrize("which", ["golden", "pt", "fk"])
def test_render_report_equal(which, run_dirs, fixed_clock):
    text = pt_report.render_report(run_dirs[which])
    assert text == fk_report.render_report(run_dirs[which])
    if which != "golden":
        assert "device-time attribution (obs.profiler):" in text
        assert "generations: 2" in text


def test_expected_exit_codes(run_dirs, fixed_clock):
    """The golden run holds serve traces and a complete waterfall; an
    evolve run holds generation traces only."""
    d, g = run_dirs["pt"], run_dirs["golden"]
    assert run(pt_cli, ["spans", g, "--check-complete"])[0] == 0
    assert run(pt_cli, ["spans", d, "--check-complete"])[0] == 1
    assert run(pt_cli, ["spans", d, "--slowest", "3"])[0] == 1
    assert run(pt_cli, ["spans", d, "--critical-path"])[0] == 0
    assert run(pt_cli, ["spans", d, "--critical-path", "--min-fraction",
                        "1.01"])[0] == 1
    assert run(pt_cli, ["spans", d, "--trace", "nope"])[0] == 2
    assert run(pt_cli, ["watch", d, "--once"])[0] == 0


def test_missing_run_dir_exits_2(tmp_path):
    for argv in (["report", str(tmp_path)], ["spans", str(tmp_path)],
                 ["layout", "--run-dir", str(tmp_path)],
                 ["export-metrics", str(tmp_path)]):
        got = run(pt_cli, argv)
        assert got == run(fk_cli, argv) and got[0] == 2
    assert run(pt_cli, ["layout"]) == run(fk_cli, ["layout"])
    assert run(pt_cli, ["layout"])[0] == 2


def test_sparkline_and_torn_tail_equal(tmp_path):
    for vals in ([], [0.5], [0.1, 0.2, 0.3], [1.0, 1.0, 1.0],
                 [0.3, -1.0, 2.5, 2.5, 0.0]):
        assert pt_report.sparkline(vals) == fk_report.sparkline(vals)
    d = tmp_path / "run"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps(
        {"run_id": "t", "status": "ok", "command": "evolve"}))
    (d / "metrics.jsonl").write_text(
        json.dumps({"ts": 1.0, "kind": "generation", "generation": 1,
                    "best_score": 0.25}) + "\n{\"ts\": 2.0, \"kind\"")
    assert pt_report.render_report(str(d)) == fk_report.render_report(str(d))
    (d / "metrics.jsonl").write_text("{bad\n" + json.dumps({"ts": 1.0}))
    with pytest.raises(ValueError, match=":1: unparseable"):
        pt_report.render_report(str(d))


def test_records_without_cost_fields_render_like_fks_tpu(tmp_path,
                                                         fixed_clock):
    """The port's bench, profiler and layout records carry no
    ``cost_flops``/``cost_bytes_accessed``: each section renders such a
    record as fks_tpu renders it."""
    d = tmp_path / "run"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps(
        {"run_id": "c", "status": "ok", "command": "bench",
         "wall_seconds": 3.5}))
    rows = [
        {"kind": "bench_stage", "stage": "throughput",
         "evals_per_sec": 6142.61, "compile_seconds": 0.43,
         "first_call_seconds": 1.2, "steady_state_seconds": 0.042},
        {"kind": "device_profile", "scope": "evolve", "stage": "device-eval",
         "depth": 0, "wall_seconds": 2.0, "compile_seconds": 0.5,
         "compute_seconds": 1.5, "compile_count": 3},
        {"kind": "device_profile", "stage": "__total__", "scope": "evolve",
         "wall_seconds": 2.0, "measured_wall_seconds": 2.0002,
         "attributed_fraction": 0.9999, "idle_fraction": 0.0001,
         "compile_seconds": 0.5},
        {"kind": "layout_ledger", "component": "eval",
         "layout_key": "shard[candidates]|vmap[candidates]|seg=0",
         "mesh_layout": "pop=4", "workload_key": "w", "real_count": 6,
         "padded_count": 8, "pad_waste_fraction": 0.25,
         "real_lane_steps": 6, "launched_lane_steps": 8},
    ]
    (d / "metrics.jsonl").write_text("".join(
        json.dumps({"ts": 1.0 + i, **r}) + "\n" for i, r in enumerate(rows)))
    for argv in (["report", str(d)], ["export-metrics", str(d)],
                 ["layout", "--run-dir", str(d)]):
        got = run(pt_cli, argv)
        assert got == run(fk_cli, argv) and got[0] == 0
