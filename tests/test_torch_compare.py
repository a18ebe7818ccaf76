"""Cross-run regression gating, OpenMetrics export and liveness: the port
(fks_tpu_torch.obs.compare / exporter, ``cli compare``, ``export-metrics``,
``watch``) against fks_tpu's, on the same inputs.

Each case of fks_tpu's tests/test_compare.py builds its inputs once (the
golden run-dir fixture, copies of it with an injected regression, bench
JSONL files, live run dirs with a chosen heartbeat age) and runs them
through both packages: the verdict rows, the rendered text and the exit
codes must be equal. A bench JSONL file from benchmarks/results is read
(never written). Where the output depends on the clock (heartbeat ages),
both exporters read one fixed clock.
"""
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import shutil
import time
import types

import pytest

import fks_tpu.cli as fk_cli
import fks_tpu.obs.compare as fk_compare
import fks_tpu.obs.exporter as fk_exporter
import fks_tpu.obs.report as fk_report
import fks_tpu_torch.cli as pt_cli
import fks_tpu_torch.obs.compare as pt_compare
import fks_tpu_torch.obs.exporter as pt_exporter
import fks_tpu_torch.obs.report as pt_report

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = str(ROOT / "tests" / "fixtures" / "golden_run")


def run(cli, argv):
    """(exit code, stdout, stderr) of ``cli.main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both exporters (and so both reports) read one clock."""
    now = time.time()
    for mod in (fk_exporter, pt_exporter):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: now, sleep=time.sleep))
    return now


def regressed_copy(tmp_path, *, perf_factor=1.0, drift=None):
    """The golden run dir with bench throughput scaled and/or parity
    drift injected into the candidate's metrics stream."""
    dst = tmp_path / "candidate"
    shutil.copytree(GOLDEN, dst)
    rows = [json.loads(ln) for ln in
            (dst / "metrics.jsonl").read_text().splitlines() if ln.strip()]
    for r in rows:
        if r["kind"] == "bench_stage" and "evals_per_sec" in r:
            r["evals_per_sec"] *= perf_factor
        if drift is not None and r["kind"] == "parity":
            r["max_drift"] = drift
    (dst / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    return str(dst)


def live_run(tmp_path, heartbeat_age, gap=10.0, now=None):
    """An unfinished run whose metrics tick every ``gap`` seconds and
    whose heartbeat is ``heartbeat_age`` seconds old on both its clocks."""
    d = tmp_path / f"live-{heartbeat_age}"
    d.mkdir(parents=True)
    now = time.time() if now is None else now
    (d / "meta.json").write_text(json.dumps(
        {"run_id": "live", "status": "running", "command": "evolve"}))
    rows = [{"ts": now - 100 + i * gap, "kind": "generation",
             "generation": i, "best_score": 0.1} for i in range(5)]
    (d / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    (d / "heartbeat").write_text(json.dumps(
        {"ts": now - heartbeat_age, "run_id": "live"}))
    os.utime(d / "heartbeat", (now - heartbeat_age, now - heartbeat_age))
    return str(d)


# ------------------------------------------------------------- comparator

def _perf(factor):
    return lambda tmp: (GOLDEN, regressed_copy(tmp, perf_factor=factor))


def _drift(tmp):
    return GOLDEN, regressed_copy(tmp, drift=0.01)


def _one_sided(tmp):
    base, cand = tmp / "base.jsonl", tmp / "cand.jsonl"
    base.write_text(json.dumps({"value": 100.0, "unit": "evals/s",
                                "best_score": 0.5}) + "\n")
    cand.write_text(json.dumps({"value": 100.0, "unit": "evals/s"}) + "\n")
    return str(base), str(cand)


def _watchdog(tmp):
    cand = tmp / "candidate"
    shutil.copytree(GOLDEN, cand)
    with open(cand / "events.jsonl", "a") as f:
        f.write(json.dumps({"ts": 1785585691.0, "kind": "watchdog",
                            "seq": 6, "flags": 2, "kinds": ["inf"]}) + "\n")
    return GOLDEN, str(cand)


def _stale_pair(tmp):
    stale = tmp / "stale.json"
    stale.write_text(json.dumps(
        {"value": 101.5, "unit": "evals/s",
         "stale_from_run": {"run": "BENCH_r01.json"}}) + "\n")
    fresh = tmp / "fresh.json"
    fresh.write_text(json.dumps({"value": 99.0, "unit": "evals/s"}) + "\n")
    return str(stale), str(fresh)


def _bench_file(tmp):
    """A bench evidence file the repo ships, read only."""
    path = str(ROOT / "benchmarks" / "results" / "round4_tpu.jsonl")
    return path, path


PAIRS = {
    "identical": lambda tmp: (GOLDEN, GOLDEN),
    "perf_regression": _perf(0.8),
    "parity_drift": _drift,
    "noise_rides_out": _perf(0.95),
    "improvement": _perf(1.5),
    "one_sided_metric": _one_sided,
    "watchdog_count": _watchdog,
    "stale_baseline": _stale_pair,
    "stale_candidate": lambda tmp: _stale_pair(tmp)[::-1],
    "bench_results_file": _bench_file,
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_compare_runs_rows_and_table_equal(case, tmp_path):
    base, cand = PAIRS[case](tmp_path)
    want = fk_compare.compare_runs(base, cand)
    got = pt_compare.compare_runs(base, cand)
    assert got == want and want
    assert pt_compare.has_regression(got) == fk_compare.has_regression(want)
    assert pt_compare.format_comparison(got, base, cand) == \
        fk_compare.format_comparison(want, base, cand)
    # and each package's rows format identically in the other's table
    assert pt_compare.format_comparison(want, base, cand) == \
        fk_compare.format_comparison(got, base, cand)


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_cli_compare_exit_codes_equal(case, tmp_path):
    base, cand = PAIRS[case](tmp_path)
    assert run(pt_cli, ["compare", base, cand]) == \
        run(fk_cli, ["compare", base, cand])


def test_expected_verdicts(tmp_path):
    """fks_tpu's acceptance bar, through the port."""
    by = lambda rows: {r["metric"]: r["status"] for r in rows}  # noqa
    assert not pt_compare.has_regression(pt_compare.compare_runs(GOLDEN,
                                                                  GOLDEN))
    assert by(pt_compare.compare_runs(*_perf(0.8)(tmp_path / "a")))[
        "evals_per_sec"] == "REGRESSION"
    assert by(pt_compare.compare_runs(*_perf(0.95)(tmp_path / "b")))[
        "evals_per_sec"] == "OK"
    assert by(pt_compare.compare_runs(*_perf(1.5)(tmp_path / "c")))[
        "evals_per_sec"] == "IMPROVED"
    assert by(pt_compare.compare_runs(*_drift(tmp_path / "d")))[
        "parity_max_drift"] == "REGRESSION"


@pytest.mark.parametrize("rows", [
    [{"value": 0.0, "unit": "evals/s", "error": "tpu timeout",
      "banked_from": "round6_tpu.jsonl"}],
    [{"ok": True, "stage": "throughput",
      "result": {"evals_per_sec": 1200.0, "compile_seconds": 4.0}},
     {"value": 1500.0, "unit": "evals/s", "compile_seconds": 3.5}],
    [{"value": 101.5, "unit": "evals/s", "peak_device_bytes": 4096,
      "stale_from_run": {"run": "BENCH_r01.json"}}],
    [{"ok": True, "stage": "serve",
      "result": {"serve_p99_ms": 7.5, "serve_qps": 80.0}},
     {"ok": True, "stage": "serve",
      "result": {"serve_p99_ms": 6.5, "serve_qps": 70.0,
                 "exe_temp_bytes": 2048}}],
], ids=["fallback", "headline_and_session_log", "stale", "serve_rows"])
@pytest.mark.parametrize("allow_stale", [False, True])
def test_extract_metrics_equal(rows, allow_stale, tmp_path):
    p = tmp_path / "bench.jsonl"
    p.write_text("prose line survives\n"
                 + "".join(json.dumps(r) + "\n" for r in rows))
    assert pt_compare.extract_metrics(str(p), allow_stale=allow_stale) == \
        fk_compare.extract_metrics(str(p), allow_stale=allow_stale)


@pytest.mark.parametrize("spec", [
    "evals_per_sec=rel:0.5,best_score=abs:0.2", "parity_max_drift=abs:0.1",
    "new_metric=rel:0.3", "", "evals_per_sec=0.5"])
def test_threshold_overrides_equal(spec):
    def parse(mod):
        try:
            return {k: dataclasses.asdict(v) for k, v in
                    mod.parse_threshold_overrides(spec).items()}
        except ValueError as e:
            return str(e)

    assert parse(pt_compare) == parse(fk_compare)
    assert {k: dataclasses.asdict(v)
            for k, v in pt_compare.DEFAULT_THRESHOLDS.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in fk_compare.DEFAULT_THRESHOLDS.items()}


def test_cli_compare_threshold_override_and_missing(tmp_path):
    cand = regressed_copy(tmp_path, perf_factor=0.8)
    argv = ["compare", GOLDEN, cand, "--threshold",
            "evals_per_sec=rel:0.5,parity_max_drift=abs:0.1"]
    assert run(pt_cli, argv) == run(fk_cli, argv)
    assert run(pt_cli, argv)[0] == 0
    for argv in (["compare", GOLDEN, str(tmp_path / "nope")],
                 ["compare", GOLDEN, cand, "--threshold", "x=1"]):
        want = run(fk_cli, argv)
        assert run(pt_cli, argv) == want and want[0] == 2


# ------------------------------------------------------ openmetrics export

def test_openmetrics_golden_equal(fixed_clock):
    text = pt_exporter.to_openmetrics(GOLDEN)
    assert text == fk_exporter.to_openmetrics(GOLDEN)
    assert text.endswith("# EOF\n")
    assert 'fks_events_total{run_id="20260801-120000-abc123",' \
           'kind="watchdog"} 1' in text


def test_openmetrics_passes_the_schema_tool(fixed_clock):
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_jsonl_schema as cjs
    finally:
        sys.path.pop(0)
    assert cjs.check_openmetrics(pt_exporter.to_openmetrics(GOLDEN),
                                 "<golden>") > 0


def test_cli_export_metrics_equal(tmp_path, fixed_clock):
    outs = {}
    for tag, cli in (("fk", fk_cli), ("pt", pt_cli)):
        path = tmp_path / f"{tag}.prom"
        rc, _, err = run(cli, ["export-metrics", GOLDEN, "--out",
                               str(path)])
        assert rc == 0 and err == f"wrote {path}\n"
        outs[tag] = (path.read_text(), run(cli, ["export-metrics", GOLDEN]))
    assert outs["pt"] == outs["fk"]
    assert outs["pt"][1][0] == 0
    missing = ["export-metrics", str(tmp_path / "nope")]
    assert run(pt_cli, missing) == run(fk_cli, missing)


# -------------------------------------------------------------- liveness

@pytest.mark.parametrize("age", [5.0, 45.0, 900.0, "no_heartbeat",
                                 "skewed"])
def test_run_health_and_report_head_equal(age, tmp_path, fixed_clock):
    if age == "no_heartbeat":
        d = live_run(tmp_path, 1.0, now=fixed_clock)
        os.remove(os.path.join(d, "heartbeat"))
    elif age == "skewed":  # old embedded ts, fresh mtime: the fresher wins
        d = live_run(tmp_path, 60.0, now=fixed_clock)
        os.utime(os.path.join(d, "heartbeat"), (fixed_clock, fixed_clock))
    else:
        d = live_run(tmp_path, age, now=fixed_clock)
    want = fk_exporter.run_health(d)
    assert pt_exporter.run_health(d) == want
    assert pt_exporter.health_line(d) == fk_exporter.health_line(d)
    assert pt_report.render_report(d) == fk_report.render_report(d)
    assert want["state"] == {5.0: "HEALTHY", 45.0: "STALE", 900.0: "DEAD",
                             "no_heartbeat": "DEAD",
                             "skewed": "HEALTHY"}[age]


@pytest.mark.parametrize("which", ["golden", "dead", "stale", "slo"])
def test_watch_once_equal(which, tmp_path, fixed_clock):
    if which == "golden":
        d = GOLDEN
    elif which == "slo":
        d = live_run(tmp_path, 1.0, now=fixed_clock)
        with open(os.path.join(d, "metrics.jsonl"), "a") as f:
            for r in ({"kind": "slo_burn", "slo": "p99_ms", "target": 50.0,
                       "observed": 80.0, "burn_rate": 5.0},
                      {"kind": "slo_burn", "slo": "qps", "target": 10.0,
                       "observed": 12.0, "burn_rate": 0.0}):
                f.write(json.dumps({"ts": fixed_clock - 1.0, **r}) + "\n")
    else:
        d = live_run(tmp_path, 900.0 if which == "dead" else 45.0,
                     now=fixed_clock)
    got = run(pt_cli, ["watch", d, "--once"])
    assert got == run(fk_cli, ["watch", d, "--once"])
    assert got[0] == {"golden": 0, "dead": 1, "stale": 0, "slo": 0}[which]
    bufs = io.StringIO(), io.StringIO()
    rcs = (fk_exporter.watch(d, once=True, out=bufs[0]),
           pt_exporter.watch(d, once=True, out=bufs[1]))
    assert rcs[0] == rcs[1] and bufs[0].getvalue() == bufs[1].getvalue()


def test_watch_polls_until_the_run_finishes(tmp_path, fixed_clock):
    """A live run polled with a stub clock: the second poll sees the run
    finished and returns 0, printing the new records once."""
    outs = []
    for exporter in (fk_exporter, pt_exporter):
        d = pathlib.Path(live_run(tmp_path / exporter.__name__, 1.0,
                                  now=fixed_clock))
        polls = []

        def tick(_s, d=d, polls=polls):
            polls.append(_s)
            meta = json.loads((d / "meta.json").read_text())
            (d / "meta.json").write_text(json.dumps({**meta,
                                                     "status": "ok"}))

        buf = io.StringIO()
        assert exporter.watch(str(d), interval=0.5, out=buf,
                              clock=tick) == 0
        assert polls == [0.5]
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("gen 4:") == 1


def test_cli_watch_missing_dir_exits_2(tmp_path):
    argv = ["watch", str(tmp_path / "nope"), "--once"]
    assert run(pt_cli, argv) == run(fk_cli, argv)
    assert run(pt_cli, argv)[0] == 2
