"""Cross-run history: the port's ``RunHistory``, ``resolve_auto_baseline``,
``cli trends`` and ``cli compare --baseline auto`` against fks_tpu's, on
the same history roots.

The cases are fks_tpu's tests/test_history.py: a 10-run history with one
injected 30% throughput drop (exactly one alert, at the change point),
+/-2% noise (none), a lower-is-better metric (a rise alerts), the index
file, best-healthy baselines and stale carry-forwards that never chain,
the layout priors, and the CLI exit codes (0 rendered, 1 with
``--fail-on-alert`` on an alert, 2 on a missing or empty root). Every
root is a temporary directory: nothing writes under benchmarks/.
"""
import contextlib
import io
import json
import os
import pathlib
import time

import pytest

import fks_tpu.cli as fk_cli
import fks_tpu.obs.history as fk_history
import fks_tpu_torch.cli as pt_cli
import fks_tpu_torch.obs.history as pt_history

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "fixtures" / "golden_run"

CLEAN = [100.0, 101.5, 99.2, 100.8, 98.9, 101.1, 99.7, 100.4, 99.9, 100.6]
REGRESSED = CLEAN[:7] + [70.0, 69.5, 70.3]


def run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def write_history(root, values, key="value", start=None):
    """Bench headline files with 1h-spaced mtimes (newest = last)."""
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    start = time.time() - 3600 * len(values) if start is None else start
    paths = []
    for i, v in enumerate(values):
        p = root / f"BENCH_r{i:02d}.json"
        rec = ({"metric": "evals/s", "value": v, "unit": "evals/s",
                "vs_baseline": round(v / 40.0, 3)} if key == "value" else
               {"value": 100.0, "unit": "evals/s", key: v})
        p.write_text(json.dumps(rec) + "\n")
        ts = start + i * 3600
        os.utime(p, (ts, ts))
        paths.append(str(p))
    return paths


def _mixed(root):
    """Bench files, a flight-recorder run dir (the golden one), a stale
    carry-forward, an unmeasured headline and a corrupt run dir."""
    write_history(root, [95.0, 101.5, 99.0])
    import shutil
    shutil.copytree(GOLDEN, root / "golden_run")
    (root / "BENCH_r50.json").write_text(json.dumps(
        {"value": 101.5, "unit": "evals/s", "error": "probe failed",
         "stale_from_run": {"run": "BENCH_r01.json"}}) + "\n")
    (root / "BENCH_r99.json").write_text(json.dumps(
        {"value": 0.0, "unit": "evals/s", "error": "probe failed"}) + "\n")
    bad = root / "corrupt_run"
    bad.mkdir()
    (bad / "meta.json").write_text("{not json")


ROOTS = {
    "regressed": lambda r: write_history(r, REGRESSED),
    "clean": lambda r: write_history(r, CLEAN),
    "lower_is_better": lambda r: write_history(
        r, [10.0, 10.2, 9.9, 10.1, 10.0, 10.1, 9.8, 30.0, 29.5, 30.2],
        key="compile_seconds"),
    "mixed": _mixed,
}


def both_scans(tmp_path, case):
    root = tmp_path / case
    root.mkdir()
    ROOTS[case](root)
    fk = fk_history.RunHistory(str(root))
    pt = pt_history.RunHistory(str(root))
    return root, fk, pt


@pytest.mark.parametrize("case", sorted(ROOTS))
def test_scan_entries_equal(case, tmp_path):
    _, fk, pt = both_scans(tmp_path, case)
    assert pt.scan() == fk.scan()
    assert pt.entries


@pytest.mark.parametrize("case", sorted(ROOTS))
@pytest.mark.parametrize("metrics,window,z", [
    (None, 5, 3.5), (["evals_per_sec"], 5, 3.5),
    (["compile_seconds"], 3, 2.0), (["evals_per_sec", "best_score"], 8, 5.0),
])
def test_timelines_and_trends_equal(case, metrics, window, z, tmp_path):
    _, fk, pt = both_scans(tmp_path, case)
    assert pt.timelines() == fk.timelines()
    assert pt.trends(metrics, window=window, z=z) == \
        fk.trends(metrics, window=window, z=z)


def test_trend_alerts_like_fks_tpu(tmp_path):
    _, _, pt = both_scans(tmp_path, "regressed")
    (rep,) = pt.trends(["evals_per_sec"])
    assert rep["runs"] == 10 and len(rep["alerts"]) == 1
    assert rep["alerts"][0]["run"] == "BENCH_r07.json"
    assert rep["alerts"][0]["direction"] == "drop"
    _, _, pt = both_scans(tmp_path, "clean")
    assert pt.trends(["evals_per_sec"])[0]["alerts"] == []
    _, _, pt = both_scans(tmp_path, "lower_is_better")
    (rep,) = pt.trends(["compile_seconds"])
    assert [a["direction"] for a in rep["alerts"]] == ["rise"]


@pytest.mark.parametrize("case", sorted(ROOTS))
@pytest.mark.parametrize("metric", ["evals_per_sec", "compile_seconds",
                                    "best_score"])
def test_baselines_equal(case, metric, tmp_path):
    root, fk, pt = both_scans(tmp_path, case)
    assert pt.best_healthy(metric) == fk.best_healthy(metric)
    assert pt.last_healthy_headline() == fk.last_healthy_headline()
    assert pt_history.resolve_auto_baseline(str(root), metric) == \
        fk_history.resolve_auto_baseline(str(root), metric)


def test_stale_headline_never_chains(tmp_path):
    root, _, pt = both_scans(tmp_path, "mixed")
    pt.scan()
    by_run = {e["run"]: e for e in pt.entries}
    assert by_run["BENCH_r50.json"]["stale"]
    assert not by_run["BENCH_r50.json"]["healthy"]
    # the newest measured headline, past the newer stale and 0.0 ones
    assert pt.last_healthy_headline()["path"] == str(root / "BENCH_r02.json")
    assert pt_history.resolve_auto_baseline(str(root)) == \
        str(root / "BENCH_r01.json")
    assert pt_history.resolve_auto_baseline(str(tmp_path / "nothing")) is None


def test_write_index_equal(tmp_path):
    texts = []
    for mod in (fk_history, pt_history):
        root = tmp_path / mod.__name__
        write_history(root, CLEAN[:4], start=1.0e9)
        path = mod.RunHistory(str(root)).write_index()
        assert path == str(root / "history.jsonl")
        texts.append(pathlib.Path(path).read_text().replace(
            str(root), "ROOT"))
        # a rescan must not index the index file itself
        assert len(mod.RunHistory(str(root)).scan()) == 4
    assert texts[0] == texts[1]


def test_layout_priors_read_both_ways(tmp_path):
    """A prior one package writes reads back in the other; the store is
    written only under the root."""
    fk = fk_history.RunHistory(str(tmp_path))
    pt = pt_history.RunHistory(str(tmp_path))
    assert pt.layout_prior("w", "8") is None
    pt.record_layout_prior("w", "8", "k1", {"steady_seconds": 0.5})
    assert fk.layout_prior("w", "8") == pt.layout_prior("w", "8")
    fk.record_layout_prior("w", "8", "k2", {"steady_seconds": 0.4})
    pt.record_layout_prior("w", "4", "k3")
    assert pt.layout_prior("w", "8")["layout_key"] == "k2"
    assert fk.layout_prior("w", "4") == pt.layout_prior("w", "4")
    assert sorted(os.listdir(tmp_path)) == ["layouts.json"]
    (tmp_path / "layouts.json").write_text("{broken")
    assert pt.layout_prior("w", "8") is None


def test_cli_compare_auto_baseline_equal(tmp_path):
    write_history(tmp_path, [95.0, 101.5, 99.0])
    cand = tmp_path / "candidate.json"
    cand.write_text(json.dumps({"value": 60.0, "unit": "evals/s"}) + "\n")
    empty = tmp_path / "empty"
    empty.mkdir()
    for root, want_rc in ((tmp_path, 1), (empty, 2),
                          (tmp_path / "missing", 2)):
        argv = ["compare", "auto", str(cand), "--history-root", str(root)]
        got = run(pt_cli, argv)
        assert got == run(fk_cli, argv) and got[0] == want_rc
    assert "BENCH_r01.json" in run(pt_cli, [
        "compare", "auto", str(cand), "--history-root", str(tmp_path)])[2]


def test_cli_compare_auto_reads_the_env_root(tmp_path, monkeypatch):
    write_history(tmp_path, [95.0, 101.5])
    cand = tmp_path / "candidate.json"
    cand.write_text(json.dumps({"value": 100.0, "unit": "evals/s"}) + "\n")
    monkeypatch.setenv("FKS_BENCH_RESULTS_DIR", str(tmp_path))
    assert pt_cli._default_history_root() == str(tmp_path)
    got = run(pt_cli, ["compare", "auto", str(cand)])
    assert got == run(fk_cli, ["compare", "auto", str(cand)])
    assert got[0] == 0
    monkeypatch.delenv("FKS_BENCH_RESULTS_DIR")
    assert pt_cli._default_history_root() == str(
        ROOT / "benchmarks" / "results")


@pytest.mark.parametrize("argv,want_rc", [
    (["clean", "--fail-on-alert"], 0),
    (["regressed", "--fail-on-alert"], 1),
    (["regressed"], 0),
    (["regressed", "--metric", "evals_per_sec,compile_seconds",
      "--window", "3", "--z", "2.5"], 0),
    (["missing"], 2),
    (["empty"], 2),
], ids=["clean", "fail_on_alert", "alerts_render", "metric_flags",
        "missing", "empty"])
def test_cli_trends_equal(argv, want_rc, tmp_path):
    write_history(tmp_path / "clean", CLEAN)
    write_history(tmp_path / "regressed", REGRESSED)
    (tmp_path / "empty").mkdir()
    argv = ["trends", str(tmp_path / argv[0])] + argv[1:]
    got = run(pt_cli, argv)
    assert got == run(fk_cli, argv)
    assert got[0] == want_rc


def test_cli_trends_write_index_and_run_dir(tmp_path):
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_jsonl_schema as cjs
    finally:
        sys.path.pop(0)
    rows = {}
    for tag, cli in (("fk", fk_cli), ("pt", pt_cli)):
        root = tmp_path / tag / "hist"
        write_history(root, REGRESSED, start=1.0e9)
        run_dir = tmp_path / tag / "run"
        rc, out, err = run(cli, ["trends", str(root), "--fail-on-alert",
                                 "--write-index", "--run-dir",
                                 str(run_dir)])
        assert rc == 1 and out.count("ALERT") == 1
        assert (root / "history.jsonl").exists()
        assert cjs.main(["--run-dir", str(run_dir)]) == 0
        rows[tag] = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                     for ln in (run_dir / "metrics.jsonl").read_text()
                     .splitlines()]
    assert rows["pt"] == rows["fk"]
    assert [r["kind"] for r in rows["pt"]] == ["trend_report"]


@pytest.mark.parametrize("slo,lat,elapsed", [
    ((50.0, 100.0, 0.01), [10.0] * 95 + [60.0] * 5, 2.0),
    ((50.0, 0.0, 0.01), [10.0] * 200, 1.0),
    ((0.0, 0.0, 0.01), [10.0, 60.0], 1.0),
    ((5.0, 3.0, 0.05), [1.0, 9.0, 2.0], 0.5),
])
def test_slo_burn_equal(slo, lat, elapsed):
    want = fk_history.slo_burn(fk_history.SLOConfig(*slo), lat, elapsed)
    assert pt_history.slo_burn(pt_history.SLOConfig(*slo), lat, elapsed) \
        == want
    assert pt_history.SLOConfig(*slo).enabled == \
        fk_history.SLOConfig(*slo).enabled
