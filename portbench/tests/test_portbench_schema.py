"""``BENCHMARK.json`` keeps its required form, and the result line has
the keys, in the order, that a reader of the benchmark takes."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


def test_names_units_and_texts(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in (bench["configs"], bench["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["traffic"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        e2e = [m["name"] for m in harness.metrics_of(bench, w["name"],
                                                     False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_of(bench, w["name"], True)
        assert layer
        for m in layer:  # every per-layer metric moves a metric the cell has
            assert m["moves"] in e2e
    assert used == configs
    assert next(m for m in bench["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


def test_result_line_schema():
    rec = {"correct": True, "attempted": 5, "failed": 0,
           "timeline": {"device_ops": [["k", 1.0]],
                        "idle_gaps": [["host", 0.5]]}}
    line = harness.result_line(
        rec, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "H100", "count": 1,
         "memory_peak_bytes": 1}, [["gap", 0.0, 1e-5]])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["checks"] == {"gap": {"value": 0.0, "limit": 1e-5}}
    assert json.loads(json.dumps(line)) == line
    del rec["timeline"]
    assert "breakdown" not in harness.result_line(rec, {}, {}, [])
