"""The port's flight recorder (``obs.FlightRecorder``), ``obs.report.
read_jsonl`` and ``utils.logging.{json_ready, MetricsWriter}`` held
against fks_tpu's: a run directory the port writes passes fks_tpu's
schema checker and reads back through fks_tpu's loader, one fks_tpu
writes reads back in the port, both readers take the same lines the same
way (a torn final line skipped, a corrupt line elsewhere refused), and
the JSON hook turns torch tensors into what fks_tpu's turns the same
arrays into.
"""
import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu import obs as fk_obs
from fks_tpu.obs import report as fk_report
from fks_tpu.utils import logging as fk_logging
from fks_tpu_torch import obs as pt_obs
from fks_tpu_torch.obs import report as pt_report
from fks_tpu_torch.utils import logging as pt_logging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def schema_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import check_jsonl_schema
    finally:
        sys.path.pop(0)
    return check_jsonl_schema


def record_run(obs, run_dir, scalar):
    """The same recording through either package's recorder."""
    rec = obs.FlightRecorder(str(run_dir), meta={"command": "test",
                                                 "argv": ["x"]})
    with obs.recording(rec):
        rec.event("compile", key="/k/capture", seconds=0.5)
        rec.event("rollback", attempt="a1", reason="slo_burn")
        rec.event("drain", pending=1, completed=1, shed=0, persisted=True,
                  drain_s=0.01)
        rec.metric("promotion_event", attempt="a1", state="PROMOTED",
                   champion="c.json", score=scalar)
        rec.metric("stage", {"request_id": "r1"}, latency_ms=1.5)
        rec.annotate_meta(best=scalar)
    return rec


def test_port_run_dir_passes_fks_tpu_schema_and_loader(tmp_path):
    pt = record_run(pt_obs, tmp_path / "pt", torch.tensor(0.25))
    fk = record_run(fk_obs, tmp_path / "fk", jnp.float32(0.25))
    cjs = schema_tool()
    counts = cjs.check_run_dir(str(tmp_path / "pt"))
    assert counts == cjs.check_run_dir(str(tmp_path / "fk"))
    assert counts["events.jsonl"] == 3 and counts["metrics.jsonl"] == 2
    # fks_tpu reads the port's run, the port reads fks_tpu's
    meta, events, metrics = fk_report.load_run(str(tmp_path / "pt"))
    fk_meta, fk_events, fk_metrics = fk_report.load_run(str(tmp_path / "fk"))
    assert set(meta) == set(fk_meta)
    assert meta["status"] == fk_meta["status"] == "ok"
    assert meta["best"] == fk_meta["best"] == 0.25
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ts"}  # noqa
                          for r in rows]
    assert strip(events) == strip(fk_events)
    assert strip(metrics) == strip(fk_metrics)
    assert strip(pt_report.read_jsonl(
        str(tmp_path / "fk" / "events.jsonl"))) == strip(fk_events)
    assert [e["seq"] for e in events] == [0, 1, 2]
    hb = json.loads((tmp_path / "pt" / "heartbeat").read_text())
    assert hb["run_id"] == pt.run_id == meta["run_id"]


def test_recording_scope_marks_an_error_run(tmp_path):
    for obs, name in ((pt_obs, "pt"), (fk_obs, "fk")):
        rec = obs.FlightRecorder(str(tmp_path / name))
        with pytest.raises(RuntimeError):
            with obs.recording(rec):
                assert obs.get_recorder() is rec
                raise RuntimeError("boom")
        assert obs.get_recorder() is obs.NULL
        meta = json.loads((tmp_path / name / "meta.json").read_text())
        assert meta["status"] == "error" and "wall_seconds" in meta


@pytest.mark.parametrize("case", ["clean", "torn_tail", "corrupt_middle",
                                  "blank_lines"])
def test_read_jsonl_same_rule_as_fks_tpu(tmp_path, case):
    lines = {
        "clean": ['{"a": 1}', '{"a": 2}'],
        "torn_tail": ['{"a": 1}', '{"a": 2}', '{"a": 3, "b'],
        "corrupt_middle": ['{"a": 1}', '{"a": 2', '{"a": 3}'],
        "blank_lines": ['{"a": 1}', '', '   ', '{"a": 2}'],
    }[case]
    path = tmp_path / "x.jsonl"
    path.write_text("\n".join(lines))
    if case == "corrupt_middle":
        for read in (pt_report.read_jsonl, fk_report.read_jsonl):
            with pytest.raises(ValueError, match=":2: unparseable"):
                read(str(path))
        return
    rows = pt_report.read_jsonl(str(path))
    assert rows == fk_report.read_jsonl(str(path))
    assert [r["a"] for r in rows] == [1, 2]


def test_json_ready_matches_fks_tpu_on_the_same_values():
    pairs = [
        (torch.tensor(3, dtype=torch.int32), jnp.int32(3)),
        (torch.tensor(0.5, dtype=torch.float64), jnp.float64(0.5)),
        (torch.tensor(True), jnp.bool_(True)),
        (torch.tensor([[1, 2], [3, 4]]), jnp.array([[1, 2], [3, 4]])),
        (np.float32(1.25), np.float32(1.25)),
        (np.arange(3), np.arange(3)),
    ]
    for ours, theirs in pairs:
        assert pt_logging.json_ready(ours) == fk_logging.json_ready(theirs)
        assert type(pt_logging.json_ready(ours)) is \
            type(fk_logging.json_ready(theirs))
    for hook in (pt_logging.json_ready, fk_logging.json_ready):
        with pytest.raises(TypeError, match="not JSON serializable"):
            hook(object())


def test_metrics_writer_lines_match_fks_tpu():
    out = []
    for logging_mod, value in ((pt_logging, torch.tensor(0.5)),
                               (fk_logging, jnp.float32(0.5))):
        buf = io.StringIO()
        with logging_mod.MetricsWriter(buf) as w:
            w.write("generation", {"generation": 1}, best=value,
                    scores=np.array([1, 2]))
            w.write("bare")
        out.append([{k: v for k, v in json.loads(ln).items() if k != "ts"}
                    for ln in buf.getvalue().splitlines()])
    assert out[0] == out[1]
    assert out[0][0] == {"kind": "generation", "generation": 1,
                         "best": 0.5, "scores": [1, 2]}
