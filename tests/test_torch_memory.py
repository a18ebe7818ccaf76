"""The port's memory observability (fks_tpu_torch.obs.memory) and ``cli
mem`` against fks_tpu's, on the CPU.

- ``rollup`` equals fks_tpu's on the same footprint records, and
  ``normalize_memory_stats`` on the same stats dicts (the port's copy
  also reads the caching allocator's spellings);
- the watermark sampler: disabled a no-op, enabled records with fks_tpu's
  keys, the interval thread starts and stops;
- the leak sentinel flags real growth of CPU tensors and clears when
  they are freed; its contracts; the closed vocabularies equal fks_tpu's
  and tools/check_jsonl_schema.py's;
- both drills are ok at the reduced scale of tests/test_memory.py:268-300
  and report fks_tpu's keys;
- ``mem --run-dir tests/fixtures/golden_run`` prints fks_tpu's text,
  ``mem`` with no mode exits 2, ``--sample`` and ``--drill`` run.

Not here: the compare-gate cases of tests/test_memory.py:302-340 need
``obs/compare.py``, which the port does not have yet.
"""
import contextlib
import io
import json
import os
import pathlib
import sys

import jax.numpy as jnp
import pytest
import torch

import fks_tpu.cli as fk_cli
import fks_tpu_torch.cli as pt_cli
from fks_tpu.obs import memory as jmem
from fks_tpu.obs.telemetry import normalize_memory_stats as jax_normalize
from fks_tpu_torch.obs.memory import (
    FOOTPRINT_KEYS, LEAK_LOOPS, LEDGER, MEMORY_COMPONENTS, NULL_SAMPLER,
    LeakSentinel, WatermarkSampler, leak_fence, live_array_stats,
    record_footprint, rollup, run_drill,
)
from fks_tpu_torch.obs.report import load_run
from fks_tpu_torch.obs.telemetry import normalize_memory_stats

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = str(ROOT / "tests" / "fixtures" / "golden_run")


class RecStub:
    enabled = True

    def __init__(self):
        self.metrics = []

    def metric(self, kind, *a, **fields):
        rec = dict(a[0]) if a and isinstance(a[0], dict) else {}
        rec.update(fields)
        self.metrics.append({"kind": kind, **rec})

    def event(self, *a, **kw):
        pass


def run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


# --------------------------------------------------------------- rollup

ROWS = [
    {"component": "serve_aot", "mesh_layout": "", "temp_bytes": 100,
     "argument_bytes": 10, "output_bytes": 1,
     "generated_code_bytes": 5, "total_bytes": 116},
    {"component": "serve_aot", "mesh_layout": "", "temp_bytes": 300,
     "argument_bytes": 10, "output_bytes": 1,
     "generated_code_bytes": 5, "total_bytes": 316},
    {"component": "evolve", "mesh_layout": "pop=4", "temp_bytes": 9000,
     "argument_bytes": 0, "output_bytes": 0,
     "generated_code_bytes": 0},  # total derived from the byte keys
    {"component": "serve_vm", "mesh_layout": "pop=2", "temp_bytes": 7},
]


@pytest.mark.parametrize("records", [
    ROWS, ROWS[2:], [],
    [m for m in load_run(GOLDEN)[2] if m["kind"] == "memory_footprint"],
], ids=["mixed", "partial", "empty", "golden_run"])
def test_rollup_equals_fks_tpu(records):
    assert rollup(records) == jmem.rollup(records)


def test_rollup_defaults_to_process_ledger():
    LEDGER.clear()
    fp = {"temp_bytes": 1000, "argument_bytes": 200, "output_bytes": 0,
          "generated_code_bytes": 0, "total_bytes": 1200}
    rec = RecStub()
    out = record_footprint("evolve", "pop=8,cap=64", footprint=fp,
                           recorder=rec, engine="exact")
    assert out["component"] == "evolve" and out["mesh_layout"] == ""
    assert rec.metrics[0]["kind"] == "memory_footprint"
    agg = rollup()
    assert len(agg) == 1 and agg[0]["predicted_hbm_bytes"] == 1200
    # no footprint (the CPU's) records nothing
    assert record_footprint("evolve", "x", footprint={}) is None
    LEDGER.clear()


@pytest.mark.parametrize("raw", [
    None, {}, {"weird": 1}, {"bytes_in_use": 7},
    {"bytes_in_use": 10, "peak_bytes_in_use": 20, "bytes_limit": 30},
    {"bytes_used": 1, "peak_bytes": 2, "bytes_reservable_limit": 3},
    {"bytes_in_use": True, "largest_alloc_size": 5, "pool_bytes": 6.0},
])
def test_normalize_memory_stats_equals_fks_tpu(raw):
    assert normalize_memory_stats(raw) == jax_normalize(raw)


def test_normalize_reads_the_caching_allocator():
    raw = {"allocated_bytes.all.current": 4096,
           "allocated_bytes.all.peak": 8192, "allocation.all.current": 3,
           "bytes_limit": 80 << 30}
    assert normalize_memory_stats(raw) == {
        "bytes_in_use": 4096, "peak_bytes_in_use": 8192,
        "bytes_limit": 80 << 30}


# -------------------------------------------------------------- sampler

def test_disabled_sampler_is_a_true_noop():
    rec = RecStub()
    s = WatermarkSampler(enabled=False, recorder=rec)
    with s:
        assert s.sample(stage="x") == {}
    assert not s.samples and not rec.metrics and s._thread is None
    assert NULL_SAMPLER.sample() == {}


def test_enabled_sampler_records_fks_tpu_keys():
    out = {}
    for tag, cls in (("fk", jmem.WatermarkSampler),
                     ("pt", WatermarkSampler)):
        rec = RecStub()
        with cls(enabled=True, recorder=rec, trace_host=True) as s:
            out[tag] = s.sample(stage="unit")
        assert rec.metrics and rec.metrics[0]["kind"] == "memory_watermark"
    got, want = out["pt"], out["fk"]
    assert got["stage"] == "unit" and got["host_rss_kb"] > 0
    assert sorted(got) == sorted(want)
    # the CPU reports identity only, in both packages
    assert got["devices"] == [{"id": 0, "platform": "cpu"}]
    assert all(sorted(d) == ["id", "platform"] for d in want["devices"])


def test_sampler_interval_thread_lifecycle():
    import time

    s = WatermarkSampler(enabled=True, interval_s=0.01, recorder=RecStub())
    s.start()
    deadline = time.time() + 5.0
    while not s.samples and time.time() < deadline:
        time.sleep(0.01)
    s.stop()
    assert s.samples and s.samples[0]["stage"] == "interval"
    assert s._thread is None


# -------------------------------------------------------- leak sentinel

def test_leak_sentinel_flags_real_growth_and_clears_on_free():
    if torch.cuda.is_available():
        pytest.skip("with a card the sentinel reads the caching allocator")
    rec = RecStub()
    held = []
    s = LeakSentinel("serve_batch", recorder=rec)
    s.fence()
    held.append(torch.zeros(1024, dtype=torch.float32) + 1.0)
    verdict = s.check(iterations=1)
    assert not verdict["ok"]
    assert verdict["drift_count"] >= 1
    assert verdict["drift_bytes"] >= 4096
    held.clear()
    s2 = LeakSentinel("serve_batch", recorder=rec)
    s2.fence()
    tmp = torch.ones(1024, dtype=torch.float32) * 2.0
    view = tmp[1:]  # a view shares its storage: counted once
    del tmp, view
    assert s2.check(iterations=1)["ok"]
    assert {m["kind"] for m in rec.metrics} == {"leak_check"}
    # and fks_tpu's verdict record has the same keys
    js = jmem.LeakSentinel("serve_batch", recorder=RecStub())
    js.fence()
    x = jnp.ones(8)
    assert sorted(js.check(iterations=1)) == sorted(verdict)
    del x


def test_live_stats_count_storages_not_views():
    if torch.cuda.is_available():
        pytest.skip("with a card the sentinel reads the caching allocator")
    base = live_array_stats()
    x = torch.zeros(256, dtype=torch.float64)
    views = [x[1:], x.view(16, 16), x[::2]]
    now = live_array_stats()
    assert now["count"] - base["count"] == 1
    assert now["bytes"] - base["bytes"] == 2048
    del x, views


def test_leak_fence_context_manager_sets_result():
    with leak_fence("promotion", iterations=3, recorder=RecStub()) as s:
        pass
    assert s.result is not None and s.result["iterations"] == 3


def test_leak_sentinel_contracts():
    with pytest.raises(ValueError):
        LeakSentinel("not_a_loop", recorder=RecStub())
    s = LeakSentinel("vm_swap", recorder=RecStub())
    with pytest.raises(RuntimeError):
        s.check(1)
    stats = live_array_stats()
    assert stats["count"] >= 0 and stats["bytes"] >= 0


def test_vocabularies_equal_fks_tpu_and_the_schema_tool():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_jsonl_schema as cjs
    finally:
        sys.path.pop(0)
    assert LEAK_LOOPS == jmem.LEAK_LOOPS
    assert MEMORY_COMPONENTS == jmem.MEMORY_COMPONENTS
    assert FOOTPRINT_KEYS == jmem.FOOTPRINT_KEYS
    assert set(MEMORY_COMPONENTS) == cjs.MEMORY_COMPONENTS
    assert set(LEAK_LOOPS) == cjs.LEAK_LOOPS


# --------------------------------------------------------------- drills

def test_unknown_drill_raises():
    with pytest.raises(KeyError):
        run_drill("coffee_leak")


def test_drill_vm_swap_leak_reduced_scale():
    rec = RecStub()
    out = run_drill("vm_swap_leak", swaps=3, batches=6, recorder=rec,
                    device="cpu")
    assert out["ok"], out
    assert out["drift_count"] == 0 and out["drift_bytes"] == 0
    assert out["batches"] == 6 and "seconds" in out
    assert any(m["kind"] == "leak_check" for m in rec.metrics)
    want = jmem.run_drill("vm_swap_leak", swaps=3, batches=6,
                          recorder=RecStub())
    assert sorted(out) == sorted(want)
    assert {k: out[k] for k in ("ok", "drill", "swaps", "batches", "loop",
                                "iterations", "drift_count",
                                "drift_bytes")} == \
        {k: want[k] for k in ("ok", "drill", "swaps", "batches", "loop",
                              "iterations", "drift_count", "drift_bytes")}


def test_drill_snapshot_cache_bound():
    out = run_drill("snapshot_cache_bound", recorder=RecStub(),
                    device="cpu")
    assert out["ok"], out
    assert out["over_cap_observations"] == 0
    assert out["evicted"] and out["recent_rehit"]
    want = jmem.run_drill("snapshot_cache_bound", recorder=RecStub())
    assert sorted(out) == sorted(want)
    for k in ("ok", "drill", "over_cap_observations", "evicted",
              "recent_rehit", "hits", "misses", "entries"):
        assert out[k] == want[k], k


# -------------------------------------------------------------- cli mem

def test_cli_mem_view_golden_equals_fks_tpu():
    rc_f, want, _ = run(fk_cli, ["mem", "--run-dir", GOLDEN])
    rc_p, got, _ = run(pt_cli, ["mem", "--run-dir", GOLDEN])
    assert rc_f == rc_p == 0
    assert got == want
    assert "lanes=2,pods=8" in got and "leak sentinel" in got


def test_cli_mem_modes_and_errors(tmp_path):
    for cli in (fk_cli, pt_cli):
        assert run(cli, ["mem"])[0] == 2
        assert run(cli, ["mem", "--run-dir", str(tmp_path / "no")])[0] == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "meta.json").write_text("{}")
    assert run(pt_cli, ["mem", "--run-dir", str(empty)]) == \
        run(fk_cli, ["mem", "--run-dir", str(empty)])


def test_cli_mem_sample():
    rc, out, _ = run(pt_cli, ["mem", "--sample", "--cpu"])
    assert rc == 0
    rec = json.loads(out)
    assert rec["stage"] == "cli" and rec["host_rss_kb"] > 0
    assert rec["devices"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt_cli.main(["mem", "--sample"])


def test_cli_mem_drill_records_and_renders(tmp_path):
    run_dir = str(tmp_path / "run")
    rc, out, _ = run(pt_cli, ["mem", "--cpu", "--drill", "vm_swap_leak",
                              "--swaps", "3", "--batches", "6",
                              "--run-dir", run_dir])
    assert rc == 0 and json.loads(out)["ok"]
    rc, out, _ = run(pt_cli, ["mem", "--run-dir", run_dir])
    assert rc == 0 and "leak sentinel vm_swap: ok" in out
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_jsonl_schema as cjs
    finally:
        sys.path.pop(0)
    assert cjs.check_run_dir(run_dir)["metrics.jsonl"] >= 1
    assert os.path.exists(os.path.join(run_dir, "meta.json"))
