"""The port's stage profiler (fks_tpu_torch.obs.profiler) against
fks_tpu's, on the CPU, with the timing and throughput helpers it uses.

The cases of fks_tpu's tests/test_profiler.py that mean something in
PyTorch: the wall / compile / compute split against the watcher (the
port's "compile" is a CUDA graph capture, reported by
``obs.telemetry.graph_capture``; fks_tpu's an XLA compile), nested-stage
depth, the disabled profiler as a no-op, occupancy folding, the
``profile_launch`` record, the summary's attribution and ``emit``, and a
profiled evolve attributing at least 95% of its wall. The same stage
structure runs through both profilers and their records and summaries
carry the same keys. Left out: the jaxpr pins of the profiled path
(tests/test_profiler.py:119 and :136; PyTorch lowers nothing to pin) and
the FLOP pricing of :157 (no PyTorch call gives a program's FLOP count,
so the port records no ``est_flops_per_sec``).
"""
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from fks_tpu.obs.profiler import StageProfiler as JaxStageProfiler
from fks_tpu.obs.profiler import _finish_utilization as jax_finish
from fks_tpu.parallel.mesh import occupancy_stats as jax_occupancy
from fks_tpu.utils import ThroughputMeter as JaxMeter
from fks_tpu.utils import result_record as jax_result_record
from fks_tpu_torch.obs.memory import WatermarkSampler
from fks_tpu_torch.obs.profiler import (
    NULL_PROFILER, StageProfiler, _finish_utilization, profile_launch,
)
from fks_tpu_torch.obs.telemetry import CompileWatcher, graph_capture
from fks_tpu_torch.parallel.population import occupancy_stats
from fks_tpu_torch.testing import port_workload
from fks_tpu_torch.utils.logging import result_record
from fks_tpu_torch.utils.profiling import ThroughputMeter, device_trace


class Rows:
    """A recorder keeping ``metric`` rows (``event`` is dropped)."""

    def __init__(self):
        self.rows = []

    def metric(self, kind, *dicts, **fields):
        row = {"kind": kind}
        for d in dicts:
            row.update(d)
        row.update(fields)
        self.rows.append(row)

    def event(self, *a, **kw):
        pass


def capture(seconds=0.002):
    """What the port's runners do around a CUDA graph capture."""
    with graph_capture("test"):
        time.sleep(seconds)


def jax_compile():
    # a new lambda each call -> a new jit cache entry -> a real compile
    jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * 2.0)(jnp.ones(8)))


def test_stage_records_wall_and_capture_split_like_fks_tpu():
    recs = {}
    for tag, prof_cls, first in (("fk", JaxStageProfiler, jax_compile),
                                 ("pt", StageProfiler, capture)):
        rows = Rows()
        with prof_cls(scope="t", recorder=rows) as prof:
            with prof.stage("warm", lanes=64) as h:
                first()
                h.sync(torch.ones(1) if tag == "pt" else jnp.ones(1))
            with prof.stage("steady"):
                pass
        recs[tag] = (prof.records, rows.rows)
    (fk, fk_rows), (pt, pt_rows) = recs["fk"], recs["pt"]
    assert [sorted(r) for r in pt] == [sorted(r) for r in fk]
    warm, steady = pt
    assert warm["stage"] == "warm" and warm["scope"] == "t"
    assert warm["lanes"] == 64 and warm["depth"] == 0
    assert warm["compile_count"] == 1
    assert 0.002 <= warm["compile_seconds"] <= warm["wall_seconds"]
    assert steady["compile_count"] == 0
    assert steady["compute_seconds"] == steady["wall_seconds"]
    assert [r["kind"] for r in pt_rows] == [r["kind"] for r in fk_rows] \
        == ["device_profile"] * 2


def test_capture_split_matches_watcher():
    watcher = CompileWatcher().install()
    try:
        prof = StageProfiler(scope="t", recorder=Rows(), watcher=watcher)
        capture()  # before the stages: not theirs
        s0 = watcher.backend_compile_seconds
        n0 = watcher.backend_compile_count
        for name in ("a", "b"):
            with prof.stage(name):
                capture()
        got_n = sum(r["compile_count"] for r in prof.records)
        got_s = sum(r["compile_seconds"] for r in prof.records)
        assert got_n == watcher.backend_compile_count - n0 == 2
        assert got_s == pytest.approx(
            watcher.backend_compile_seconds - s0, abs=1e-5)
        prof.close()
        assert watcher._installed  # a borrowed watcher stays installed
    finally:
        watcher.uninstall()


def test_nested_stage_depth_excluded_from_summary():
    summaries = []
    for prof_cls in (JaxStageProfiler, StageProfiler):
        prof = prof_cls(scope="t", recorder=Rows())
        with prof.stage("outer"):
            with prof.stage("inner"):
                time.sleep(0.01)
        prof.close()
        by = {r["stage"]: r for r in prof.records}
        assert by["inner"]["depth"] == 1 and by["outer"]["depth"] == 0
        summ = prof.summary(measured_wall=by["outer"]["wall_seconds"])
        assert [s["stage"] for s in summ["stages"]] == ["outer"]
        summaries.append(summ)
    assert sorted(summaries[1]) == sorted(summaries[0])
    assert sorted(summaries[1]["stages"][0]) == \
        sorted(summaries[0]["stages"][0])


def test_disabled_profiler_is_pure_noop():
    assert not NULL_PROFILER.enabled
    sentinel = object()  # block_until_ready would not know this
    with NULL_PROFILER.stage("anything", lanes=8) as h:
        assert h.sync(sentinel) is sentinel
        h.annotate(ignored=1)
        assert h.record is None
    NULL_PROFILER.segment_tick()
    assert NULL_PROFILER.records == []
    assert NULL_PROFILER.watcher is None
    assert not StageProfiler(enabled=False).enabled


@pytest.mark.parametrize("real,shards,scenarios,segments", [
    (6, 8, 1, 1), (5, 4, 8, 3), (8, 8, 2, 1), (0, 2, 1, 1)])
def test_occupancy_folds_like_fks_tpu(real, shards, scenarios, segments):
    got = occupancy_stats(real, shards, scenarios=scenarios,
                          segments=segments)
    want = jax_occupancy(real, shards, scenarios=scenarios,
                         segments=segments)
    assert got == want
    for compute in (0.5, 1.0):
        a = {"wall_seconds": 1.0, "compute_seconds": compute, **got}
        b = dict(a)
        _finish_utilization(a)
        jax_finish(b)
        assert a == b


def test_flops_are_not_priced():
    """fks_tpu prices an attached ``cost_flops`` into
    ``est_flops_per_sec``; PyTorch gives no FLOP count, so the port
    leaves both out (the occupancy fields still fold)."""
    rec = {"wall_seconds": 2.0, "compute_seconds": 1.0,
           "pad_waste_fraction": 0.25, "cost_flops": 1e9}
    _finish_utilization(rec)
    assert rec["occupancy"] == 0.75 and rec["utilization_pct"] == 37.5
    assert "est_flops_per_sec" not in rec


def test_profile_launch_record_shape():
    calls = []

    def launch(x):
        if not calls:
            capture()  # the first call captures, as a runner's does
        calls.append(1)
        return x * 2

    prof = StageProfiler(scope="t", recorder=Rows())
    out, rec = profile_launch(launch, torch.ones(8), name="step",
                              profiler=prof, reps=3)
    prof.close()
    assert torch.equal(out, torch.full((8,), 2.0)) and len(calls) == 4
    assert rec["name"] == "step" and rec["reps"] == 3
    assert rec["compile_count"] == 1
    assert 0.0 < rec["best_seconds"] <= rec["steady_total_seconds"]
    assert rec["compile_seconds"] <= rec["first_call_seconds"]
    assert [r["stage"] for r in prof.records] == ["step:compile",
                                                  "step:steady"]
    # the disabled path still measures best_seconds, without stage records
    _, rec2 = profile_launch(launch, torch.ones(8), name="off")
    assert "compile_seconds" not in rec2 and rec2["best_seconds"] > 0


def test_summary_attribution_and_emit():
    out = {}
    for tag, prof_cls in (("fk", JaxStageProfiler), ("pt", StageProfiler)):
        rows = Rows()
        prof = prof_cls(scope="t", recorder=rows)
        for name, secs in (("a", 0.03), ("b", 0.01)):
            with prof.stage(name, pad_waste_fraction=0.5):
                time.sleep(secs)
        prof.close()
        summ = prof.summary(measured_wall=0.05, emit=True)
        out[tag] = (summ, [r for r in rows.rows
                           if r.get("stage") == "__total__"])
    summ, total = out["pt"]
    assert [s["stage"] for s in summ["stages"]] == ["a", "b"]
    assert summ["attributed_fraction"] >= 0.75
    assert summ["attributed_fraction"] + summ["idle_fraction"] == \
        pytest.approx(1.0, abs=1e-3)
    assert all("utilization_pct" in s for s in summ["stages"])
    assert len(total) == 1
    assert total[0]["attributed_fraction"] == summ["attributed_fraction"]
    assert sorted(summ) == sorted(out["fk"][0])
    assert sorted(total[0]) == sorted(out["fk"][1][0])


def test_stage_sampler_hook_samples_each_stage():
    rows = Rows()
    sampler = WatermarkSampler(enabled=True, recorder=rows)
    prof = StageProfiler(scope="t", recorder=rows, sampler=sampler)
    with sampler:
        with prof.stage("a"):
            pass
        with prof.stage("b"):
            pass
    prof.close()
    assert [s["stage"] for s in sampler.samples] == ["a", "b"]
    assert [r["kind"] for r in rows.rows] == [
        "device_profile", "memory_watermark"] * 2


def test_evolve_profile_attribution_ge_95pct():
    """A profiled flat-engine evolve on the CPU attributes at least 95% of
    its wall to named stages (fks_tpu's bar), with fks_tpu's stage names
    for the same run."""
    from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
    from fks_tpu.funsearch import evolution as jax_evolution
    from fks_tpu_torch.data.synthetic import synthetic_workload
    from fks_tpu_torch.funsearch import evolution

    kw = dict(population_size=6, generations=2, candidates_per_generation=3,
              early_stop_threshold=10.0, max_workers=2)
    t0 = time.perf_counter()
    fs = evolution.run(synthetic_workload(8, 12, seed=0),
                       evolution.EvolutionConfig(**kw), engine="flat",
                       log=lambda *_: None, profile=True, device="cpu")
    wall = time.perf_counter() - t0
    assert fs.profiler.enabled and fs.profiler.records
    summ = fs.profiler.summary(measured_wall=wall)
    assert summ["attributed_fraction"] >= 0.95, summ
    stages = {s["stage"] for s in summ["stages"]}
    assert {"setup", "seed", "codegen", "rank", "ledger"} <= stages
    assert "device-eval" in {r["stage"] for r in fs.profiler.records}
    jfs = jax_evolution.run(jax_synthetic(8, 12, seed=0),
                            jax_evolution.EvolutionConfig(**kw),
                            engine="flat", log=lambda *_: None, profile=True)
    assert sorted(r["stage"] for r in fs.profiler.records) == \
        sorted(r["stage"] for r in jfs.profiler.records)
    # profile off leaves the same run uninstrumented
    fs2 = evolution.run(synthetic_workload(8, 12, seed=0),
                        evolution.EvolutionConfig(**kw), engine="flat",
                        log=lambda *_: None, device="cpu")
    assert not fs2.profiler.enabled and fs2.profiler.records == []


def test_throughput_meter_equal_fks_tpu():
    a, b = ThroughputMeter(), JaxMeter()
    assert a.rate is None and b.rate is None
    for count, secs in ((8, 0.5), (3, 0.25), (0, 0.25)):
        a.add(count, secs)
        b.add(count, secs)
    assert a.rate == b.rate == 11.0
    assert a.summary() == b.summary()
    assert (a.total_count, a.total_seconds) == (b.total_count,
                                                b.total_seconds)


def test_result_record_equal_fks_tpu(micro_workload):
    from fks_tpu.models import zoo as jax_zoo
    from fks_tpu.sim.engine import SimConfig as JaxConfig
    from fks_tpu.sim.engine import simulate as jax_simulate
    from fks_tpu_torch.models import zoo
    from fks_tpu_torch.sim.engine import SimConfig, simulate

    want = jax_result_record(jax_simulate(
        micro_workload, jax_zoo.ZOO["best_fit"](dtype=jnp.float64),
        JaxConfig(score_dtype=jnp.float64)), policy="best_fit")
    got = result_record(simulate(
        port_workload(micro_workload), zoo.ZOO["best_fit"](torch.float64),
        SimConfig(score_dtype=torch.float64), device="cpu"),
        policy="best_fit")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert type(got[k]) is type(v), k
        assert got[k] == pytest.approx(v, abs=1e-9), k


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        (torch.ones(64) * 2).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
