"""The decision trace (``SimConfig.decision_trace``) and
fks_tpu_torch.obs.tracing vs fks_tpu's.

- Rows equal fks_tpu's row for row (kinds, pods, nodes, pending counts,
  free aggregates exact; score and margin exact too) in both engines, on
  the micro workload, the golden fault workload (NODE_DOWN / NODE_UP rows)
  and the contended workload (RETRY rows).
- The buffer saturates at ``trace_len``: the first ``trace_len`` rows,
  and nothing of the scratch row.
- Per-lane isolation: each lane of a batched suite run, fault lanes
  included, traces what its scenario traces alone.
- ``align_traces`` / ``trace_diff`` localize the first divergence between
  the exact and flat engines where fks_tpu's do, write through the active
  recorder, and report none for an engine against itself.
"""
import dataclasses
import json
import pathlib

import pytest
import torch

from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.models import zoo as jzoo
from fks_tpu.obs import tracing as jtracing
from fks_tpu.scenarios import ScenarioSpec as JaxSpec
from fks_tpu.scenarios import perturb_workload as jax_perturb
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.funsearch.backend import CodeEvaluator
from fks_tpu_torch.models import zoo
from fks_tpu_torch.obs import tracing
from fks_tpu_torch.obs.recorder import NullRecorder, get_recorder, recording
from fks_tpu_torch.scenarios import (
    ScenarioSpec, get_suite, make_suite_eval, perturb_workload,
)
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import one_torch_thread, port_workload
from tests.test_engine_micro import micro_workload
from tests.test_fused import _contended

GOLDEN = json.loads((pathlib.Path(__file__).parent / "fixtures"
                     / "golden_scenario_fault.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def fks_workload(case):
    """fks_tpu's workload of a case (the port's copy is port_workload)."""
    if case == "micro":
        return micro_workload()
    if case == "contended":
        return _contended()
    return jax_perturb(jax_synthetic(**GOLDEN["workload"]),
                       JaxSpec(**GOLDEN["spec"]))


def zoo_spec(name, mod):
    pol = getattr(mod, name)()
    return lambda _p, pod, nodes: pol(pod, nodes)


def port_rows(wl, eng, policy="best_fit", **cfg):
    res = tracing.replay(wl, eng, zoo_spec(policy, zoo), None,
                         SimConfig(**cfg), device="cpu")
    return res, tracing.extract_trace(res)


def fks_rows(jwl, eng, policy="best_fit", **cfg):
    return jtracing.extract_trace(jtracing.replay(
        jwl, eng, zoo_spec(policy, jzoo), None, JaxConfig(**cfg)))


@pytest.mark.parametrize("eng", ["exact", "flat"])
@pytest.mark.parametrize("case", ["micro", "fault", "contended"])
def test_rows_match_fks_tpu(case, eng):
    jwl = fks_workload(case)
    cfg = dict(max_steps=4 * 96) if case == "contended" else {}
    # micro: the reference's integer policy for it. best_fit's float32
    # scores there hit a trunc flip between fks_tpu's jit-constant
    # arithmetic and the run-time form the port follows (ROADMAP queue 3)
    policy = "micro_best_fit" if case == "micro" else "best_fit"
    _, got = port_rows(port_workload(jwl), eng, policy, **cfg)
    want = fks_rows(jwl, eng, policy, **cfg)
    assert got == want
    kinds = {r["kind"] for r in got}
    expect = {"micro": {"CREATE", "DELETE"},
              "fault": {"CREATE", "DELETE", "NODE_DOWN", "NODE_UP"},
              "contended": {"CREATE", "DELETE", "RETRY"}}[case]
    assert expect <= kinds


@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_buffer_saturates_at_trace_len(eng):
    jwl = fks_workload("fault")
    wl = port_workload(jwl)
    full = port_rows(wl, eng)[1]
    res, rows = port_rows(wl, eng, trace_len=7)
    assert int(res.trace.count) == 7 and res.trace.length == 7
    assert rows == full[:7] == fks_rows(jwl, eng, trace_len=7)
    # later appends went to the scratch row, which no reader counts
    assert res.trace.data.shape == (8, 8)
    assert len(full) == int(res.events_processed) + GOLDEN[
        "policies"]["best_fit"]["fault_rows"]


@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_batched_lanes_trace_alone(eng):
    suite = get_suite("smoke3", synthetic_workload(4, 24, seed=3))
    cfg = SimConfig(decision_trace=True)
    res = make_suite_eval(suite, param_policy=zoo_spec("first_fit", zoo),
                          cfg=cfg, engine=eng, device="cpu")(None)
    assert res.trace.data.shape[0] == 3
    with pytest.raises(ValueError, match="lane="):
        tracing.extract_trace(res)
    for t, wl in enumerate(suite.workloads):
        alone = port_rows(wl, eng, "first_fit")[1]
        assert tracing.extract_trace(res, lane=t) == alone
        assert tracing.extract_trace(res.lane(t)) == alone
    fault_rows = [r for r in tracing.extract_trace(res, lane=2)
                  if r["kind"] in ("NODE_DOWN", "NODE_UP")]
    assert len(fault_rows) == suite.workloads[2].faults.num_events == 2


class ListRecorder(NullRecorder):
    def __init__(self):
        self.events, self.status = [], None

    def event(self, kind, **fields):
        self.events.append((kind, fields))

    def finish(self, status="ok"):
        self.status = status


def test_trace_diff_localizes_the_first_divergence():
    jwl = fks_workload("contended")
    wl = port_workload(jwl)
    cfg = dict(max_steps=4 * 96)

    def specs(mod):
        pol = zoo_spec("best_fit", mod)
        return [("exact", "exact", pol, None), ("flat", "flat", pol, None)]

    rec = ListRecorder()
    with recording(rec):
        assert get_recorder() is rec
        got = tracing.trace_diff(wl, specs(zoo), cfg=SimConfig(**cfg),
                                 label="contended", device="cpu")
    assert get_recorder() is not rec and rec.status == "ok"
    want = jtracing.trace_diff(jwl, specs(jzoo), cfg=JaxConfig(**cfg),
                               label="contended")
    assert got["divergent"] and got == want
    div = got["first_divergence"]
    # the engines' retry rules differ, so their traces part ways
    assert tracing.align_traces(port_rows(wl, "exact", **cfg)[1],
                                port_rows(wl, "flat", **cfg)[1]) == div
    assert [k for k, _ in rec.events] == ["decision_trace", "decision_trace",
                                          "trace_diff"]
    assert f"FIRST DIVERGENCE at step {div['step']}" in tracing.format_diff(
        got)
    same = tracing.trace_diff(wl, [specs(zoo)[0], specs(zoo)[0]],
                              device="cpu")
    assert not same["divergent"] and "no divergence" in tracing.format_diff(
        same)
    short = port_rows(wl, "exact", **cfg)[1]
    assert tracing.align_traces(short, short[:5])["field"] == "length"


def test_errors():
    wl = port_workload(fks_workload("micro"))
    res = tracing.replay(wl, "exact", zoo_spec("best_fit", zoo), None,
                         device="cpu")
    with pytest.raises(ValueError, match="lane= given"):
        tracing.extract_trace(res, lane=0)
    with pytest.raises(ValueError, match="no decision trace"):
        tracing.extract_trace(dataclasses.replace(res, trace=None))
    with pytest.raises(ValueError, match="exactly 2 specs"):
        tracing.trace_diff(wl, [], device="cpu")
    with pytest.raises(ValueError, match="fused kernel"):
        tracing.replay(wl, "fused", zoo_spec("best_fit", zoo), None,
                       device="cpu")
    pol, params = tracing.policy_params(wl, "first_fit")
    assert params is None
    with pytest.raises(ValueError, match="unknown policy"):
        tracing.policy_params(wl, "nope")
    # candidate source runs on the funsearch VM, after the sandbox's
    # validation; so does candidate_trace_diff's
    with pytest.raises(ValueError, match="exactly one function"):
        tracing.policy_params(wl, code="def score(pod, node): return 1")
    with pytest.raises(ValueError, match="exactly one function"):
        tracing.candidate_trace_diff(CodeEvaluator(wl, device="cpu"),
                                     "def score(pod, node): return 1")
    # replaying a fault workload in a flat run of a different policy
    flt = perturb_workload(synthetic_workload(4, 24, seed=3),
                           ScenarioSpec("f", seed=2, fault_nodes=1))
    rows = tracing.replay(flt, "flat", pol, None, device="cpu")
    assert torch.equal(rows.trace.count, torch.tensor(
        int(rows.events_processed) + 2, dtype=torch.int32))
