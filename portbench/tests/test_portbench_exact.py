"""The exact cell (``openb16-exact-pop256``, ``loops.search_exact``) on the
CPU at a small size. ``BENCHMARK.json`` lists the cell, its
configuration and its three metrics at the ends of their lists, and the
cell in ``cand_evals_per_s.flat``'s ``workloads``. A sound run is
correct, every fault that ``test_portbench_faults`` plants comes out not
correct here too, as do a retry time changed where it is produced, a
lane marked aborted that the reference runs to its end, and the
reference one precision below the configuration's in the program's
place; the loop refuses a configuration that states other semantics;
and the cell's metric readers read nothing outside their engine or
without their counters."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, ring
from portbench.loops import inputs, search, search_exact
from portbench.reference import exact_sim
from portbench.tests import test_portbench_faults as faults
from portbench.tests import test_portbench_schema as schema

ROOT = Path(__file__).resolve().parents[2]
CELL = "openb16-exact-pop256"
METRICS = ["exact.step_us", "exact.step_us.window", "exact.lane_occupancy"]
#: the first 300 pods make three of the fixed initial population's eight
#: lanes retry; that population is the window's first generation, and
#: every lane is replayed
RETRYING = {"max_pods": 300, "mix": dict(faults.SMALL["mix"],
                                         warmup_generations=0,
                                         check_parts=8)}


@pytest.mark.parametrize("form", [schema.test_top_level_keys,
                                  schema.test_names_units_and_texts,
                                  schema.test_every_cell_reports_enough],
                         ids=lambda f: f.__name__)
def test_the_pending_entries_keep_the_benchmarks_form(form):
    """The benchmark with the cell's entries keeps its form, and they sit
    at the ends of their lists."""
    bench = harness.load_benchmark(ROOT)
    form(bench)
    assert bench["configs"][-1]["name"] == "openb16-exact"
    assert bench["workloads"][-1]["name"] == CELL
    assert [m["name"] for m in bench["per_layer"][-3:]] == METRICS
    flat = [m for m in bench["end_to_end"]
            if m["name"] == "cand_evals_per_s.flat"]
    assert flat[0]["workloads"][-1] == CELL


def test_the_pending_cell_resolves_to_its_files():
    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, CELL)
    assert (cell["config"], cell["chips"]) == ("openb16-exact", 1)
    mix = harness.load_json("traffic", cell["traffic"])
    assert harness.loop(mix) is search_exact
    assert mix["warmup_capture"] and mix["warmup_generations"] == 0
    assert [m["name"] for m in harness.metrics_of(bench, CELL, True)] == \
        METRICS
    assert [m["name"] for m in harness.metrics_of(bench, CELL, False)] == \
        ["cand_evals_per_s.flat", "setup_s"]


def run(fault=None, over=RETRYING):
    over = dict(over)
    if fault is not None:
        over["fault"] = fault
    line, _ = harness.run_cell(ROOT, CELL, 5, 0.3, False, device="cpu",
                               overrides=over)
    return line


@pytest.mark.parametrize("planted", [
    faults.test_a_sound_run_is_correct,
    faults.test_a_step_that_returns_its_state_unchanged,
    faults.test_half_the_population_left_out,
    faults.test_half_the_lanes_keep_the_last_generations_results,
    faults.test_an_answer_altered_where_it_is_produced,
], ids=lambda f: f.__name__)
def test_the_faults_of_the_other_cells(planted):
    planted(CELL)


def test_a_placement_altered_where_it_is_produced():
    def fault(pe):
        def change(params, res):
            res.assigned_node[:, 0] = (res.assigned_node[:, 0] + 1) % 16
            return res

        faults._wrap_eval(pe, change)

    line = run(fault)
    assert line["correct"] is False
    assert line["checks"]["int_mismatch"]["value"] > 0


def test_a_retry_time_altered_where_it_is_produced():
    """Every pod whose creation time the retry rule rewrote is retried one
    time unit later; placements, counts and scores stay as they were."""
    cfg = harness.load_json("configs", "openb16-exact")
    _, pods, _ = inputs.reference_inputs(cfg, RETRYING["max_pods"])
    ctime0 = torch.from_numpy(pods.ctime).to(torch.int32)
    moved = []

    def fault(pe):
        def change(params, res):
            ct = res.pod_ctime[:, :pods.count]
            retried = ct != ctime0
            moved.append(int(retried.sum()))
            ct += retried.to(ct.dtype)
            return res

        faults._wrap_eval(pe, change)

    line = run(fault)
    assert sum(moved) > 0
    assert line["correct"] is False
    assert line["checks"]["int_mismatch"]["value"] > 0
    assert line["checks"]["fitness_gap"]["value"] == 0.0


def test_a_lane_marked_aborted_that_the_reference_runs_through():
    def fault(pe):
        def change(params, res):
            res.failed[1] = True
            res.events_processed[1] = 3
            return res

        faults._wrap_eval(pe, change)

    line = run(fault)
    assert line["correct"] is False
    assert line["checks"]["short_lanes"]["value"] > 0


def test_the_control_is_not_correct():
    """The reference computed in bfloat16 in the program's place."""
    cfg = harness.load_json("configs", "openb16-exact")
    cluster, pods, _ = inputs.reference_inputs(cfg, RETRYING["max_pods"])

    def fault(pe):
        def change(params, res):
            low = exact_sim.run(cluster, pods, params.cpu().numpy(),
                                precision="bfloat16")
            out = {}
            for k in search.INT_FIELDS + search.FLOAT_FIELDS:
                x = getattr(res, k)
                out[k] = torch.tensor([r[k] for r in low], dtype=x.dtype)
            for k in search.POD_FIELDS + ("pod_ctime",):
                x = getattr(res, k).clone()
                x[:, :pods.count] = torch.from_numpy(np.stack(
                    [r[k] for r in low])).to(x.dtype)
                out[k] = x
            return dataclasses.replace(res, **out)

        faults._wrap_eval(pe, change)

    line = run(fault)
    assert line["correct"] is False
    c = line["checks"]
    assert c["int_mismatch"]["value"] > 0 or \
        c["fitness_gap"]["value"] > c["fitness_gap"]["limit"]


@pytest.mark.parametrize("config,engine", [("openb16", "exact"),
                                           ("openb16-exact", "flat")])
def test_other_semantics_are_refused(config, engine):
    cfg = harness.load_json("configs", config)
    mix = dict(harness.load_json("traffic", "search-exact-pop256"),
               engine=engine)
    with pytest.raises(ValueError, match="exact"):
        search_exact.run({}, cfg, mix, 1, 0.1, False, device="cpu",
                         overrides={"max_pods": 40})


class _Gen:
    label = "gen"

    def __init__(self, **counters):
        self.counters = counters
        self.seconds = 1.0


@pytest.fixture
def window(monkeypatch):
    """Two window generations in the ring, with what the exact engine's
    drain counts on the card (``lane_steps`` and ``lane_slots``
    optional): two jobs of 4 lanes each, so the lane slots are not the
    steps times the population."""
    def make(lane_steps=True):
        c = {"engine_device_s": 0.5, "rounds": 11, "replays": 10,
             "steps": 160, "round_gap_s": 0.001}
        if lane_steps:
            c["lane_slots"] = 160 * 8
            c["lane_steps"] = 160 * 8 * 3 // 4
        monkeypatch.setattr(ring, "window", lambda rec: [_Gen(**c)] * 2)
        return {"generations": 2, "pop": 4, "engine": "exact"}

    return make


def test_window_readers(window):
    rec = window()
    assert harness.read_metric("exact.step_us.window", rec) == \
        pytest.approx(1e6 * 1.0 / 320)
    assert harness.read_metric("exact.lane_occupancy", rec) == \
        pytest.approx(75.0)
    rec = window(lane_steps=False)  # a program that does not count them
    assert harness.read_metric("exact.lane_occupancy", rec) is None
    assert harness.read_metric("exact.step_us.window", rec) is not None


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_nothing_outside_their_engine(name, window):
    rec = dict(window(), engine="flat", trace_replays=32, steps_per_replay=16,
               timeline={"busy_s": 0.1, "window_s": 1.0})
    assert harness.read_metric(name, rec) is None
    assert harness.read_metric(name, {}) is None


def test_step_time_from_traced_replays():
    rec = {"timeline": {"busy_s": 0.32, "window_s": 1.0}, "engine": "exact",
           "trace_replays": 50, "steps_per_replay": 16}
    assert harness.read_metric("exact.step_us", rec) == pytest.approx(400.0)
    assert harness.read_metric("exact.step_us",
                               dict(rec, trace_replays=0)) is None

