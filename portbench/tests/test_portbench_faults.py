"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run of a cell (set-up, window, check) on
the CPU at a small size, with one fault planted in the program's pieces:
a generation step that returns its state unchanged, half of the
population left out with the mean of the rest in its place, an answer
altered where it is produced, and the plain reference one precision below
the configuration's in the program's place (the cell's control). The
cells run on one card, so there is no exchange between cards to leave
out."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.loops import inputs
from portbench.reference import flat_sim

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"max_pods": 200, "mix": {"pop": 8, "warmup_generations": 1,
                                  "check_parts": 2, "check_repeats": 1}}
CELLS = ["openb16-fused-pop256", "openb1213-flat-pop32"]


def run(cell, fault=None, max_pods=None):
    over = dict(SMALL)
    if cell.startswith("openb1213"):
        over = {"max_pods": 60, "mix": dict(SMALL["mix"], pop=6)}
    if fault is not None:
        over["fault"] = fault
    line, rec = harness.run_cell(ROOT, cell, 5, 0.3, False, device="cpu",
                                 overrides=over)
    return line


def _wrap_eval(pe, change):
    """Replace the population eval's result by ``change(params, result)``
    where it is produced."""
    pop = pe.eval
    cls = type(pop)

    class Broken(cls):
        def __call__(self, params):
            return change(params, super().__call__(params))

    pop.__class__ = Broken


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged(cell):
    def fault(pe):
        step = pe.step

        def same():
            _, scores, elite = step()
            return pe.params, scores, elite

        pe.step = same

    line = run(cell, fault)
    assert line["correct"] is False
    assert line["checks"]["stale_rows"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_population_left_out(cell):
    def fault(pe):
        def change(params, res):
            half = params.shape[0] // 2

            def keep(x):
                if not isinstance(x, torch.Tensor) or x.dim() == 0:
                    return x
                rest = torch.zeros_like(x[half:])
                return torch.cat([x[:half], rest])

            out = dataclasses.replace(res, **{
                f.name: keep(getattr(res, f.name))
                for f in dataclasses.fields(res)})
            mean = res.policy_score[:half].mean()
            out.policy_score[half:] = mean
            return out

        _wrap_eval(pe, change)

    line = run(cell, fault)
    assert line["correct"] is False
    assert line["checks"]["short_lanes"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_lanes_keep_the_last_generations_results(cell):
    """The second half of every generation's lanes is not evaluated: its
    results are the previous generation's, as buffers left unwritten
    would hold them; every event count and score still looks whole."""
    def fault(pe):
        before = []

        def change(params, res):
            out = res
            if before:
                half = params.shape[0] // 2
                out = dataclasses.replace(res, **{
                    f.name: torch.cat([getattr(res, f.name)[:half],
                                       getattr(before[-1], f.name)[half:]])
                    for f in dataclasses.fields(res)
                    if isinstance(getattr(res, f.name), torch.Tensor)
                    and getattr(res, f.name).dim() > 0})
            before.append(out)
            return out

        _wrap_eval(pe, change)

    line = run(cell, fault)
    assert line["correct"] is False
    assert line["checks"]["short_lanes"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell):
    def fault(pe):
        def change(params, res):
            res.policy_score += 1e-3
            return res

        _wrap_eval(pe, change)

    line = run(cell, fault)
    assert line["correct"] is False
    assert line["checks"]["fitness_gap"]["value"] >= 1e-3 - 1e-7


def test_a_placement_altered_where_it_is_produced():
    def fault(pe):
        def change(params, res):
            res.assigned_node[:, 0] = (res.assigned_node[:, 0] + 1) % 16
            return res

        _wrap_eval(pe, change)

    line = run(CELLS[0], fault)
    assert line["correct"] is False
    assert line["checks"]["int_mismatch"]["value"] > 0


def test_the_control_is_not_correct():
    """The reference computed in bfloat16 in the program's place."""
    cfg = harness.load_json("configs", "openb16")
    cluster, pods, _ = inputs.reference_inputs(cfg, SMALL["max_pods"])

    def fault(pe):
        def change(params, res):
            low = flat_sim.run(cluster, pods, params.cpu().numpy(),
                               precision="bfloat16")
            out = {}
            for k in ("policy_score", "avg_cpu_utilization",
                      "avg_memory_utilization", "avg_gpu_count_utilization",
                      "avg_gpu_memory_utilization",
                      "gpu_fragmentation_score", "num_snapshots",
                      "num_fragmentation_events", "events_processed",
                      "scheduled_pods", "max_nodes", "failed", "truncated"):
                x = getattr(res, k)
                out[k] = torch.tensor([r[k] for r in low], dtype=x.dtype)
            for k in ("assigned_node", "assigned_gpus"):
                x = getattr(res, k).clone()
                x[:, :pods.count] = torch.from_numpy(np.stack(
                    [r[k] for r in low])).to(x.dtype)
                out[k] = x
            return dataclasses.replace(res, **out)

        _wrap_eval(pe, change)

    line = run(CELLS[0], fault)
    assert line["correct"] is False
    c = line["checks"]
    assert c["int_mismatch"]["value"] > 0 or \
        c["fitness_gap"]["value"] > c["fitness_gap"]["limit"]


def test_a_population_seed_gives_every_seed_the_same_candidates():
    from portbench.loops import search

    seen = []
    cfg = harness.load_json("configs", "openb16")
    mix = dict(harness.load_json("traffic", "search-flat-pop32"), pop=8,
               warmup_capture=False)
    for seed in (1, 2 ** 31 + 3):
        search.run({}, cfg, mix, seed, 0.1, False, device="cpu",
                   overrides={"max_pods": 60, "fault": lambda pe: seen.append(
                       pe.params.clone())})
    a, b = (x.numpy() for x in seen)
    assert np.array_equal(a, b)


def _result(nodes, score):
    return {"policy_score": np.array(score, np.float32),
            "assigned_node": np.array(nodes, np.int32)}


def test_lanes_are_drawn_from_every_part_and_repeats_are_replayed():
    from portbench.loops import search

    scores = np.array([0.1, 0.5, 0.2, 0.3, 0.0, 0.4, 0.6, 0.7], np.float32)
    prev = _result([[0, 1]] * 8, [0.1] * 8)
    res = _result([[0, 1]] * 3 + [[1, 1]] * 5, [0.1] * 3 + [0.2] * 5)
    assert search.repeats(res, prev, elite_k=2) == [2]
    assert search.repeats(res, None, elite_k=2) == []
    gens = [(None, None, scores, None), (None, None, scores, None)]
    kept = {"first": (0, res, None), "last": (1, res, prev)}
    mix = {"check_parts": 4, "check_repeats": 1}
    lanes, repeating = search.pick_lanes(mix, 9, gens, kept, 2)
    assert repeating == 1
    for key in ("first", "last"):
        got = sorted(lane for k, lane in lanes[:8] if k == key)
        assert [lane // 2 for lane in got] == [0, 1, 2, 3]
    assert ("first", 7) in lanes[:4]  # the first generation's best
    assert ("last", 2) in lanes
    assert lanes == search.pick_lanes(mix, 9, gens, kept, 2)[0]
