"""The metrics read from the program's own spans (``portbench.ring``):
their arithmetic on a ring filled by hand, None where the ring lost one
of the window's generations, where a device time is missing or where
the program keeps no ring, and, on the CPU, that a run's window leaves
exactly its generations last in the ring."""
from pathlib import Path

import pytest

from fks_tpu_torch.obs import spans
from portbench import harness, ring

ROOT = Path(__file__).resolve().parents[2]
NEW = ("search.overhead_ms_per_gen", "search.overhead_ms_per_gen.flat",
       "flat.round_gap_us", "flat.step_us.window")


@pytest.fixture
def fresh():
    spans.ring().clear()
    yield spans.ring()
    spans.ring().clear()


def gen(seconds, **counters):
    rec = spans.SpanRecord("gen", "gen", "", 0, {})
    rec.seconds = seconds
    rec.counters.update(counters)
    return rec


def fill(r, recs):
    for rec in recs:
        r.append(rec)


def read(name, rec):
    return harness.read_metric(name, rec)


def test_fused_overhead_is_wall_less_engine_time(fresh):
    # a warm-up generation first: the window is the last two
    fill(fresh, [gen(9.0, engine_device_s=1.0),
                 spans.SpanRecord("select", "gen/select", "gen", 1, {}),
                 gen(0.0420, engine_device_s=0.0405),
                 gen(0.0430, engine_device_s=0.0410)])
    rec = {"generations": 2}
    assert read("search.overhead_ms_per_gen", rec) == pytest.approx(1.75)
    assert read("search.overhead_ms_per_gen.flat", rec) == \
        pytest.approx(1.75)
    assert read("flat.round_gap_us", rec) is None  # no replays
    assert read("flat.step_us.window", rec) is None


def test_flat_gap_and_step_time(fresh):
    fill(fresh, [gen(12.0, engine_device_s=11.0, rounds=2001,
                     replays=2000, steps=32000, round_gap_s=0.08),
                 gen(6.0, engine_device_s=5.5, rounds=1001,
                     replays=1000, steps=16000, round_gap_s=0.04)])
    rec = {"generations": 2}
    assert read("flat.round_gap_us", rec) == \
        pytest.approx(1e6 * 0.12 / 3002)
    assert read("flat.step_us.window", rec) == \
        pytest.approx(1e6 * 16.5 / 48000)
    assert read("search.overhead_ms_per_gen.flat", rec) == \
        pytest.approx(1e3 * 1.5 / 2)


def test_none_when_the_ring_lost_a_window_generation(fresh):
    fill(fresh, [gen(1.0, engine_device_s=0.5, rounds=3, replays=2,
                     steps=32, round_gap_s=0.001)])
    rec = {"generations": 2}  # the window ran two; the ring holds one
    for name in NEW:
        assert read(name, rec) is None


def test_none_without_device_times(fresh):
    fill(fresh, [gen(1.0, rounds=3)])  # the CPU: no events
    for name in NEW:
        assert read(name, {"generations": 1}) is None
    # one window generation of two has its device time, the other not
    fill(fresh, [gen(1.0, engine_device_s=0.5, rounds=3, replays=2,
                     steps=32, round_gap_s=0.001), gen(1.0, rounds=3)])
    for name in NEW:
        assert read(name, {"generations": 2}) is None


def test_none_from_nothing_and_from_a_program_without_a_ring(fresh,
                                                             monkeypatch):
    fill(fresh, [gen(1.0, engine_device_s=0.5, rounds=3, replays=2,
                     steps=32, round_gap_s=0.001)])
    for name in NEW:
        assert read(name, {}) is None
        assert read(name, {"generations": 0}) is None
    assert read("flat.step_us.window", {"generations": 1}) is not None
    monkeypatch.delattr(spans, "ring")  # the commit before the ring
    for name in NEW:
        assert read(name, {"generations": 1}) is None


def test_the_window_is_the_last_generations_of_a_run(fresh):
    """A flat run on the CPU, traced: the ring ends with one ``gen`` per
    window generation (the traced replays after the window open no
    span), each with its drain counters; no device time, so no
    metric."""
    line, rec = harness.run_cell(
        ROOT, "openb1213-flat-pop32", 11, 0.2, True, device="cpu",
        overrides={"max_pods": 60, "mix": {"pop": 6, "check_parts": 2,
                                           "trace_replays": 4}})
    assert line["correct"] is True
    gens = [r for r in spans.ring() if r.label == "gen"]
    assert rec["generations"] >= 1 and len(gens) == rec["generations"]
    assert spans.ring()[-1].label == "gen"
    for g in gens:  # eager lane jobs: rounds, and no replay
        assert g.counters["rounds"] > 1 and "replays" not in g.counters
    assert ring.window(rec) is None
    for name in NEW:
        assert name not in line["metrics"]
