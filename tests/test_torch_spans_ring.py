"""The port's spans kept in memory (``fks_tpu_torch.obs.spans``): the ring
of closed spans with their paths, parents and bound; start stamps on the
clock of the profiler's host events; no profiler scope without a
profiler and no NVTX range at all; counters summed into every open
span; the drain loop's counters and replay clocks and the fused
launches' events read at ``settle`` (fake CUDA events on the CPU); and
one ``gen`` record per generation of ``ParametricEvolution`` on the
flat engine and on the fused engine's plain path, with its stages.

The CUDA events themselves, and the count of synchronising calls in a
generation, are held on the card by ``tests/test_torch_gpu_spans.py``.
"""
import time

import pytest
import torch

from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
from fks_tpu_torch.models import parametric
from fks_tpu_torch.obs import spans
from fks_tpu_torch.obs.recorder import NullRecorder, recording
from fks_tpu_torch.parallel.mesh import ShardedPopulation, population_mesh
from fks_tpu_torch.sim import engine
from fks_tpu_torch.sim.engine import SimConfig


@pytest.fixture
def ring():
    spans.ring().clear()
    yield spans.ring()
    spans.ring().clear()


# ------------------------------------------------------------------ the ring

def test_records_carry_paths_depths_parents_and_fields(ring):
    with spans.span("gen", generation=3):
        with spans.span("eval"):
            with spans.span("drain"):
                assert spans.span_path() == "gen/eval/drain"
        with spans.span("select"):
            pass
    assert spans.span_path() == "" and not spans.is_open()
    got = [(r.label, r.path, r.depth, r.parent) for r in list(ring)]
    assert got == [("drain", "gen/eval/drain", 2, "gen/eval"),
                   ("eval", "gen/eval", 1, "gen"),
                   ("select", "gen/select", 1, "gen"),
                   ("gen", "gen", 0, "")]
    gen = [r for r in ring if r.label == "gen"][0]
    assert gen.fields == {"generation": 3}
    for r in list(ring):
        assert r.seconds > 0 and r.end_ns >= r.start_ns > 0
        assert gen.start_ns <= r.start_ns and r.end_ns <= gen.end_ns
        assert r.counters == {}


def test_the_ring_keeps_the_last_records(ring):
    # about 1,180 pop-256 fused generations of 6 spans each in 45 s
    assert ring.maxlen == spans.RING_SIZE >= 4 * 1180 * 6
    for i in range(spans.RING_SIZE + 3):
        with spans.span(f"s{i}"):
            pass
    assert len(ring) == spans.RING_SIZE
    assert ring[0].label == "s3"
    assert ring[-1].label == f"s{spans.RING_SIZE + 2}"


def test_a_span_that_raises_still_closes_into_the_ring(ring):
    with pytest.raises(ValueError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise ValueError("x")
    assert [r.path for r in list(ring)] == ["outer/inner", "outer"]
    assert not spans.is_open()


def test_a_timing_is_yielded_and_sync_is_waited_for(ring):
    x = torch.ones(3)
    with spans.span("s", sync=x) as t:
        time.sleep(0.002)
    assert t.seconds >= 0.002
    assert list(ring)[-1].seconds == t.seconds


# ----------------------------------------------------------- the profiler

def test_no_profiler_scope_without_a_profiler_and_no_nvtx(ring,
                                                          monkeypatch):
    entered = []

    class Scope:
        def __init__(self, label):
            entered.append(label)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def nvtx(*a, **k):
        raise AssertionError("a span entered an NVTX range")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Scope)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range", nvtx)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", nvtx)
    with spans.span("a"):
        with spans.span("b"):
            pass
    assert entered == []
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    with spans.span("c"):
        pass
    assert entered == ["c"]


def test_stamps_are_on_the_profiler_clock_and_spans_nest(ring):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("warm_up"):  # the first scope's entry is slow
            pass
        with spans.span("outer_span"):
            torch.ones(64).sum()
            with spans.span("inner_span"):
                torch.ones(64).sum()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in ("outer_span", "inner_span"):
            events[ev.name()] = (ev.start_ns(),
                                 ev.start_ns() + ev.duration_ns())
    recs = {r.label: r for r in list(ring)}
    assert set(events) == {"outer_span", "inner_span"}
    for name in events:
        start, end = events[name]
        rec = recs[name]
        assert abs(rec.start_ns - start) < 1_000_000
        assert abs(rec.end_ns - end) < 1_000_000
    (o0, o1), (i0, i1) = events["outer_span"], events["inner_span"]
    assert o0 <= i0 and i1 <= o1
    assert recs["outer_span"].start_ns <= recs["inner_span"].start_ns
    assert recs["inner_span"].end_ns <= recs["outer_span"].end_ns


# ------------------------------------------------------ counters and events

def test_counters_sum_into_every_open_span(ring):
    spans.add(rounds=5)  # no span open: dropped
    with spans.span("gen"):
        with spans.span("eval"):
            spans.add(rounds=2, steps=32)
            spans.add(rounds=1)
        with spans.span("select"):
            pass
    recs = {r.label: r for r in list(ring)}
    assert recs["eval"].counters == {"rounds": 3, "steps": 32}
    assert recs["gen"].counters == {"rounds": 3, "steps": 32}
    assert recs["select"].counters == {}


class FakeEvent:
    """A CUDA event on a fake device clock: ``record`` stamps the clock's
    time, ``query`` says whether the clock has passed it."""

    clock = {"now": 0.0, "done": float("inf")}
    log = []
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        self.made.append(self)

    def record(self, stream=None):
        self.t = self.clock["now"]
        self.log.append(("record", self.t))

    def query(self):
        return self.t is not None and self.t <= self.clock["done"]

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before completion"
        self.log.append(("read", self.t, end.t))
        return end.t - self.t


class FakeStream:
    device_index = 0


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.clock.update(now=0.0, done=float("inf"))
    FakeEvent.log.clear()
    FakeEvent.made.clear()
    return FakeEvent


def test_fused_launch_events_are_read_at_settle_only(ring, fake_events):
    clock = fake_events.clock
    pop = ShardedPopulation(synthetic_workload(4, 24, seed=3),
                            population_mesh(["cpu"]), parametric.score,
                            SimConfig(track_ctime=False), "fused")
    plain = pop.runners[0]
    got = []

    def run(params, events=None):  # the plain run, with a 40 ms launch
        got.append(events)
        if events is not None:
            start = spans.device_event(FakeStream())
            clock["now"] += 40.0
            events.append((start, spans.device_event(FakeStream())))
        return plain(params)

    pop.runners = [run]
    params = parametric.init_population(torch.Generator().manual_seed(0),
                                        4)
    pop(params)  # no span open: no events
    assert got == [None] and pop.launches is None
    with spans.span("gen"):
        clock["done"] = -1.0  # nothing completes yet
        pop(params)
        assert len(pop.launches) == 1 and fake_events.log == [
            ("record", 0.0), ("record", 40.0)]
        clock["done"] = 40.0  # the read-back's synchronisation
        pop.settle()
        assert pop.launches is None
        pop.settle()  # read once
    recs = {r.label: r for r in list(ring)}
    # the plain run's drain counts its rounds; the launch span closed
    # before its events were read
    assert recs["gen"].counters["engine_device_s"] == 0.04
    assert "engine_device_s" not in recs["launch"].counters


class FakeGraphedJob:
    """A graphed ``LaneJob`` stand-in: each replay takes 5 ms of device
    time; each flag read completes the stream and wakes the host 0.25
    ms later. Its two lanes are active in every step it runs."""

    def __init__(self, replays, clock, steps=16, stream=None):
        self.left = replays
        self.ran = 0
        self.clock = clock
        self.chunk = type("Chunk", (), {"steps": steps,
                                        "kernel_step": False})()
        self.stream = FakeStream() if stream is None else stream

    def active(self):
        return self.left > 0

    def read(self, flag):
        self.clock["done"] = self.clock["now"]
        self.clock["now"] += 0.25
        return flag

    def advance(self):
        FakeEvent.log.append(("advance",))
        self.left -= 1
        self.ran += self.chunk.steps
        self.clock["now"] += 5.0

    def lane_steps(self):
        return 2 * self.ran

    def lane_slots(self):
        return 4 * self.ran


def test_drain_counts_replays_gaps_and_device_time(ring, fake_events):
    job = FakeGraphedJob(4, fake_events.clock)
    with spans.span("drain"):
        engine.drain([job])
    c = list(ring)[-1].counters
    assert c == {"rounds": 5, "replays": 4, "steps": 64, "lane_steps": 128,
                 "lane_slots": 256,
                 "engine_device_s": pytest.approx(4 * 5e-3),
                 "round_gap_s": pytest.approx(3 * 0.25e-3)}
    # each round's replays are read after the next round's are queued,
    # and nothing is read before a flag read has completed it
    log = [x[0] for x in fake_events.log]
    assert log[:4] == ["record", "advance", "record", "record"]
    first_read = log.index("read")
    assert log[:first_read].count("advance") == 2
    assert len(fake_events.made) == 8  # two a replay


def test_drain_measures_the_gap_once_a_round_per_stream(ring, fake_events):
    """Two jobs on one stream replay back to back: the gap runs from a
    round's last replay to the next round's first, never across the
    other job's replay."""
    clock, stream = fake_events.clock, FakeStream()
    jobs = [FakeGraphedJob(3, clock, stream=stream),
            FakeGraphedJob(2, clock, stream=stream)]
    with spans.span("drain"):
        engine.drain(jobs)
    c = list(ring)[-1].counters
    assert c["rounds"] == 4 and c["replays"] == 5
    assert c["engine_device_s"] == pytest.approx(5 * 5e-3)
    # rounds 2 and 3 each begin with two flag reads of 0.25 ms
    assert c["round_gap_s"] == pytest.approx(2 * 0.5e-3)


def test_drain_takes_no_events_with_no_span_open(ring, fake_events):
    engine.drain([FakeGraphedJob(3, fake_events.clock)])
    assert [x[0] for x in fake_events.log] == ["advance"] * 3
    assert len(ring) == 0


# ----------------------------------------------------- the generation loop

@pytest.mark.parametrize("eng", ["flat", "fused"])
def test_one_gen_record_per_generation_with_its_stages(ring, eng,
                                                       monkeypatch):
    advances = []
    advance = engine.LaneJob.advance
    monkeypatch.setattr(engine.LaneJob, "advance",
                        lambda job: advances.append(1) or advance(job))
    wl = synthetic_workload(4, 24, seed=3)
    pe = ParametricEvolution(wl, pop_size=6, elite_k=2, engine=eng,
                             cfg=SimConfig(track_ctime=False), device="cpu")
    advances.clear()
    pe.run(3)
    gens = [r for r in ring if r.label == "gen"]
    assert len(gens) == 3
    stages = {r.path for r in list(ring) if r.depth == 1}
    assert stages == {"gen/seed", "gen/eval", "gen/select", "gen/readback"}
    evals = {r.path for r in list(ring) if r.depth == 2}
    if eng == "flat":
        assert evals == {"gen/eval/start", "gen/eval/drain",
                         "gen/eval/finish"}
    else:
        assert evals == {"gen/eval/launch"}
    for g in gens:  # no events on the CPU
        assert set(g.counters) == {"rounds", "lane_steps", "lane_slots"}
        assert 0 < g.counters["lane_steps"] <= g.counters["lane_slots"]
    # one eager lane job a generation: the last round reads its flag off
    assert sum(g.counters["rounds"] for g in gens) == len(advances) + 3
    for a, b in zip(gens, gens[1:]):
        assert a.end_ns <= b.start_ns


def test_recorder_events_keep_fks_tpu_fields(ring):
    class Capture(NullRecorder):
        enabled = True

        def __init__(self):
            self.rows = []

        def event(self, kind, **fields):
            self.rows.append((kind, fields))

    wl = synthetic_workload(4, 24, seed=3)
    pe = ParametricEvolution(wl, pop_size=4, elite_k=2, engine="flat",
                             cfg=SimConfig(track_ctime=False), device="cpu")
    rec = Capture()
    with recording(rec):
        pe.run(1)
    rows = [(k, f) for k, f in rec.rows if k == "span"]
    assert [f["path"] for _, f in rows] == [r.path for r in list(ring)]
    for _, f in rows:
        assert set(f) == {"label", "path", "depth", "seconds"}
