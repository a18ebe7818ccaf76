"""The generation WAL and the evolve loop's other host records, against
fks_tpu's, on the CPU.

``resilience.GenerationWAL`` writes byte-identical records, so a WAL
written by either package replays in the other (torn tails included).
The ledger rows, spans (with and without a causal trace context), the
trace-context reconstruction and the timing helpers match fks_tpu's.
"""
import dataclasses

import pytest
import torch

from fks_tpu.obs import ledger as jledger
from fks_tpu.obs import spans as jspans
from fks_tpu.obs import trace_ctx as jtrace_ctx
from fks_tpu.obs.recorder import recording as jrecording
from fks_tpu.resilience.wal import GenerationWAL as JaxWAL
from fks_tpu_torch import obs
from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.obs.recorder import recording
from fks_tpu_torch.resilience import GenerationWAL
from fks_tpu_torch.utils import profiling
from tests.test_torch_evolution import Capture, JaxCapture


@dataclasses.dataclass
class Rec:
    code: str
    score: float
    error: object = None
    scenario_scores: object = None
    aggregation: object = None
    budget_rung: object = None


def write(wal_cls, path):
    wal = wal_cls(path)
    wal.record_codes(3, ["score = 1", "score = 2"])
    wal.record_eval(3, Rec("score = 1", 0.5))
    wal.record_eval(3, Rec("score = 2", 0.0, "runtime: boom", [0.1, 0.2],
                           "cvar", 0))
    wal.commit(3)
    wal.record_codes(4, ["score = 3"])
    return wal


def test_records_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    write(GenerationWAL, a)
    write(JaxWAL, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("writer,reader", [(JaxWAL, GenerationWAL),
                                           (GenerationWAL, JaxWAL)])
def test_a_wal_replays_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "wal.jsonl")
    write(writer, path)
    with open(path, "a") as f:
        f.write('{"kind": "eval", "generation": 4, "ke')  # kill mid-write
    wal = reader(path)
    ref = writer(path)
    assert wal.skipped_lines == ref.skipped_lines == 1
    assert wal.summary() == ref.summary()
    assert wal.committed(3) and wal.pending_codes(3) is None
    assert wal.pending_codes(4) == ref.pending_codes(4) == ["score = 3"]
    assert wal.cached_evals(4) == ref.cached_evals(4) == {}
    wal.commit(4)  # the repaired append stays its own parseable line
    assert writer(path).committed(4)
    assert GenerationWAL.code_key("x") == JaxWAL.code_key("x")


@dataclasses.dataclass
class Stats:
    generation: int
    best_score: float
    new_candidates: int
    eval_seconds: float


class Evaluator:
    compile_count = 1
    vm_count = 4
    vm_batch_count = 1
    segments_dispatched = 0
    preflight_rejected = 2
    preflight_duplicates = 1


def test_ledger_rows_equal_fks_tpu():
    rec, jrec = Capture(), JaxCapture()
    ev, jev = Evaluator(), Evaluator()
    led = obs.EvolutionLedger(rec, ev)
    jled = jledger.EvolutionLedger(jrec, jev)
    led.begin_generation()
    jled.begin_generation()
    for e in (ev, jev):
        e.vm_count, e.vm_batch_count = 9, 2
    st = Stats(1, 0.5, 5, 2.0)
    assert led.commit(st) == jled.commit(st)
    assert rec.rows == jrec.rows
    assert rec.rows[0][2]["vm_candidates"] == 5
    assert rec.rows[0][2]["evals_per_sec"] == 2.5


class EnabledCapture(Capture):
    enabled = True


class JaxEnabledCapture(JaxCapture):
    enabled = True


def _shape(rows):
    """Rows with their ids and clocks dropped (they are random/timed)."""
    drop = ("seconds", "trace_id", "span_id", "parent_id")
    return [(k, n, {f: v for f, v in r.items() if f not in drop})
            for k, n, r in rows]


def test_spans_and_trace_spans_equal_fks_tpu():
    for with_ctx in (False, True):
        rec, jrec = EnabledCapture(), JaxEnabledCapture()
        with recording(rec), jrecording(jrec):
            ctx = trace_ctx.new_trace("gen") if with_ctx else None
            jctx = jtrace_ctx.new_trace("gen") if with_ctx else None
            with trace_ctx.activate(ctx), jtrace_ctx.activate(jctx):
                with obs.span("evaluate", generation=1) as t:
                    with obs.span("vm_batch", lanes=4):
                        assert obs.span_path() == "evaluate/vm_batch"
                        t.sync(torch.ones(2))
                with jspans.span("evaluate", generation=1):
                    with jspans.span("vm_batch", lanes=4):
                        assert jspans.span_path() == "evaluate/vm_batch"
        assert _shape(rec.rows) == _shape(jrec.rows)
        kinds = {r[1] for r in rec.rows}
        assert kinds == ({"trace_span"} if with_ctx else {"span"})
        if with_ctx:  # the inner span is the outer one's child
            inner, outer = rec.rows[0][2], rec.rows[1][2]
            assert inner["parent_id"] == outer["span_id"]
            assert outer["parent_id"] == ctx.span_id
        assert t.seconds > 0


def test_trace_reconstruction_equals_fks_tpu():
    rows = [
        {"kind": "trace_span", "trace_id": "t", "span_id": "r",
         "parent_id": None, "path": "generation", "seconds": 4.0, "ts": 10},
        {"kind": "trace_span", "trace_id": "t", "span_id": "a",
         "parent_id": "r", "path": "generation/llm", "seconds": 1.0,
         "ts": 7},
        {"kind": "trace_span", "trace_id": "t", "span_id": "b",
         "parent_id": "r", "path": "generation/evaluate", "seconds": 2.5,
         "ts": 9.5},
        {"kind": "span", "path": "x"},
    ]
    spans = trace_ctx.trace_spans(rows)
    assert spans == jtrace_ctx.trace_spans(rows)
    assert trace_ctx.critical_path(spans) == jtrace_ctx.critical_path(spans)
    assert trace_ctx.render_waterfall(spans) == \
        jtrace_ctx.render_waterfall(spans)
    assert trace_ctx.waterfall_complete(spans, ("llm",)) is \
        jtrace_ctx.waterfall_complete(spans, ("llm",))


def test_timing_helpers():
    calls = []
    with profiling.timed("x", on_exit=calls.append) as t:
        t.sync({"a": [torch.zeros(3)], "b": (None, 1)})
    assert calls == [t] and t.seconds > 0 and t.label == "x"
    out, secs = profiling.block_timed(lambda: torch.arange(4))
    assert out.tolist() == [0, 1, 2, 3] and secs >= 0
    assert profiling._cuda_devices(torch.zeros(1), set()) == set()


def test_null_profiler_is_inert():
    with obs.NULL_PROFILER.stage("codegen", generation=1) as h:
        h.annotate(lanes=3)
        assert h.sync(5) == 5
    obs.NULL_PROFILER.segment_tick()
    assert obs.NULL_PROFILER.records == []
    # the enabled profiler records stages
    rows = Capture()
    prof = obs.StageProfiler(enabled=True, recorder=rows)
    with prof.stage("codegen", generation=1) as h:
        h.annotate(lanes=3)
        assert h.sync(5) == 5
    prof.close()
    assert [r["stage"] for r in prof.records] == ["codegen"]
    assert prof.records[0]["lanes"] == 3
    assert [k for _, k, _ in rows.rows] == ["device_profile"]
    from fks_tpu_torch.utils.logging import get_logger
    assert get_logger("x").name == "fks_tpu_torch.x"
