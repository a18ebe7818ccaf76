"""Observability: the recorder seam and the run-directory flight
recorder, spans, causal trace contexts, the evolution ledger, the stage
profiler (``profiler``: per-stage wall / capture / compute attribution),
the graph-capture counter (``watch_compiles``), and the decision-trace
tools (``obs.tracing``) and the serve-side and memory modules
(``history``, ``workload``, ``watchdog``, ``memory``, ``layout``) and
``report`` (``read_jsonl``, ``load_run`` and the memory view), imported
on their own.

Port of the parts of fks_tpu.obs that the engines, the evolve loop,
serving, the control plane and the run commands use. With the shared
``NullRecorder`` active (the default) nothing is written anywhere;
``FlightRecorder`` writes fks_tpu's run directory. The rendered report,
the exporters and the cross-run comparison are fks_tpu's alone so far.
"""
from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.obs.ledger import EvolutionLedger
from fks_tpu_torch.obs.profiler import NULL_PROFILER, StageProfiler
from fks_tpu_torch.obs.recorder import (
    NULL, FlightRecorder, NullRecorder, get_recorder, recording,
)
from fks_tpu_torch.obs.spans import span, span_path
from fks_tpu_torch.obs.telemetry import CompileWatcher, watch_compiles

__all__ = ["CompileWatcher", "EvolutionLedger", "FlightRecorder", "NULL",
           "NULL_PROFILER", "NullRecorder", "StageProfiler", "get_recorder",
           "recording", "span", "span_path", "trace_ctx", "watch_compiles"]
