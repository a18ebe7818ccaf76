"""Observability: the recorder seam, spans, causal trace contexts, the
evolution ledger, the disabled stage profiler and the decision-trace
tools (``obs.tracing``, imported on its own).

Port of the parts of fks_tpu.obs that the engines and the evolve loop
use. With the shared ``NullRecorder`` active (the default) nothing is
written anywhere; the run-directory flight recorder, telemetry, reports
and exporters wait for the rest of ``obs/`` (ROADMAP queue 1 item 6).
"""
from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.obs.ledger import EvolutionLedger
from fks_tpu_torch.obs.profiler import NULL_PROFILER, StageProfiler
from fks_tpu_torch.obs.recorder import (
    NULL, NullRecorder, get_recorder, recording,
)
from fks_tpu_torch.obs.spans import span, span_path

__all__ = ["EvolutionLedger", "NULL", "NULL_PROFILER", "NullRecorder",
           "StageProfiler", "get_recorder", "recording", "span",
           "span_path", "trace_ctx"]
