"""Observability: the recorder seam and the run-directory flight
recorder, spans, causal trace contexts, the evolution ledger, the stage
profiler (``profiler``: per-stage wall / capture / compute attribution),
the graph-capture counter (``watch_compiles``), and the read-back layer
over run directories: the rendered report (``report``), OpenMetrics
export and heartbeat liveness (``exporter``), cross-run regression
gating (``compare``), the run history with its trends, auto baselines
and SLO burn rates (``history``), and the layout ledger with its
roll-up and measured explorer (``layout``). The decision-trace tools
(``obs.tracing``) and the serve-side and memory modules (``workload``,
``watchdog``, ``memory``) are imported on their own.

Port of fks_tpu.obs. With the shared ``NullRecorder`` active (the
default) nothing is written anywhere; ``FlightRecorder`` writes
fks_tpu's run directory, and the read-back modules render either
package's run directories to fks_tpu's text.
"""
from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.obs.compare import (
    DEFAULT_THRESHOLDS, Threshold, compare_runs, extract_metrics,
    format_comparison, has_regression, parse_threshold_overrides,
)
from fks_tpu_torch.obs.exporter import (
    health_line, run_health, to_openmetrics, watch,
)
from fks_tpu_torch.obs.history import (
    RunHistory, SLOConfig, record_slo_burn, resolve_auto_baseline, slo_burn,
)
from fks_tpu_torch.obs.layout import (
    LAYOUT_AXES, LAYOUT_COMPONENTS, LayoutLedger, LayoutSpec, default_spec,
    explore_layouts, parse_layout_key, record_layout, rollup_layouts,
    tag_layout, valid_layouts,
)
from fks_tpu_torch.obs.ledger import EvolutionLedger
from fks_tpu_torch.obs.profiler import (
    NULL_PROFILER, StageProfiler, profile_launch,
)
from fks_tpu_torch.obs.recorder import (
    NULL, FlightRecorder, NullRecorder, get_recorder, recording,
)
from fks_tpu_torch.obs.report import render_report, sparkline
from fks_tpu_torch.obs.spans import span, span_path
from fks_tpu_torch.obs.telemetry import CompileWatcher, watch_compiles

__all__ = ["CompileWatcher", "DEFAULT_THRESHOLDS", "EvolutionLedger",
           "FlightRecorder", "LAYOUT_AXES", "LAYOUT_COMPONENTS",
           "LayoutLedger", "LayoutSpec", "NULL", "NULL_PROFILER",
           "NullRecorder", "RunHistory", "SLOConfig", "StageProfiler",
           "Threshold", "compare_runs", "default_spec", "explore_layouts",
           "extract_metrics", "format_comparison", "get_recorder",
           "has_regression", "health_line", "parse_layout_key",
           "parse_threshold_overrides", "profile_launch", "record_layout",
           "record_slo_burn", "recording", "render_report",
           "resolve_auto_baseline", "rollup_layouts", "run_health",
           "slo_burn", "span", "span_path", "sparkline", "tag_layout",
           "to_openmetrics", "trace_ctx", "valid_layouts", "watch",
           "watch_compiles"]
