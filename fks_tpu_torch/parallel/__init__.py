"""Population-parallel and trace-batched fitness evaluation."""
from fks_tpu_torch.parallel.population import (
    fitness, fused_runner, make_population_eval, occupancy_stats,
    pad_population, pad_stats,
)
from fks_tpu_torch.parallel.traces import (
    make_trace_batch_eval, stack_traces, strip_ids,
)

__all__ = ["fitness", "fused_runner", "make_population_eval",
           "make_trace_batch_eval", "occupancy_stats", "pad_population",
           "pad_stats", "stack_traces", "strip_ids"]
