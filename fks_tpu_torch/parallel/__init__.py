"""Population-parallel, trace-batched and mesh-sharded fitness evaluation.

Port of fks_tpu.parallel: populations as lanes of one batched run
(``population``), traces stacked on a trace axis (``traces``), and the
candidate axis sharded over a device mesh with gathered elite ranking
(``mesh``).
"""
from fks_tpu_torch.parallel.population import (
    fitness, fused_runner, lead_axis_size, make_population_eval,
    make_single_run, occupancy_stats, pad_population, pad_stats,
)
from fks_tpu_torch.parallel.mesh import (
    DCN_AXIS, POP_AXIS, SCN_AXIS, Mesh, hybrid_population_mesh,
    init_distributed, layout_mesh, make_sharded_code_eval,
    make_sharded_eval, make_sharded_generation_step,
    make_sharded_portfolio_serve_fn, make_sharded_serve_fn,
    make_sharded_vm_serve_fn, num_shards, population_mesh,
    serve_lane_count, serve_sharding, shard_population,
)
from fks_tpu_torch.parallel.traces import (
    make_trace_batch_eval, stack_traces, strip_ids,
)

__all__ = ["DCN_AXIS", "Mesh", "POP_AXIS", "SCN_AXIS", "fitness",
           "fused_runner", "hybrid_population_mesh", "init_distributed",
           "layout_mesh", "lead_axis_size", "make_population_eval",
           "make_sharded_code_eval", "make_sharded_eval",
           "make_sharded_generation_step",
           "make_sharded_portfolio_serve_fn", "make_sharded_serve_fn",
           "make_sharded_vm_serve_fn", "make_single_run",
           "make_trace_batch_eval", "num_shards", "occupancy_stats",
           "pad_population", "pad_stats", "population_mesh",
           "serve_lane_count", "serve_sharding", "shard_population",
           "stack_traces", "strip_ids"]
