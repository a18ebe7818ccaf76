"""Champion serving: pinned champion -> warm, capture-free query engine.

Port of fks_tpu.serve:

- artifact: champion loading, shape envelope, ``ServeEngine`` (one
  captured CUDA graph per (lane bucket, pod bucket)), save/load in
  fks_tpu's artifact format;
- vm_engine: the VM-native ``VMServeEngine`` — champion-as-data graphs
  shared across champions, zero-capture ``swap_program`` hot-swap;
- batcher: query->workload construction, lane stacking, packed-upload
  helpers (query AND program tables), the request coalescer;
- service: request/metrics layer, JSONL + localhost HTTP fronts,
  selftest.

Every engine takes ``mesh=`` (``parallel.mesh.Mesh``) to shard its lane
axis; ``fks_tpu_torch.portfolio`` serves several champions from one set of
graphs.
"""
from fks_tpu_torch.serve.artifact import (
    ChampionSpec, ServeEngine, ShapeEnvelope, enable_persistent_cache,
    latest_champion, load_champion,
)
from fks_tpu_torch.serve.batcher import (
    DEFAULT_DURATION, POD_FIELDS, RequestBatcher, build_query_workload,
    pack_program_tables, pack_query_tables, pods_to_dicts, query_pack_plan,
    stack_queries, stack_query_tables, tree_h2d_bytes,
    unpack_program_tables, unpack_query_tables, validate_query_pods,
)
from fks_tpu_torch.serve.service import (
    ServeService, make_http_server, selftest,
)
from fks_tpu_torch.serve.vm_engine import VMServeEngine

__all__ = [
    "ChampionSpec", "ServeEngine", "ShapeEnvelope", "VMServeEngine",
    "enable_persistent_cache", "latest_champion", "load_champion",
    "DEFAULT_DURATION", "POD_FIELDS", "RequestBatcher",
    "build_query_workload", "pack_program_tables", "pack_query_tables",
    "pods_to_dicts", "query_pack_plan", "stack_queries",
    "stack_query_tables", "tree_h2d_bytes", "unpack_program_tables",
    "unpack_query_tables", "validate_query_pods",
    "ServeService", "make_http_server", "selftest",
]
