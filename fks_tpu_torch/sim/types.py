"""Simulation-facing views and state, batched over lanes.

Port of fks_tpu.sim.types. Where fks_tpu vmaps a per-lane function, the
port writes the lane axis out: every per-lane quantity carries a leading
``[L]`` dimension.

- ``PodView`` fields are ``[L, 1]`` columns, so they broadcast against
  ``[L, N]`` node arrays (``[..., None]`` adds the GPU axis).
- ``NodeView`` "left" fields are per lane (``[L, N]``, ``[L, N, G]``);
  capacity fields are shared by all lanes (``[N]``, ``[N, G]``), or per
  lane (``[L, N]``, ``[L, N, G]``) when stacked traces with different
  clusters share one step (``parallel.traces``).

A policy scores one pod against every node of every lane:
``policy(PodView, NodeView) -> i32[L, N]``; 0 means "cannot/refuse".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from fks_tpu_torch.ops.heap import EventHeap


class PodView(NamedTuple):
    """The pod being scheduled in each lane, as ``[L, 1]`` columns."""

    cpu_milli: torch.Tensor
    memory_mib: torch.Tensor
    num_gpu: torch.Tensor
    gpu_milli: torch.Tensor
    creation_time: torch.Tensor  # as mutated by retries
    duration_time: torch.Tensor


class NodeView(NamedTuple):
    """Per-node state: ``*_left`` per lane; totals and masks shared, or
    with a leading lane axis when the lanes' clusters differ."""

    cpu_milli_left: torch.Tensor  # i32[L, N]
    cpu_milli_total: torch.Tensor  # i32[N] or [L, N]
    memory_mib_left: torch.Tensor  # i32[L, N]
    memory_mib_total: torch.Tensor  # i32[N] or [L, N]
    gpu_left: torch.Tensor  # i32[L, N] (starts at the declared count)
    num_gpus: torch.Tensor  # i32[N] or [L, N]
    gpu_milli_left: torch.Tensor  # i32[L, N, G]
    gpu_milli_total: torch.Tensor  # i32[N, G] or [L, N, G]
    gpu_mem_total: torch.Tensor  # i32[N, G] or [L, N, G]
    gpu_mask: torch.Tensor  # bool[N, G] or [L, N, G]
    node_mask: torch.Tensor  # bool[N] or [L, N]


PolicyFn = Callable[[PodView, NodeView], torch.Tensor]  # -> i32[L, N]


# decision-trace event kinds (TraceBuffer.COL_KIND). RETRY is a creation
# attempt of a pod that already failed at least once; NODE_DOWN / NODE_UP
# are scenario fault events (pod column -1, node column the node, score
# and margin 0)
TRACE_CREATE = 0
TRACE_DELETE = 1
TRACE_RETRY = 2
TRACE_NODE_DOWN = 3
TRACE_NODE_UP = 4
TRACE_KIND_NAMES = ("CREATE", "DELETE", "RETRY", "NODE_DOWN", "NODE_UP")


@dataclasses.dataclass
class TraceBuffer:
    """The decision trace of L lanes (``SimConfig.decision_trace``;
    fks_tpu.sim.types.TraceBuffer with the lane axis written out): one row
    per processed event, in step order. Integer observables are the
    columns of ``data``, the winning score and the second-best margin are
    ``scores`` in the score dtype. Rows are comparable across engines: pod
    ids are input order (the flat engine un-permutes its slots) and
    deletes record score and margin 0.

    Row ``T`` is a scratch row, as the heap's row ``cap``: PyTorch has no
    drop-mode scatter, so an inactive lane or a full buffer writes there,
    and no reader counts it. ``count`` saturates at ``T``."""

    data: torch.Tensor  # i32[L, T + 1, 8], columns below
    scores: torch.Tensor  # f[L, T + 1, 2]: (winning score, margin)
    count: torch.Tensor  # i32[L] rows written

    COL_KIND = 0  # TRACE_*
    COL_POD = 1  # input-order pod id (-1 on fault rows)
    COL_NODE = 2  # chosen node (-1 = none); held node on DELETE
    COL_PENDING = 3  # post-step pending event count (faults included)
    COL_FREE_CPU = 4  # post-step cluster-wide free aggregates
    COL_FREE_MEM = 5
    COL_FREE_GPU = 6
    COL_FREE_GPU_MILLI = 7

    @property
    def length(self) -> int:
        """``T``, the rows a lane can hold."""
        return int(self.data.shape[-2]) - 1


def empty_trace(lanes: int, length: int, score_dtype=torch.float32,
                device="cpu") -> TraceBuffer:
    """An all-zero ``TraceBuffer`` of ``lanes`` lanes x ``length`` rows."""
    return TraceBuffer(
        data=torch.zeros((lanes, length + 1, 8), dtype=torch.int32,
                         device=device),
        scores=torch.zeros((lanes, length + 1, 2), dtype=score_dtype,
                           device=device),
        count=torch.zeros(lanes, dtype=torch.int32, device=device))


@dataclasses.dataclass
class FlatState:
    """The flat engine's carry for L lanes: a slot-per-pod event queue in
    tie-rank order plus cluster and evaluator state (fks_tpu.sim.types.
    FlatState with the lane axis written out). Per-pod arrays are in SLOT
    order; finalize un-permutes them. The flat step updates ``ev_time``,
    ``aux``, ``aux_gpus``, ``pod_ctime`` and ``wait_hist`` in place."""

    ev_time: torch.Tensor  # i32[L, Q]; INF = no pending event
    # -1 fresh CREATE pending, -2 waiting, >= 0 placed: (node << G) | bits
    # when packable, else the node index with bits in aux_gpus
    aux: torch.Tensor  # i32[L, Q]
    aux_gpus: Optional[torch.Tensor]  # i64[L, Q] bitmask, None when packed
    pending: torch.Tensor  # i32[L] live-slot count
    cpu_left: torch.Tensor  # i32[L, N]
    mem_left: torch.Tensor  # i32[L, N]
    gpu_left: torch.Tensor  # i32[L, N]
    gpu_milli_left: torch.Tensor  # i32[L, N, G]
    pod_ctime: torch.Tensor  # i32[L, Q] creation time, retry-mutated
    wait_hist: torch.Tensor  # i32[L, H] gpu_milli histogram of waiting pods
    events_processed: torch.Tensor  # i32[L]
    snap_idx: torch.Tensor  # i32[L]
    snap_sums: torch.Tensor  # f[L, 4]
    frag_sum: torch.Tensor  # f[L]
    frag_count: torch.Tensor  # i32[L]
    max_nodes: torch.Tensor  # i32[L]
    failed: torch.Tensor  # bool[L]
    steps: torch.Tensor  # i32[L]
    violations: torch.Tensor  # i32[L] invariant-audit failures
    numeric_flags: torch.Tensor  # i32[L] watchdog bitmask (sim.guards)
    trace: Optional[TraceBuffer] = None  # unless SimConfig.decision_trace
    # the fault queue, unless the workload carries FaultEvents: each
    # event's time, INF once consumed; and each node's cordon bit
    fault_time: Optional[torch.Tensor] = None  # i32[L, F]
    node_avail: Optional[torch.Tensor] = None  # bool[L, N]

    @property
    def lanes(self) -> int:
        return int(self.ev_time.shape[0])


@dataclasses.dataclass
class SimState:
    """The exact engine's carry for L lanes (fks_tpu.sim.types.SimState
    with the lane axis written out): the heap replica plus cluster and
    evaluator state.

    Per-pod scheduling state lives as the columns of one ``i32[L, P, 4]``
    matrix, in input order, so an event reads and writes its pod with one
    row gather and one row scatter: (assigned node, GPU bitmask bit-cast
    to int32, retry-mutated creation time, waiting flag). The exact step
    updates ``heap.data``, ``pod_state`` and ``wait_hist`` in place."""

    heap: EventHeap
    cpu_left: torch.Tensor  # i32[L, N]
    mem_left: torch.Tensor  # i32[L, N]
    gpu_left: torch.Tensor  # i32[L, N]
    gpu_milli_left: torch.Tensor  # i32[L, N, G]
    pod_state: torch.Tensor  # i32[L, P, 4] (see class docstring)
    wait_hist: torch.Tensor  # i32[L, H] gpu_milli histogram of waiting pods
    events_processed: torch.Tensor  # i32[L]
    snap_idx: torch.Tensor  # i32[L]
    snap_sums: torch.Tensor  # f[L, 4]
    frag_sum: torch.Tensor  # f[L]
    frag_count: torch.Tensor  # i32[L]
    max_nodes: torch.Tensor  # i32[L]
    failed: torch.Tensor  # bool[L]
    steps: torch.Tensor  # i32[L]
    violations: torch.Tensor  # i32[L] invariant-audit failures
    numeric_flags: torch.Tensor  # i32[L] watchdog bitmask (sim.guards)
    trace: Optional[TraceBuffer] = None  # unless SimConfig.decision_trace
    # each node's cordon bit, unless the workload carries FaultEvents
    node_avail: Optional[torch.Tensor] = None  # bool[L, N]

    # pod_state column indices
    COL_NODE = 0
    COL_BITS = 1
    COL_CTIME = 2
    COL_WAIT = 3

    @property
    def lanes(self) -> int:
        return int(self.cpu_left.shape[0])

    @property
    def assigned_node(self) -> torch.Tensor:  # i32[L, P], -1 = unassigned
        return self.pod_state[..., SimState.COL_NODE]

    @property
    def assigned_gpus(self) -> torch.Tensor:  # i64[L, P] bitmask over G
        return (self.pod_state[..., SimState.COL_BITS].to(torch.int64)
                & 0xFFFFFFFF)

    @property
    def pod_ctime(self) -> torch.Tensor:  # i32[L, P], mutated on retry
        return self.pod_state[..., SimState.COL_CTIME]

    @property
    def waiting(self) -> torch.Tensor:  # bool[L, P] waiting-set membership
        return self.pod_state[..., SimState.COL_WAIT] != 0


@dataclasses.dataclass
class SimResult:
    """Final observables of L lanes (fks_tpu.sim.types.SimResult with a
    leading lane axis on every field)."""

    policy_score: torch.Tensor
    avg_cpu_utilization: torch.Tensor
    avg_memory_utilization: torch.Tensor
    avg_gpu_count_utilization: torch.Tensor
    avg_gpu_memory_utilization: torch.Tensor
    gpu_fragmentation_score: torch.Tensor
    num_snapshots: torch.Tensor
    num_fragmentation_events: torch.Tensor
    events_processed: torch.Tensor
    scheduled_pods: torch.Tensor
    max_nodes: torch.Tensor
    assigned_node: torch.Tensor  # i32[L, P]
    assigned_gpus: torch.Tensor  # i64[L, P] bitmask
    pod_ctime: torch.Tensor  # i32[L, P]
    cpu_left: torch.Tensor  # i32[L, N]
    mem_left: torch.Tensor
    gpu_left: torch.Tensor
    gpu_milli_left: torch.Tensor  # i32[L, N, G]
    failed: torch.Tensor  # bool[L]
    truncated: torch.Tensor  # bool[L]
    invariant_violations: torch.Tensor  # i32[L] (0 unless validate_invariants)
    # i32[L] watchdog bitmask (sim.guards.FLAG_*; 0 unless SimConfig.watchdog)
    numeric_flags: torch.Tensor
    trace: Optional[TraceBuffer] = None  # unless SimConfig.decision_trace

    def lane(self, i: int) -> "SimResult":
        """The result of lane ``i`` alone (leading axis dropped)."""
        return map_tensors(lambda x: x[i], self)


def map_tensors(fn, obj):
    """A copy of ``obj`` with ``fn`` applied to every tensor: a tensor, a
    NamedTuple of tensors (a policy's params, e.g. ``funsearch.vm.
    VMProgram``) or a dataclass of tensors, nested ones included; None
    stays None."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(fn, v) for v in obj))
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v) or isinstance(v, torch.Tensor) or (
                isinstance(v, tuple) and hasattr(v, "_fields")):
            v = map_tensors(fn, v)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


def tensor_leaves(obj):
    """Every tensor of ``obj`` (as ``map_tensors`` visits them), in
    order."""
    out = []
    map_tensors(lambda x: out.append(x) or x, obj)
    return out


def batch_size(params) -> int:
    """The lane count of a population's params: the leading size of its
    first tensor (a weight matrix ``[P, F]`` or a stacked program)."""
    return int(tensor_leaves(params)[0].shape[0])


def as_params(params):
    """A population's params as tensors: a NamedTuple of tensors (a
    stacked program) as it is, anything else through ``torch.as_tensor``
    (weight matrices may arrive as numpy)."""
    if isinstance(params, tuple) and hasattr(params, "_fields"):
        return params
    return torch.as_tensor(params)


def clone_tensors(obj):
    """A copy of ``obj`` with every tensor cloned."""
    return map_tensors(torch.clone, obj)


def copy_tensors_(dst, src) -> None:
    """Write every tensor of ``src`` into the same-shaped ``dst`` (a
    captured graph's static state or params)."""
    for a, b in zip(tensor_leaves(dst), tensor_leaves(src)):
        if a is not b:
            a.copy_(b)
