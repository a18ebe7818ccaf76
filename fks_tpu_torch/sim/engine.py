"""The exact heap engine, and the pieces every engine shares.

Port of fks_tpu.sim.engine, the lane axis written out. The shared half —
``SimConfig``, ``loop_tables``, ``_node_view``, ``_audit`` and
``finalize_fields`` — serves the flat engine and the fused kernel too.

The exact engine replays the reference's event loop (reference:
simulator/main.py:28-199, simulator/event_simulator.py) bit for bit. Each
step pops the next event from the CPython-heapq replica
(``ops/heap.py``), applies the DELETE refund or the CREATE placement, and
folds the evaluator into the state, in every lane at once:

- strict-argmax placement with a ``> 0`` gate, ties to the lowest node;
- best-fit (or first-fit) GPU sub-allocation;
- a failed CREATE retries at 1 + the time of the first DELETE in raw
  heap-array order, scanned on the post-pop heap, or is dropped when no
  DELETE is pending (event_simulator.py:51-58); its creation time is
  mutated to the retry time;
- a GPU-allocation shortfall aborts the lane before the event counts
  (the reference raises, main.py:164-165);
- snapshot overshoot past 100% and a fragmentation event on every failed
  creation, as the flat engine.

- scenario faults (``Workload.faults``) ride the heap as NODE_DOWN /
  NODE_UP rows ahead of equal-time pod events; a fault step flips one
  node's cordon bit (a cordoned node scores 0) and touches nothing else,
  and it is not counted in ``events_processed``, snapshots or
  ``max_nodes``;
- ``SimConfig.decision_trace`` logs one ``TraceBuffer`` row per event.

The step is self-masking (a finished lane is a no-op), makes no host sync
and has no data-dependent shape, so one loop runs any number of lanes
until none is active. On the CPU the loop runs eagerly; on CUDA it
captures ``SYNC_EVERY`` steps in a CUDA graph at the first call and
replays it, checking ``any(active)`` once per replay.

Lanes may run different workloads (``parallel.traces``): ``build_step``
and ``finalize`` then take a stacked workload, every tensor with a
leading trace axis ``[T, ...]``, and ``lane_trace`` i64[L], each lane's
trace. The pod tables stay ``[T, P, ...]`` and are read at (trace, pod);
the cluster tables stay ``[N]``-shaped when every trace has the same
cluster and become ``[L, N]`` otherwise.

Large clusters: ``SimConfig.node_prefilter_k`` (both engines) scores only
the first k feasible nodes of each event (``prefilter_candidates``,
``gather_node_view``); ``probe_policy_cost``, ``auto_prefilter_k`` and
``resolve_auto_prefilter`` choose k from a measured policy cost.
``state_pack`` narrows the flat engine's state and is accepted and
ignored here, as in fks_tpu. ``cond_policy`` is accepted and, as in
fks_tpu, changes no result: the policy runs on every step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from fks_tpu_torch.data.entities import ClusterArrays, PodArrays, Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.obs import spans, telemetry
from fks_tpu_torch.ops.allocator import best_fit_gpus, first_fit_gpus
from fks_tpu_torch.ops.heap import (
    COL_KIND, COL_POD, KIND_CREATE, KIND_DELETE, KIND_NODE_DOWN,
    KIND_NODE_UP, first_deletion_in_array_order, heap_from_events, heap_pop,
    heap_push,
)
from fks_tpu_torch.sim.evaluator import (
    max_snapshot_count, snapshot_trigger_table,
)
from fks_tpu_torch.sim.guards import fitness_flags, guard_scores
from fks_tpu_torch.sim.types import (
    TRACE_CREATE, TRACE_DELETE, TRACE_NODE_DOWN, TRACE_NODE_UP, TRACE_RETRY,
    NodeView, PodView, PolicyFn, SimResult, SimState, TraceBuffer,
    batch_size, clone_tensors, copy_tensors_, empty_trace, map_tensors,
    tensor_leaves,
)

#: steps between the host's checks that some lane is still active (one
#: captured CUDA graph on the card); the step is self-masking, so the
#: extra steps of the last round are no-ops
SYNC_EVERY = 16


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation knobs (fks_tpu.sim.engine.SimConfig)."""

    max_steps_factor: int = 8  # runaway guard: max events = factor * num_pods
    max_steps: Optional[int] = None  # overrides the factor when set
    snapshot_interval: float = 0.05
    gpu_allocator: str = "best_fit"  # or "first_fit"
    score_dtype: Any = torch.float32  # evaluator accumulation dtype
    # count invariant-audit failures after every event (reference
    # main.py:201-272) into SimResult.invariant_violations
    validate_invariants: bool = False
    # wait-histogram width override (must exceed the trace's max gpu_milli)
    wait_hist_size: Optional[int] = None
    # skip the policy on non-create events (fks_tpu: a lax.cond). Accepted
    # for fks_tpu's signature; it changes no result, and the port's steps
    # always run the policy
    cond_policy: bool = False
    # maintain SimResult.pod_ctime (retry-mutated creation times) in the
    # flat engine, a per-event queue write that throughput paths turn off;
    # the exact engine always tracks it
    track_ctime: bool = True
    # numerics watchdog (sim.guards): flag NaN/Inf policy scores per lane
    # (masking them to "refuse") and audit the final fitness
    watchdog: bool = False
    # log one TraceBuffer row per processed event (fks_tpu_torch.obs.
    # tracing reads it); off, the states' and results' trace is None
    decision_trace: bool = False
    trace_len: Optional[int] = None  # trace rows; default resolve_max_steps
    # score a truncated prefix: the fitness gate drops "no pending events"
    # and "every pod assigned" (fks_tpu.funsearch.budget's probe rungs)
    probe_score: bool = False
    # top-k candidate-node prefiltering (both engines): 0 sweeps every node
    # per event; k > 0 scores only the first k feasible nodes (ascending
    # index, under the cordon mask) and maps the winner back to its global
    # index. Exact for policies that refuse infeasible nodes and prefer
    # lower indices among equal scores (first_fit and every feasibility-
    # gated zoo and parametric policy on its preferred node); for others
    # the winner is the argmax over the candidates. k >= n_padded falls
    # back to the dense sweep
    node_prefilter_k: int = 0
    # narrow the flat engine's state columns whose full range provably
    # fits 16 bits at this workload's shape (sim.flat._pack_dtypes);
    # exact, so results are bit-identical. The exact engine ignores it
    state_pack: bool = False

    def resolve_prefilter_k(self, n_padded: int) -> int:
        """Candidate count for top-k node prefiltering: 0 means dense
        sweep. Values >= n_padded fall back to 0 (gathering every node in
        rank order is slower than the dense sweep)."""
        k = self.node_prefilter_k
        if k < 0:
            raise ValueError(
                f"node_prefilter_k must be >= 0 (0 disables prefiltering), "
                f"got {k}")
        return k if 0 < k < n_padded else 0

    def resolve_max_steps(self, num_pods: int) -> int:
        if self.max_steps is not None:
            return self.max_steps
        return max(64, self.max_steps_factor * num_pods)

    def resolve_trace_len(self, num_pods: int) -> int:
        if self.trace_len is not None:
            return self.trace_len
        return self.resolve_max_steps(num_pods)


def check_config(cfg: SimConfig) -> None:
    """Raise ValueError for an unknown allocator or a negative
    ``node_prefilter_k`` (either engine)."""
    if cfg.gpu_allocator not in ("best_fit", "first_fit"):
        raise ValueError(f"unknown gpu_allocator {cfg.gpu_allocator!r}")
    cfg.resolve_prefilter_k(1)


def loop_tables(workload: Workload, cfg: SimConfig):
    """(ktable int32[K] numpy, max_steps) — snapshot triggers and the step
    budget, shared by every runner so snapshot semantics cannot diverge."""
    num_pods = workload.num_pods
    max_steps = cfg.resolve_max_steps(num_pods)
    ktable = snapshot_trigger_table(
        num_pods,
        max_snapshot_count(max_steps, num_pods, cfg.snapshot_interval),
        cfg.snapshot_interval)
    return ktable, max_steps


def hist_size(workload: Workload, cfg: SimConfig) -> int:
    """Waiting-histogram width; must exceed the trace's max gpu_milli."""
    p = workload.pods
    max_milli = int(p.gpu_milli.max()) if p.p_padded else 0
    size = (cfg.wait_hist_size if cfg.wait_hist_size is not None
            else max(1001, max_milli + 2))
    if size <= max_milli:
        raise ValueError(
            f"wait_hist_size {size} <= trace max gpu_milli; "
            "fragmentation min_needed would be miscounted")
    return size


def _node_view(c: ClusterArrays, cpu_left, mem_left, gpu_left,
               gpu_milli_left) -> NodeView:
    return NodeView(
        cpu_milli_left=cpu_left, cpu_milli_total=c.cpu_total,
        memory_mib_left=mem_left, memory_mib_total=c.mem_total,
        gpu_left=gpu_left, num_gpus=c.num_gpus,
        gpu_milli_left=gpu_milli_left, gpu_milli_total=c.gpu_milli_total,
        gpu_mem_total=c.gpu_mem_total, gpu_mask=c.gpu_mask,
        node_mask=c.node_mask)


#: NodeView fields with a trailing GPU axis
_GRID_FIELDS = frozenset(("gpu_milli_left", "gpu_milli_total",
                          "gpu_mem_total", "gpu_mask"))


def prefilter_candidates(pod: PodView, nodes: NodeView, place_mask,
                         k: int) -> torch.Tensor:
    """Top-k candidate nodes of each lane's event (``SimConfig.
    node_prefilter_k``; fks_tpu.sim.engine._prefilter_candidates): the
    first k nodes, in ascending global index, that pass the zoo's
    feasibility test (free CPU, memory, GPU count and enough GPUs with
    the pod's milli free) under ``place_mask`` (bool[N] or [L, N]), so a
    cordoned or padding node never enters a slot. An argmax over the
    gathered view keeps the dense sweep's lowest-index tie rule. When
    fewer than k nodes are feasible the tail repeats the first candidate;
    when none is, every slot is node 0, which the caller's
    ``place_mask[cand]`` re-mask scores 0, so the event fails as under the
    dense sweep.

    Slot j is the node where the running feasible count reaches j + 1: a
    cumsum and a ``searchsorted``, the cumsum + one-hot selection of
    fks_tpu in O(k log N), no host sync. Returns i64[L, k]."""
    eligible = (nodes.gpu_mask & (nodes.gpu_milli_left
                                  >= pod.gpu_milli[..., None])).sum(dim=-1)
    gpu_ok = (pod.num_gpu <= 0) | (eligible >= pod.num_gpu)
    feasible = (place_mask & (pod.cpu_milli <= nodes.cpu_milli_left)
                & (pod.memory_mib <= nodes.memory_mib_left)
                & (pod.num_gpu <= nodes.gpu_left) & gpu_ok)  # [L, N]
    count = feasible.cumsum(dim=-1)  # i64[L, N], non-decreasing
    k_iota = torch.arange(k, device=count.device)
    slot = torch.searchsorted(count, (k_iota + 1).expand(
        count.shape[0], k).contiguous())  # N where past the count
    first = torch.where(count[:, -1:] > 0, slot[:, :1], 0)
    return torch.where(k_iota < count[:, -1:], slot, first)


def gather_node_view(nodes: NodeView, cand: torch.Tensor) -> NodeView:
    """The ``[L, k, ...]`` candidate view (fks_tpu.sim.engine.
    _gather_node_view): every field at each lane's candidate nodes
    ``cand`` i64[L, k]; shared ``[N]`` / ``[N, G]`` fields become per
    lane."""
    out = []
    for name, leaf in zip(NodeView._fields, nodes):
        grid = name in _GRID_FIELDS
        if leaf.dim() == (3 if grid else 2):  # per lane
            idx = cand[..., None].expand(-1, -1, leaf.shape[-1]) \
                if grid else cand
            out.append(leaf.gather(1, idx))
        else:
            out.append(leaf[cand])
    return NodeView(*out)


def _cluster_totals(c: ClusterArrays) -> torch.Tensor:
    """i64[4] cluster-wide capacity (cpu, mem, GPU count, GPU milli), or
    i64[L, 4] for per-lane clusters, computed on the device (no host
    sync)."""
    i64 = torch.int64
    return torch.stack([c.cpu_total.sum(dim=-1, dtype=i64),
                        c.mem_total.sum(dim=-1, dtype=i64),
                        c.num_gpus.sum(dim=-1, dtype=i64),
                        c.gpu_milli_total.sum(dim=(-2, -1), dtype=i64)],
                       dim=-1)


# ---------------------------------------------- per-lane workload tables

def lane_table(x: torch.Tensor, lane_trace) -> torch.Tensor:
    """A stacked per-trace table ``[T, ...]`` as each lane's row ``[L,
    ...]`` (``lane_trace`` i64[L]); a one-workload table as it is."""
    return x if lane_trace is None else x[lane_trace]


def lane_cluster(c: ClusterArrays, lane_trace) -> ClusterArrays:
    """The cluster tables a step reads. One workload: as they are. Stacked
    traces: one trace's ``[N]`` tables when every trace has the same
    cluster (a scenario suite varies only pods and faults), else each
    lane's own, ``[L, N]`` and ``[L, N, G]``. The comparison reads the
    tables on the host once, when the step is built."""
    if lane_trace is None:
        return c
    tabs = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), torch.Tensor)}
    if all(bool((x == x[:1]).all()) for x in tabs.values()):
        return dataclasses.replace(c, **{k: x[0] for k, x in tabs.items()})
    return dataclasses.replace(c, **{k: x[lane_trace]
                                     for k, x in tabs.items()})


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table`` at per-lane positions ``idx`` i64[L, k]: a shared table
    ``[K]`` is indexed, a per-lane one ``[L, K]`` gathered. [L, k]."""
    return table[idx] if table.dim() == 1 else table.gather(1, idx)


def _pod_rows(table: torch.Tensor, pod: torch.Tensor, tix) -> torch.Tensor:
    """Rows of a pod table ``[P, ...]`` at ``pod`` i64[L], or of a stacked
    one ``[T, P, ...]`` at (lane's trace ``tix``, pod): no per-lane copy of
    the table."""
    return table[pod] if tix is None else table[tix, pod]


def _node_rows(table: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The ``[N, G]`` (shared) or ``[L, N, G]`` (per-lane) table's row at
    each lane's node ``w`` i64[L, 1]: [L, G]."""
    if table.dim() == 2:
        return table[w[:, 0]]
    return table.gather(1, w[:, :, None].expand(-1, 1, table.shape[-1]))[:, 0]


def _audit(c: ClusterArrays, p: PodArrays, active_pods, cpu_left, mem_left,
           gpu_left, gpu_milli_left, assigned_node, assigned_gpus):
    """The reference's invariant checks (main.py:201-272) over L lanes:
    non-negative remnants, remnant <= total, and conservation (used ==
    total - remaining) per node and per GPU, against ``active_pods``
    bool[L, P] — the engine's "DELETE still pending" mask. ``p``'s arrays
    are in the same pod order as ``assigned_*``. Returns i32[L], 1 where
    an invariant fails."""
    i64 = torch.int64
    n, g = c.gpu_mask.shape[-2:]
    nm, gm = c.node_mask, c.gpu_mask

    def anyn(x):
        return x.flatten(1).any(dim=1)

    neg = (anyn(nm & (cpu_left < 0)) | anyn(nm & (mem_left < 0))
           | anyn(nm & (gpu_left < 0)) | anyn(gm & (gpu_milli_left < 0)))
    over = (anyn(nm & (cpu_left > c.cpu_total))
            | anyn(nm & (mem_left > c.mem_total))
            | anyn(nm & (gpu_left > c.gpu_declared))
            | anyn(gm & (gpu_milli_left > c.gpu_milli_total)))
    active = active_pods & (assigned_node >= 0)
    seg = assigned_node.clamp(0, n - 1).long()
    lanes = active.shape[0]

    def used_by_node(req):
        z = torch.zeros((lanes, n), dtype=i64, device=seg.device)
        return z.scatter_add_(1, seg, torch.where(active, req, 0).to(i64))

    cons = (anyn(nm & (c.cpu_total - cpu_left != used_by_node(p.cpu)))
            | anyn(nm & (c.mem_total - mem_left != used_by_node(p.mem)))
            | anyn(nm & (c.gpu_declared - gpu_left
                         != used_by_node(p.num_gpu))))
    g_iota = torch.arange(g, device=seg.device)
    bits = (assigned_gpus[..., None] >> g_iota) & 1  # [L, P, G]
    contrib = torch.where(active[..., None], bits * p.gpu_milli[..., None], 0)
    used_milli = torch.zeros((lanes, n, g), dtype=i64, device=seg.device)
    used_milli.scatter_add_(1, seg[..., None].expand(-1, -1, g), contrib)
    cons_g = anyn(gm & (c.gpu_milli_total - gpu_milli_left != used_milli))
    return (neg | over | cons | cons_g).to(torch.int32)


@dataclasses.dataclass
class FinalView:
    """The evaluator fields ``finalize_fields`` reads, per lane, with
    per-pod arrays already in input (CSV) order."""

    assigned_node: torch.Tensor  # i32[L, P]
    assigned_gpus: torch.Tensor  # i64[L, P]
    pod_ctime: torch.Tensor  # i32[L, P]
    cpu_left: torch.Tensor
    mem_left: torch.Tensor
    gpu_left: torch.Tensor
    gpu_milli_left: torch.Tensor
    events_processed: torch.Tensor
    snap_idx: torch.Tensor
    snap_sums: torch.Tensor  # f[L, 4]
    frag_sum: torch.Tensor
    frag_count: torch.Tensor
    max_nodes: torch.Tensor
    failed: torch.Tensor
    violations: torch.Tensor  # i32[L]
    numeric_flags: torch.Tensor  # i32[L]
    trace: Optional[TraceBuffer] = None


def finalize_fields(workload: Workload, cfg: SimConfig, *, pending,
                    s: FinalView, lane_trace=None) -> SimResult:
    """Fitness + results (reference evaluator.py:77-127) for L lanes.
    ``pending`` is bool[L]: events remain unprocessed. ``lane_trace`` maps
    lanes to the traces of a stacked workload (module docstring)."""
    f = cfg.score_dtype
    dev = s.snap_idx.device
    pod_mask = lane_table(workload.pods.pod_mask, lane_trace)
    n_snap = s.snap_idx
    denom = n_snap.clamp(min=1).to(f)
    avg = s.snap_sums / denom[:, None]
    frag_mean = torch.where(
        s.frag_count > 0, s.frag_sum / s.frag_count.clamp(min=1).to(f),
        torch.zeros((), dtype=f, device=dev))
    all_assigned = ((s.assigned_node >= 0) | ~pod_mask).all(dim=-1)
    truncated = pending & ~s.failed
    overall = avg.sum(dim=-1) / 4
    raw = (overall - frag_mean.clamp(max=0.1)).clamp(0.0, 1.0)
    if cfg.probe_score:
        gate = (n_snap > 0) & ~s.failed
    else:
        gate = (n_snap > 0) & all_assigned & ~s.failed & ~truncated
    score = torch.where(gate, raw, torch.zeros((), dtype=raw.dtype,
                                                device=dev))
    scheduled = ((s.assigned_node >= 0) & pod_mask).sum(
        dim=-1, dtype=torch.int32)
    numeric_flags = s.numeric_flags
    if cfg.watchdog:
        numeric_flags = numeric_flags | fitness_flags(score)
    return SimResult(
        policy_score=score,
        avg_cpu_utilization=avg[:, 0], avg_memory_utilization=avg[:, 1],
        avg_gpu_count_utilization=avg[:, 2],
        avg_gpu_memory_utilization=avg[:, 3],
        gpu_fragmentation_score=frag_mean,
        num_snapshots=n_snap, num_fragmentation_events=s.frag_count,
        events_processed=s.events_processed, scheduled_pods=scheduled,
        max_nodes=s.max_nodes, assigned_node=s.assigned_node,
        assigned_gpus=s.assigned_gpus, pod_ctime=s.pod_ctime,
        cpu_left=s.cpu_left, mem_left=s.mem_left, gpu_left=s.gpu_left,
        gpu_milli_left=s.gpu_milli_left, failed=s.failed,
        truncated=truncated, invariant_violations=s.violations,
        numeric_flags=numeric_flags, trace=s.trace,
    )


def trace_append(trace: TraceBuffer, *, active, create, is_del, was_waiting,
                 pod, node, scores, winner, pending, cpu_left, mem_left,
                 gpu_left, gpu_milli_left, fault_down=None,
                 fault_up=None) -> TraceBuffer:
    """Append one decision row per lane (fks_tpu.sim.engine._trace_append,
    shared by both engines so the vocabulary cannot drift). Per-lane
    arguments are [L] (``winner`` i64[L, 1], ``scores`` the masked policy
    scores [L, N]). A lane that is inactive, or whose buffer is full,
    writes the scratch row. Deletes and faults record score and margin 0;
    fault rows (``fault_down`` / ``fault_up``) override the kind. Updates
    the buffer's tensors in place."""
    i32, i64 = torch.int32, torch.int64
    tlen = trace.length
    kind = torch.where(is_del, TRACE_DELETE,
                       torch.where(was_waiting, TRACE_RETRY, TRACE_CREATE))
    if fault_down is not None:
        kind = torch.where(fault_down, TRACE_NODE_DOWN,
                           torch.where(fault_up, TRACE_NODE_UP, kind))
    row = torch.stack([
        kind.to(i64), pod.to(i64), node.to(i64), pending.to(i64),
        cpu_left.sum(dim=1, dtype=i64), mem_left.sum(dim=1, dtype=i64),
        gpu_left.sum(dim=1, dtype=i64),
        gpu_milli_left.sum(dim=(1, 2), dtype=i64)], dim=1).to(i32)
    sdt = trace.scores.dtype
    win = scores.gather(1, winner).to(sdt)[:, 0]
    zero = torch.zeros((), dtype=sdt, device=win.device)
    if scores.shape[1] > 1:
        n_iota = torch.arange(scores.shape[1], device=win.device)
        others = torch.where(n_iota == winner, float("-inf"),
                             scores.to(sdt))
        margin = win - others.amax(dim=1)
    else:
        margin = torch.zeros_like(win)
    val = torch.stack([torch.where(create, win, zero),
                       torch.where(create, margin, zero)], dim=1)
    write = active & (trace.count < tlen)
    idx = torch.where(write, trace.count, tlen).long()[:, None, None]
    trace.data.scatter_(1, idx.expand(-1, 1, 8), row[:, None])
    trace.scores.scatter_(1, idx.expand(-1, 1, 2), val[:, None])
    return TraceBuffer(data=trace.data, scores=trace.scores,
                       count=trace.count + write.to(i32))


# ------------------------------------------------------- state plumbing

def _tensor_leaves(state):
    """Every tensor of a state dataclass, nested dataclasses included, in
    field order."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            yield from _tensor_leaves(v)
        elif isinstance(v, torch.Tensor):
            yield v


def broadcast_state(state0, lanes: int):
    """``lanes`` independent copies of a one-lane state (any engine's)."""
    return map_tensors(
        lambda x: x.expand((lanes,) + tuple(x.shape[1:])).clone(), state0)


def tile_state(state, reps: int):
    """``reps`` copies of an L-lane state laid end to end: lane ``r * L +
    l`` is a copy of lane ``l`` (the candidate-outer, trace-inner lane
    order of ``parallel.traces``)."""
    return map_tensors(
        lambda x: x.repeat((reps,) + (1,) * (x.dim() - 1)), state)


def zip_tensors(fn, objs):
    """One dataclass shaped like ``objs[0]`` (all alike) whose every
    tensor is ``fn`` of the list of the objects' tensors at that place."""
    leaves = zip(*(list(_tensor_leaves(o)) for o in objs))
    it = iter([fn(list(xs)) for xs in leaves])
    return map_tensors(lambda _x: next(it), objs[0])


def stack_states(states):
    """One state whose lanes are the lanes of ``states`` in order (same
    engine, same shapes)."""
    return zip_tensors(torch.cat, states)


def copy_state_(dst, src) -> None:
    """Write every tensor of ``src`` into the same-shaped state ``dst``."""
    for a, b in zip(_tensor_leaves(dst), _tensor_leaves(src)):
        if a is not b:
            a.copy_(b)


def run_chunk(step, state, steps: int = SYNC_EVERY) -> None:
    """``steps`` steps from ``state``, written back into ``state``'s own
    tensors — the body ``GraphedChunk`` captures, so repeating it on one
    state object is what a replay does."""
    out = state
    for _ in range(steps):
        out = step(out)
    copy_state_(state, out)


def graph_steps(obj) -> int:
    """Steps a captured CUDA graph holds for a policy or a step built by
    ``bind_step``: its ``graph_steps`` attribute (the funsearch VM, which
    launches tens of thousands of kernels per step, captures one step),
    else ``SYNC_EVERY``."""
    return int(getattr(obj, "graph_steps", SYNC_EVERY))


def bind_step(build_step_fn, workload: Workload, param_policy, params,
              cfg: SimConfig, ktable, max_steps: int, **kw):
    """``build_step_fn`` (either engine's ``build_step``) over
    ``param_policy`` bound to ``params``. The step carries ``params`` (a
    captured graph's static input, copied into) and its policy's
    ``graph_steps``, which ``GraphedChunk`` and ``run_batched_lanes``
    read: every runner binds its step here, so none decides the steps
    per graph on its own."""
    step = build_step_fn(
        workload, lambda pod, nodes: param_policy(params, pod, nodes), cfg,
        ktable, max_steps, **kw)
    step.params = params
    step.graph_steps = graph_steps(param_policy)
    return step


#: one capture at a time in the process (``capture``)
_CAPTURE_LOCK = threading.RLock()


@contextlib.contextmanager
def capture(graph, stream, label: str):
    """Capture CUDA work into ``graph`` on ``stream`` (a stream of the
    card the work runs on: ``torch.cuda.graph``'s default capture stream
    belongs to whichever card was current at the process's first capture,
    and a capture on another card's stream records none of this card's
    work), counted by ``obs.telemetry.graph_capture`` under ``label``.

    Captures may run while other threads serve (the promotion controller
    captures a candidate's graphs while the batcher thread replays the
    incumbent's), so:

    - the capture runs in ``capture_error_mode="thread_local"``: the
      default global mode makes another thread's unsafe calls (a
      synchronising copy of a served answer, an allocation) fail or
      invalidate the capture; thread-local mode checks only this thread;
    - captures take turns (``_CAPTURE_LOCK``), and Python's garbage
      collector pauses during each: ``torch.cuda.graph`` collects once
      before it begins, a collection during the capture can free an older
      graph, and destroying a graph invalidates a capture in progress.
      Taking turns keeps the collector's snapshot and restore of one
      capture from interleaving with another thread's, which could turn
      the collector back on in the middle of that capture."""
    with _CAPTURE_LOCK:
        enabled = gc.isenabled()
        gc.disable()
        try:
            with telemetry.graph_capture(label), \
                    torch.cuda.graph(graph, stream=stream,
                                     capture_error_mode="thread_local"):
                yield
        finally:
            if enabled:
                gc.enable()


class GraphedChunk:
    """``graph_steps(step)`` steps of a self-masking step on a fixed state,
    captured once in a CUDA graph and replayed.

    The state's tensors are the graph's inputs and outputs: a chunk runs
    the steps, then copies the last step's state into ``state`` (tensors
    the step updates in place are already there). Construction runs one
    chunk eagerly on a side stream of the state's card (the warm-up,
    which advances ``state`` like any chunk), then captures on that same
    stream (``capture``). A capture that fails raises; there is no eager
    fallback."""

    def __init__(self, step, state, max_steps: int, active_fn=None):
        # the graph reads the device memory of every tensor the step closes
        # over (the workload tables, a population's params): holding the
        # step keeps them alive for as long as the graph can replay
        self.step = step
        self.state = state
        self.max_steps = max_steps
        self.active_fn = lane_active if active_fn is None else active_fn
        self.steps = steps = graph_steps(step)
        # a flat step of hand kernels (sim.flat_step), which drain counts
        self.kernel_step = bool(getattr(step, "kernel_step", False))
        self.replays = 0
        # the state's card, whichever card is current (a mesh's shards
        # may sit on several)
        self.device = dev = next(_tensor_leaves(state)).device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                run_chunk(step, state, steps)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with capture(self.graph, side, "chunk"):
                run_chunk(step, state, steps)

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        self.replays += 1

    def run(self):
        """Replay until no lane is active (one host check per replay)."""
        drain([LaneJob(self.step, self.state, self.max_steps,
                       self.active_fn, self)])
        return self.state


def run_batched_lanes(step, state, max_steps: int, active_fn=None):
    """Drive a stack of self-masking lanes until none is active: eagerly on
    the CPU (a host check every ``SYNC_EVERY`` steps), through a
    ``GraphedChunk`` on CUDA. ``active_fn`` is the engine's
    ``lane_active``, the predicate its step masks with."""
    chunk = (GraphedChunk(step, state, max_steps, active_fn)
             if next(_tensor_leaves(state)).is_cuda else None)
    job = LaneJob(step, state, max_steps, active_fn, chunk)
    drain([job])
    return job.state


class LaneJob:
    """A stack of self-masking lanes on their way to the end, advanced by
    ``drain``: through its ``GraphedChunk`` (one replay per advance) when
    it has one, else ``SYNC_EVERY`` eager steps per advance, as
    ``run_batched_lanes`` drives them.

    On CUDA the job keeps the device and stream that were current when
    it was made: its flag reads and its advances run there, whichever
    stream is current when ``drain`` runs, so the work of a job started
    on a serving stream stays ordered on that stream.

    Every active lane steps its ``steps`` counter and stops at
    ``max_steps``, so ``ceil(max_steps / steps per advance)`` advances
    drain any job; a job still active after them raises instead of
    spinning (a replay that steps nothing, or a step and predicate that
    diverged)."""

    def __init__(self, step, state, max_steps: int, active_fn=None,
                 chunk: Optional[GraphedChunk] = None):
        self.step = step
        self.state = chunk.state if chunk is not None else state
        self.max_steps = max_steps
        self.active_fn = lane_active if active_fn is None else active_fn
        self.chunk = chunk
        per = chunk.steps if chunk is not None else SYNC_EVERY
        self.budget = -(-max_steps // per)
        self.advances = 0
        dev = next(_tensor_leaves(self.state)).device
        self.stream = (torch.cuda.current_stream(dev)
                       if dev.type == "cuda" else None)

    def scope(self):
        """The job's device and stream (nothing on the CPU)."""
        stack = contextlib.ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.stream.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def active(self) -> torch.Tensor:
        """Whether any lane is still active (a device bool, unread)."""
        with self.scope():
            return self.active_fn(self.state, self.max_steps).any()

    def read(self, flag: torch.Tensor) -> bool:
        """Read a flag of ``active`` on the job's stream."""
        with self.scope():
            return bool(flag)

    def advance(self) -> None:
        if self.advances >= self.budget:
            raise RuntimeError(
                f"lanes still active after {self.advances} advances, "
                f"{self.max_steps} steps: the replay steps nothing or the "
                "step and its predicate diverged")
        self.advances += 1
        with self.scope():
            if self.chunk is not None:
                self.chunk.replay()
                return
            for _ in range(SYNC_EVERY):
                self.state = self.step(self.state)


class _ReplayClock:
    """CUDA events around the graph replays that ``drain`` queues on one
    stream: their device time, and the device gap from a round's last
    replay on the stream to the next round's first (the flag reductions,
    their reads, the host's wake and the next launch). ``turn`` reads a
    round's events in the next round, after that round's flag reads have
    completed them and its replays are queued, so nothing waits."""

    __slots__ = ("stream", "queued", "done", "last_end", "device_s",
                 "gap_s")

    def __init__(self, stream):
        self.stream = stream
        self.queued, self.done = [], []  # (start, end) of a round's replays
        self.last_end = None
        self.device_s = self.gap_s = 0.0

    def replay(self, job: LaneJob) -> None:
        start = spans.device_event(self.stream)
        job.advance()
        self.queued.append((start, spans.device_event(self.stream)))

    def turn(self) -> None:
        """Read the round before's replays; keep this round's for the
        next."""
        done, self.done, self.queued = self.done, self.queued, []
        if not done:
            return
        if self.last_end is not None:
            self.gap_s += spans.elapsed_s(self.last_end, done[0][0])
        self.device_s += sum(spans.elapsed_s(a, b) for a, b in done)
        self.last_end = done[-1][1]


def drain(jobs: Sequence[LaneJob]) -> None:
    """Advance every job until none of its lanes is active. Each round
    queues one advance of every live job before it reads any job's flag,
    so jobs on several devices (or several graphs of one device) run
    together, and the host reads each round's flags once.

    Under an open span (``obs.spans``) it counts, on that span and its
    parents: ``rounds``, and for graphed jobs ``replays``, the steps they
    ran (``steps``) and from CUDA events (``_ReplayClock``) their device
    seconds (``engine_device_s``) and the device gaps between rounds
    (``round_gap_s``, summed over streams), and of those steps the ones
    the flat engine's kernel step ran (``kernel_steps``, where any did)."""
    live = list(jobs)
    timed = spans.is_open()
    clocks = {}
    rounds = replays = steps = kernel_steps = 0
    while live:
        rounds += 1
        flags = [job.active() for job in live]
        live = [job for job, flag in zip(live, flags) if job.read(flag)]
        for job in live:
            if job.chunk is None:
                job.advance()
                continue
            replays += 1
            steps += job.chunk.steps
            if job.chunk.kernel_step:
                kernel_steps += job.chunk.steps
            if not timed:
                job.advance()
                continue
            clock = clocks.get(job.stream)
            if clock is None:
                clock = clocks[job.stream] = _ReplayClock(job.stream)
            clock.replay(job)
        for clock in clocks.values():
            clock.turn()
    if not timed:
        return
    spans.add(rounds=rounds)
    if replays:
        spans.add(replays=replays, steps=steps)
    if kernel_steps:
        spans.add(kernel_steps=kernel_steps)
    if clocks:
        spans.add(engine_device_s=sum(c.device_s for c in clocks.values()),
                  round_gap_s=sum(c.gap_s for c in clocks.values()))


# ------------------------------------------------------- the exact engine

def initial_state(workload: Workload, cfg: SimConfig,
                  lanes: int = 1) -> SimState:
    """The t=0 state for ``lanes`` identical lanes on the workload's
    device. The initial heap layout comes from CPython ``heapq`` on the
    host, so it is the reference's. Fault events ride the same heap: the
    payload is the node index and the rank ``row - F_pad < 0``, so at
    equal time every fault pops before every pod event (tie ranks are >=
    0) and faults keep their array order (fks_tpu engine.py:167-181)."""
    check_config(cfg)
    c, p = workload.cluster, workload.pods
    dev = workload.device
    i32 = torch.int32
    pm = p.pod_mask.cpu().numpy()
    times = p.creation_time.cpu().numpy()[pm]
    ranks = p.tie_rank.cpu().numpy()[pm]
    kinds = np.full(times.shape[0], KIND_CREATE, np.int32)
    payload = pm.nonzero()[0]
    capacity = p.p_padded
    fe = workload.faults
    if fe is not None:
        fm = fe.mask.cpu().numpy()
        fpad = fm.shape[0]
        times = np.concatenate([times, fe.time.cpu().numpy()[fm]])
        ranks = np.concatenate([ranks, fm.nonzero()[0] - fpad])
        kinds = np.concatenate([kinds, fe.kind.cpu().numpy()[fm]])
        payload = np.concatenate([payload, fe.node.cpu().numpy()[fm]])
        capacity += fpad
    heap = heap_from_events(times, ranks, kinds, payload, capacity=capacity,
                            device=dev)
    pp = p.p_padded
    f = cfg.score_dtype
    pod_state = torch.stack([
        torch.full((pp,), -1, dtype=i32, device=dev),  # assigned node
        torch.zeros(pp, dtype=i32, device=dev),  # GPU bitmask
        p.creation_time.to(i32),  # creation time
        torch.zeros(pp, dtype=i32, device=dev),  # waiting flag
    ], dim=-1)[None]
    zero = torch.zeros(1, dtype=i32, device=dev)
    state = SimState(
        heap=heap, cpu_left=c.cpu_total[None].clone(),
        mem_left=c.mem_total[None].clone(),
        gpu_left=c.gpu_declared[None].clone(),
        gpu_milli_left=c.gpu_milli_total[None].clone(),
        pod_state=pod_state,
        wait_hist=torch.zeros((1, hist_size(workload, cfg)), dtype=i32,
                              device=dev),
        events_processed=zero, snap_idx=zero.clone(),
        snap_sums=torch.zeros((1, 4), dtype=f, device=dev),
        frag_sum=torch.zeros(1, dtype=f, device=dev),
        frag_count=zero.clone(), max_nodes=zero.clone(),
        failed=torch.zeros(1, dtype=torch.bool, device=dev),
        steps=zero.clone(), violations=zero.clone(),
        numeric_flags=zero.clone(),
        trace=(empty_trace(1, cfg.resolve_trace_len(workload.num_pods), f,
                           dev) if cfg.decision_trace else None),
        node_avail=(None if fe is None else torch.ones(
            (1, c.n_padded), dtype=torch.bool, device=dev)))
    return state if lanes == 1 else broadcast_state(state, lanes)


def lane_active(s: SimState, max_steps: int) -> torch.Tensor:
    """bool[L] termination predicate — the loop's condition and the
    step's self-mask, so the two cannot diverge."""
    return (s.heap.size > 0) & ~s.failed & (s.steps < max_steps)


def pod_table(p: PodArrays) -> torch.Tensor:
    """The pod rows a step gathers from: i32[P, 5] (cpu, mem, GPU count,
    GPU milli, duration), or [T, P, 5] for stacked traces."""
    return torch.stack([p.cpu, p.mem, p.num_gpu, p.gpu_milli, p.duration],
                       dim=-1).to(torch.int32)


def build_step(workload: Workload, policy: PolicyFn, cfg: SimConfig,
               ktable, max_steps: int, lane_trace=None,
               pod_rows=None) -> Callable[[SimState], SimState]:
    """One event in every lane (module docstring).
    ``policy(PodView, NodeView) -> [L, N]`` scores all lanes at once; per-
    lane scalars are ``[L, 1]`` columns. With ``lane_trace`` the workload
    is a stack of traces and ``ktable`` their ``[T, K]`` snapshot tables
    (``parallel.traces.stack_traces``). ``pod_rows`` is the step's
    ``pod_table`` buffer when the caller keeps its own (a serve graph
    rewrites it in place for every batch); ``ktable`` is then the caller's
    ``[L, K]`` buffer too, read in place with one row per lane, and
    ``lane_trace`` must map lane l to trace l. By default the step derives
    both from the workload once, when it is built."""
    check_config(cfg)
    p = workload.pods
    c = lane_cluster(workload.cluster, lane_trace)
    dev = workload.device
    i32, i64 = torch.int32, torch.int64
    g = c.g_padded
    f = cfg.score_dtype
    alloc = (best_fit_gpus if cfg.gpu_allocator == "best_fit"
             else first_fit_gpus)
    totals = _cluster_totals(c)
    denom = totals.clamp(min=1).to(f)
    no_total = totals <= 0
    gm_total_pos = totals[..., 3] > 0
    g_iota = torch.arange(g, dtype=i32, device=dev)
    g_pow = torch.ones((), dtype=i32, device=dev) << g_iota  # bit 31 < 0
    n_iota = torch.arange(c.n_padded, device=dev)
    nh = hist_size(workload, cfg)
    h_iota = torch.arange(nh, dtype=i32, device=dev)
    kinds = torch.tensor([KIND_CREATE, KIND_DELETE], dtype=i32, device=dev)
    signs = torch.tensor([0, 1, -1], dtype=i32, device=dev)
    if pod_rows is None:
        ktable = lane_table(torch.as_tensor(ktable, dtype=i32, device=dev),
                            lane_trace)
    klen = int(ktable.shape[-1])
    # [P, 5] (or [T, P, 5]), one row gather per event
    feat = pod_table(p) if pod_rows is None else pod_rows
    tix = lane_trace
    pp = p.p_padded
    if cfg.validate_invariants and lane_trace is not None:
        p = dataclasses.replace(p, **{k: getattr(p, k)[lane_trace] for k in (
            "cpu", "mem", "num_gpu", "gpu_milli")})
    has_faults = workload.faults is not None
    f_zero = torch.zeros((), dtype=f, device=dev)
    prefilter_k = cfg.resolve_prefilter_k(c.n_padded)

    def step(s: SimState) -> SimState:
        lanes = s.lanes
        act = lane_active(s, max_steps)
        heap, (t, rk, kind, pod) = heap_pop(s.heap, pred=act)
        is_del = (act & (kind == KIND_DELETE))[:, None]
        podl = pod.long()
        if has_faults:
            # a fault's payload is a node index: flip that node's cordon
            # bit and nothing else. Every pod-event update below is gated
            # on is_del / create, so the pod row the fault's payload points
            # at is read and written back unchanged (clamped: a node index
            # may exceed the pod axis)
            fault_down = act & (kind == KIND_NODE_DOWN)
            fault_up = act & (kind == KIND_NODE_UP)
            is_fault = fault_down | fault_up
            create = (act & (kind == KIND_CREATE))[:, None]
            podl = podl.clamp(max=pp - 1)
            node_avail = torch.where(
                n_iota == torch.where(is_fault, pod, c.n_padded)[:, None],
                fault_up[:, None], s.node_avail)
            # a cordoned node scores 0, "cannot/refuse", until its NODE_UP
            place_mask = c.node_mask & node_avail
        else:
            create = (act & (kind != KIND_DELETE))[:, None]
            node_avail, place_mask = s.node_avail, c.node_mask
        pcpu, pmem, pngpu, pmilli, pdur = _pod_rows(feat, podl, tix).split(
            1, dim=1)
        pod_idx = podl[:, None, None].expand(lanes, 1, 4)
        row = s.pod_state.gather(1, pod_idx)[:, 0]  # [L, 4]
        held_node, bits32, pod_ct, waited = row.split(1, dim=1)
        gpu_pod = pngpu > 0

        # ---- CREATION: score every node, strict argmax (main.py:101-111).
        # A lane's event is a DELETE, a CREATE or a fault, and a DELETE's
        # refund touches no CREATE lane, so the policy sees the pre-step
        # cluster
        nodes = _node_view(c, s.cpu_left, s.mem_left, s.gpu_left,
                           s.gpu_milli_left)
        pview = PodView(pcpu, pmem, pngpu, pmilli, pod_ct, pdur)
        if prefilter_k:
            # the cordon mask feeds the ranking, so a cordoned node never
            # outranks a feasible candidate
            cand = prefilter_candidates(pview, nodes, place_mask,
                                        prefilter_k)
            nodes = gather_node_view(nodes, cand)
        raw = policy(pview, nodes)
        raw, numeric_flags = guard_scores(raw, create[:, 0], s.numeric_flags,
                                          enabled=cfg.watchdog)
        if prefilter_k:
            # re-mask through the gather: the tail of a short candidate
            # list is padding whatever the policy scored
            scores = torch.where(_take(place_mask, cand), raw, 0)
        else:
            scores = torch.where(place_mask, raw, 0)
        # wk indexes the scored view ([k] candidates or [N] nodes), w is
        # the global node index
        wk = scores.argmax(dim=1, keepdim=True)  # first maximal index
        w = cand.gather(1, wk) if prefilter_k else wk
        placed = create & (scores.gather(1, wk) > 0)
        sel, ok = alloc(
            s.gpu_milli_left.gather(1, w[:, :, None].expand(-1, 1, g))[:, 0],
            _node_rows(c.gpu_mask, w), pmilli[:, 0], pngpu[:, 0])
        alloc_fail = placed & gpu_pod & ~ok[:, None]  # reference raises
        pl = placed & ~alloc_fail

        # ---- one signed update: a DELETE refunds its held node and GPUs
        # (main.py:74-99), a placement takes the winner's; a fault or an
        # idle lane has sign 0
        sign = signs[(is_del + 2 * pl).long()]  # +1, -1 or 0 (exclusive)
        oh = torch.where(n_iota == torch.where(is_del, held_node, w), sign,
                         0)  # i32[L, N]
        cpu_left = s.cpu_left + oh * pcpu
        mem_left = s.mem_left + oh * pmem
        gpu_left = s.gpu_left + oh * pngpu
        gbits = torch.where(is_del, (bits32 >> g_iota) & 1, sel.to(i32))
        gml = s.gpu_milli_left + oh[:, :, None] * (gbits * pmilli)[:, None, :]

        # ---- failed creation: waiting set + fragmentation + retry
        failp = create & ~placed
        waiting = ((waited != 0) | failp) & ~pl
        hist = s.wait_hist
        hist.scatter_add_(1, pmilli.clamp(0, nh - 1).long(),
                          torch.where(gpu_pod, waiting.to(i32) - waited, 0))
        min_needed = torch.where(hist > 0, h_iota, nh).amin(
            dim=1, keepdim=True)  # first waiting bucket, nh when none
        frag_free = torch.where(c.gpu_mask & (gml > 0)
                                & (gml < min_needed[:, :, None]), gml, 0)
        frag_score = torch.where(
            (min_needed[:, 0] < nh) & gm_total_pos,
            frag_free.sum(dim=(1, 2), dtype=i64).to(f) / denom[..., 3],
            f_zero)
        frag_sum = s.frag_sum + torch.where(failp[:, 0], frag_score, f_zero)
        frag_count = s.frag_count + failp[:, 0].to(i32)

        # retry at 1 + the first DELETE in array order of the POST-pop heap
        # (the reference's scan point: no DELETE was pushed for a failed
        # placement), or drop; ONE push serves placement and retry
        found, dt = first_deletion_in_array_order(heap)
        retry = failp & found[:, None]
        rt = dt[:, None] + 1
        heap = heap_push(
            heap, torch.where(pl, t[:, None] + pdur, rt)[:, 0], rk,
            kinds[pl[:, 0].long()], pod, pred=(pl | retry)[:, 0])

        # ---- pod bookkeeping: one row scatter (node, bits, ctime, wait)
        new_row = torch.cat([
            torch.where(pl, w.to(i32), held_node),
            torch.where(pl, torch.where(sel, g_pow, 0).sum(
                dim=1, keepdim=True, dtype=i32), bits32),
            torch.where(retry, rt, pod_ct), waiting.to(i32)], dim=1)
        s.pod_state.scatter_(1, pod_idx, new_row[:, None, :])

        # ---- evaluator bookkeeping (main.py:63-72, evaluator.py:55-67);
        # on alloc_fail the reference raises BEFORE record_event_processed.
        # Faults are control events: no events_processed, snapshot or
        # max_nodes count
        valid = act & ~alloc_fail[:, 0]
        if has_faults:
            valid = valid & ~is_fault
        events = s.events_processed + valid.to(i32)
        fire = valid & (s.snap_idx < klen) & (events >= _take(
            ktable, s.snap_idx.clamp(max=klen - 1).long()[:, None])[:, 0])
        used = (totals - torch.stack([
            cpu_left.sum(dim=1, dtype=i64), mem_left.sum(dim=1, dtype=i64),
            gpu_left.sum(dim=1, dtype=i64),
            gml.sum(dim=(1, 2), dtype=i64)], dim=1)).to(f)
        utils = torch.where(no_total, f_zero, used / denom)
        snap_sums = s.snap_sums + torch.where(fire[:, None], utils, f_zero)
        active_nodes = (c.node_mask & (
            (cpu_left < c.cpu_total) | (mem_left < c.mem_total)
            | (gpu_left < c.num_gpus))).sum(dim=1, dtype=i32)
        max_nodes = torch.maximum(s.max_nodes,
                                  torch.where(valid, active_nodes, 0))

        violations = s.violations
        if cfg.validate_invariants:
            hd = heap.data[:, :-1]
            pend = (hd[..., COL_KIND] == KIND_DELETE) & (
                torch.arange(hd.shape[1], device=dev) < heap.size[:, None])
            pend_pod = torch.where(pend, hd[..., COL_POD].long(), pp)
            active_pods = torch.zeros((lanes, pp + 1), dtype=i32,
                                      device=dev).scatter_(1, pend_pod, 1)
            violations = violations + act.to(i32) * _audit(
                c, p, active_pods[:, :pp] > 0, cpu_left, mem_left, gpu_left,
                gml, s.assigned_node, s.assigned_gpus)  # post-step rows

        trace = s.trace
        if cfg.decision_trace:
            tpod = pod
            tnode = torch.where(is_del, held_node,
                                torch.where(pl, w.to(i32), -1))[:, 0]
            fault_kw = {}
            if has_faults:
                tpod = torch.where(is_fault, -1, tpod)
                tnode = torch.where(is_fault, pod, tnode)
                fault_kw = dict(fault_down=fault_down, fault_up=fault_up)
            trace = trace_append(
                trace, active=act, create=create[:, 0], is_del=is_del[:, 0],
                was_waiting=waited[:, 0] != 0, pod=tpod, node=tnode,
                scores=scores, winner=wk, pending=heap.size,
                cpu_left=cpu_left, mem_left=mem_left, gpu_left=gpu_left,
                gpu_milli_left=gml, **fault_kw)

        return SimState(
            heap=heap, cpu_left=cpu_left, mem_left=mem_left,
            gpu_left=gpu_left, gpu_milli_left=gml, pod_state=s.pod_state,
            wait_hist=hist, events_processed=events,
            snap_idx=s.snap_idx + fire.to(i32), snap_sums=snap_sums,
            frag_sum=frag_sum, frag_count=frag_count, max_nodes=max_nodes,
            failed=s.failed | alloc_fail[:, 0],
            steps=s.steps + act.to(i32), violations=violations,
            numeric_flags=numeric_flags, trace=trace, node_avail=node_avail)

    return step


def finalize(workload: Workload, cfg: SimConfig, s: SimState,
             lane_trace=None) -> SimResult:
    """Fitness + results (reference evaluator.py:77-127). Unconsumed
    faults still sit in the heap, so they count as pending events."""
    view = FinalView(
        assigned_node=s.assigned_node, assigned_gpus=s.assigned_gpus,
        pod_ctime=s.pod_ctime, cpu_left=s.cpu_left, mem_left=s.mem_left,
        gpu_left=s.gpu_left, gpu_milli_left=s.gpu_milli_left,
        events_processed=s.events_processed, snap_idx=s.snap_idx,
        snap_sums=s.snap_sums, frag_sum=s.frag_sum,
        frag_count=s.frag_count, max_nodes=s.max_nodes, failed=s.failed,
        violations=s.violations, numeric_flags=s.numeric_flags,
        trace=s.trace)
    return finalize_fields(workload, cfg, pending=s.heap.size > 0, s=view,
                           lane_trace=lane_trace)


def make_param_run_fn(workload: Workload, param_policy,
                      cfg: SimConfig = SimConfig()):
    """``run(params, state) -> SimResult`` for a parameterized policy
    ``(params, PodView, NodeView) -> [L, N]``: drives every lane of
    ``state`` to the end (``run_batched_lanes``) and finalizes."""
    ktable, max_steps = loop_tables(workload, cfg)

    def run(params, state: SimState) -> SimResult:
        step = bind_step(build_step, workload, param_policy, params, cfg,
                         ktable, max_steps)
        return finalize(workload, cfg, run_batched_lanes(step, state,
                                                         max_steps))

    return run


def make_run_fn(workload: Workload, policy: PolicyFn,
                cfg: SimConfig = SimConfig()):
    """``run(state) -> SimResult`` for a plain policy."""
    run = make_param_run_fn(workload, lambda _p, pod, nodes:
                            policy(pod, nodes), cfg)
    return lambda state: run(None, state)


def make_population_run_fn(workload: Workload, param_policy,
                           cfg: SimConfig = SimConfig()):
    """``run(params[P, ...], state0) -> SimResult`` over P lanes, where
    ``state0`` is a one-lane ``initial_state`` and ``params`` a weight
    matrix or any NamedTuple of ``[P, ...]`` tensors (a stacked
    ``funsearch.vm.VMProgram``). On CUDA the first call for a population
    size and params shape captures its ``GraphedChunk`` on a static copy
    of the params and the state; later calls of that key copy theirs in
    and replay, so the result is copied out of the graph's state.
    ``run.graphs`` holds the captured chunks by ``graph_key``."""
    return population_runner(workload, param_policy, cfg, build_step,
                             finalize, lane_active)


def graph_key(pop: int, params) -> tuple:
    """The key a captured population graph is kept under: the lane count
    and the shape and dtype of every tensor of the params. A graph
    replays fixed buffers, so params of another shape (a stacked program
    of another capacity bucket) must capture a graph of their own rather
    than be copied into this one."""
    leaves = tensor_leaves(params) if params is not None else []
    return (pop,) + tuple((tuple(x.shape), x.dtype) for x in leaves)


def population_runner(workload: Workload, param_policy, cfg: SimConfig,
                      build_step_fn, finalize_fn, active_fn):
    """The population runner of ``make_population_run_fn`` for either
    engine, given its ``build_step``, ``finalize`` and ``lane_active``.
    ``run.start(params, state0)`` sets a population's lanes up as a
    ``LaneJob`` (on CUDA in this runner's graph for the key) and
    ``run.finish(job)`` finalizes it, so a caller can drain several
    runners' jobs together (``parallel.mesh``); ``run`` is the two with
    ``drain`` between them."""
    ktable, max_steps = loop_tables(workload, cfg)
    graphs = {}

    def build(params):
        return bind_step(build_step_fn, workload, param_policy, params, cfg,
                         ktable, max_steps)

    def start(params, state0) -> LaneJob:
        pop = batch_size(params)
        state = broadcast_state(state0, pop)
        if not next(_tensor_leaves(state0)).is_cuda:
            return LaneJob(build(params), state, max_steps, active_fn)
        key = graph_key(pop, params)
        chunk = graphs.get(key)
        if chunk is None:
            chunk = GraphedChunk(build(clone_tensors(params)), state,
                                 max_steps, active_fn)
            graphs[key] = chunk
        else:
            copy_tensors_(chunk.step.params, params)
            copy_state_(chunk.state, state)
        return LaneJob(chunk.step, chunk.state, max_steps, active_fn, chunk)

    def finish(job: LaneJob) -> SimResult:
        """The job's results; a graph's are copied out of its buffers."""
        res = finalize_fn(workload, cfg, job.state)
        return map_tensors(torch.clone, res) if job.chunk is not None \
            else res

    def run(params, state0):
        job = start(params, state0)
        drain([job])
        return finish(job)

    run.graphs = graphs
    run.start = start
    run.finish = finish
    return run


def simulate(workload: Workload, policy: PolicyFn,
             cfg: SimConfig = SimConfig(), device=None) -> SimResult:
    """The reference's "build the simulator, run the schedule, read the
    evaluator" in one call, on ``device`` (default ``cuda``): the result of
    one lane (no lane axis)."""
    wl = workload.to(resolve_device(device))
    return make_run_fn(wl, policy, cfg)(initial_state(wl, cfg)).lane(0)


# ------------------------------------------------- prefilter auto-enable
#
# fks_tpu's measurement (PROFILE.md round 11, flat CPU): top-k node
# prefiltering pays 13-16x when the per-node policy is expensive (the VM
# code-candidate tier) and loses (~0.6x) when it is cheap (parametric dot
# products), where the step is queue-dominated and the gather is pure
# overhead. The break-even is a property of the policy's cost per call, so
# the heuristic keys on a measured probe. The constants are fks_tpu's,
# measured on its CPU; the card's probe values are in PERF.md.

#: k chosen when the heuristic enables prefiltering (the winning setting
#: of fks_tpu's sweep at 1k nodes)
PREFILTER_AUTO_K = 64
#: policy cost above which prefiltering wins (fks_tpu: parametric ~2e-5 s
#: per call, VM code candidates ~1e-3 s; the threshold sits an order of
#: magnitude clear of both)
PREFILTER_COST_THRESHOLD_S = 2e-4
#: below this node count the dense sweep is cheap whatever the policy
PREFILTER_MIN_NODES = 256
#: static per-node work bound below which a policy is trivially cheap and
#: the probe is skipped (``static_work_hint``)
PREFILTER_WORK_HINT_MIN = 16


def probe_policy_cost(param_policy, params, n_padded: int, g_padded: int,
                      reps: int = 5, device=None) -> float:
    """Steady-state seconds of one policy call at the padded cluster
    shape, one lane: the bare policy on all-ones views on ``device``
    (default ``cuda``), the minimum over ``reps`` timed calls after an
    untimed one. ``params`` are one candidate's.

    On CUDA the call's device time is measured: the call is captured once
    in a CUDA graph and each of the ``reps`` replays sits between two
    ``torch.cuda.Event``s, so the launch overhead of an eager call (which
    dwarfs a small policy's kernels) stays out of the reading. On the CPU
    each call is timed with ``perf_counter``."""
    import time as _time

    dev = resolve_device(device)
    params = map_tensors(lambda x: x.to(dev), params)

    def ones(*shape, dtype=torch.int32):
        return torch.ones(shape, dtype=dtype, device=dev)

    pod = PodView(*(ones(1, 1) for _ in range(6)))
    vn, vg = ones(1, n_padded), ones(1, n_padded, g_padded)
    nodes = NodeView(vn, vn, vn, vn, vn, vn, vg, vg, vg,
                     ones(1, n_padded, g_padded, dtype=torch.bool),
                     ones(1, n_padded, dtype=torch.bool))
    reps = max(1, reps)
    if dev.type != "cuda":
        param_policy(params, pod, nodes)  # warm-up, excluded
        best = float("inf")
        for _ in range(reps):
            t0 = _time.perf_counter()
            param_policy(params, pod, nodes)
            best = min(best, _time.perf_counter() - t0)
        return best
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        param_policy(params, pod, nodes)  # warm-up before the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capture(graph, side, "probe"):
        param_policy(params, pod, nodes)
    graph.replay()  # the first replay uploads the graph: untimed
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize(dev)
    return min(start.elapsed_time(end) for start, end in marks) * 1e-3


def auto_prefilter_k(n_padded: int, policy_cost_s: Optional[float], *,
                     override: Optional[int] = None,
                     k: int = PREFILTER_AUTO_K,
                     threshold_s: float = PREFILTER_COST_THRESHOLD_S,
                     min_nodes: int = PREFILTER_MIN_NODES) -> int:
    """Pick ``SimConfig.node_prefilter_k`` from a measured policy cost: an
    explicit ``override`` always wins; otherwise prefiltering turns on iff
    the node axis has at least ``min_nodes`` nodes and one policy call
    costs more than ``threshold_s``. A cost of None ("unknown") keeps the
    dense sweep."""
    if override is not None:
        return int(override)
    if n_padded < min_nodes:
        return 0
    if policy_cost_s is None or policy_cost_s <= threshold_s:
        return 0
    return k


def static_work_hint(code: str, g_padded: int) -> Optional[int]:
    """The ``work_hint`` of ``resolve_auto_prefilter`` for candidate
    source: the pre-flight cost model's per-node work bound
    (``analysis.preflight_check(code).cost.work(g_padded)``), as fks_tpu's
    serving path computes it (serve/artifact.py). None when the analyzer
    cannot price the source, and the heuristic then probes."""
    from fks_tpu_torch import analysis

    rep = analysis.preflight_check(code)
    if rep.ok and rep.cost is not None:
        return rep.cost.work(g_padded)
    return None


def resolve_auto_prefilter(param_policy, params, n_padded: int,
                           g_padded: int, *, override: Optional[int] = None,
                           recorder=None, work_hint: Optional[int] = None,
                           device=None, **heuristic_kw) -> int:
    """``auto_prefilter_k`` with the timing probe run only when its answer
    can matter: an override, a small node axis or a ``work_hint`` (for
    candidate source, ``static_work_hint``) below
    ``PREFILTER_WORK_HINT_MIN`` skips it. Records a ``prefilter_auto``
    event on ``recorder`` (default: ``obs.recorder.get_recorder()``) so a
    run shows why k was chosen."""
    from fks_tpu_torch.obs.recorder import get_recorder

    rec = recorder if recorder is not None else get_recorder()
    if override is not None:
        return int(override)
    min_nodes = heuristic_kw.get("min_nodes", PREFILTER_MIN_NODES)
    if n_padded < min_nodes:
        return 0
    if work_hint is not None and work_hint < PREFILTER_WORK_HINT_MIN:
        rec.event("prefilter_auto", policy_cost_s=None,
                  work_hint=int(work_hint), chosen_k=0, n_padded=n_padded)
        return 0
    cost = probe_policy_cost(param_policy, params, n_padded, g_padded,
                             device=device)
    chosen = auto_prefilter_k(n_padded, cost, **heuristic_kw)
    rec.event("prefilter_auto", policy_cost_s=round(cost, 7),
              chosen_k=chosen, n_padded=n_padded)
    return chosen
