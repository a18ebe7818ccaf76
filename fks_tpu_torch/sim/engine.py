"""Pieces shared by every engine: config, loop sizing, node view, fitness.

Port of the shared half of fks_tpu.sim.engine — ``SimConfig``,
``loop_tables``, ``_node_view`` and ``finalize_fields``. The exact heap
engine itself (``build_step`` / ``simulate`` over ``ops/heap.py``) waits
for a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from fks_tpu_torch.data.entities import ClusterArrays, Workload
from fks_tpu_torch.sim.evaluator import (
    max_snapshot_count, snapshot_trigger_table,
)
from fks_tpu_torch.sim.types import NodeView, SimResult


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation knobs (fks_tpu.sim.engine.SimConfig). The flags
    the port does not implement yet (``validate_invariants``, ``watchdog``,
    ``decision_trace``, ``probe_score``, ``node_prefilter_k``,
    ``state_pack``) are kept so that setting one raises a ValueError that
    names the slice it waits for, instead of a TypeError."""

    max_steps_factor: int = 8  # runaway guard: max events = factor * num_pods
    max_steps: Optional[int] = None  # overrides the factor when set
    snapshot_interval: float = 0.05
    gpu_allocator: str = "best_fit"  # or "first_fit"
    score_dtype: Any = torch.float32  # evaluator accumulation dtype
    validate_invariants: bool = False
    # wait-histogram width override (must exceed the trace's max gpu_milli)
    wait_hist_size: Optional[int] = None
    # maintain SimResult.pod_ctime (retry-mutated creation times); a
    # per-event queue write that throughput paths turn off
    track_ctime: bool = True
    watchdog: bool = False
    decision_trace: bool = False
    probe_score: bool = False
    node_prefilter_k: int = 0
    state_pack: bool = False

    def resolve_max_steps(self, num_pods: int) -> int:
        if self.max_steps is not None:
            return self.max_steps
        return max(64, self.max_steps_factor * num_pods)


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


def _node_view(c: ClusterArrays, cpu_left, mem_left, gpu_left,
               gpu_milli_left) -> NodeView:
    return NodeView(
        cpu_milli_left=cpu_left, cpu_milli_total=c.cpu_total,
        memory_mib_left=mem_left, memory_mib_total=c.mem_total,
        gpu_left=gpu_left, num_gpus=c.num_gpus,
        gpu_milli_left=gpu_milli_left, gpu_milli_total=c.gpu_milli_total,
        gpu_mem_total=c.gpu_mem_total, gpu_mask=c.gpu_mask,
        node_mask=c.node_mask)


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


def finalize_fields(workload: Workload, cfg: SimConfig, *, pending,
                    s: FinalView) -> SimResult:
    """Fitness + results (reference evaluator.py:77-127) for L lanes.
    ``pending`` is bool[L]: events remain unprocessed."""
    f = cfg.score_dtype
    dev = s.snap_idx.device
    pod_mask = workload.pods.pod_mask
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
    gate = (n_snap > 0) & all_assigned & ~s.failed & ~truncated
    score = torch.where(gate, raw, torch.zeros((), dtype=raw.dtype,
                                                device=dev))
    scheduled = ((s.assigned_node >= 0) & pod_mask).sum(
        dim=-1, dtype=torch.int32)
    zeros = torch.zeros_like(n_snap)
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
        truncated=truncated, invariant_violations=zeros,
        numeric_flags=zeros.clone(),
    )
