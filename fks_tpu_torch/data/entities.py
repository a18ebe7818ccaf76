"""Struct-of-tensors data model for cluster + workload state.

Port of fks_tpu.data.entities: the same padded, fixed-shape integer arrays,
held as dataclasses of tensors instead of pytrees. Conventions are
fks_tpu's:

- node axis ``N`` (padded), per-node GPU axis ``G`` (padded), pod axis
  ``P`` (padded), each masked by ``node_mask`` / ``gpu_mask`` /
  ``pod_mask``;
- resource quantities are int32, masks are bool.

The size properties read the LAST axis, so they also hold for a stack of
same-shape workloads (``parallel.traces.stack_traces``: every tensor with
a leading trace axis ``T``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field on ``device``."""
    moved = {f.name: getattr(obj, f.name).to(device)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **moved)


@dataclasses.dataclass
class ClusterArrays:
    """Initial cluster state. ``gpu_declared`` (the CSV count, initial
    ``gpu_left``) may exceed ``num_gpus`` (materialized GPUs), as in the
    reference parser."""

    cpu_total: torch.Tensor  # i32[N]
    mem_total: torch.Tensor  # i32[N]
    gpu_declared: torch.Tensor  # i32[N]
    num_gpus: torch.Tensor  # i32[N]
    gpu_milli_total: torch.Tensor  # i32[N, G]
    gpu_mem_total: torch.Tensor  # i32[N, G]
    gpu_mask: torch.Tensor  # bool[N, G]
    node_mask: torch.Tensor  # bool[N]
    node_ids: tuple = ()  # host-side names, real nodes only

    @property
    def n_padded(self) -> int:
        return int(self.cpu_total.shape[-1])

    @property
    def g_padded(self) -> int:
        return int(self.gpu_milli_total.shape[-1])

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    def totals(self) -> dict:
        """Cluster-wide capacity totals (reference: evaluator.py:35-38)."""
        return {
            "cpu": int(self.cpu_total.sum()),
            "memory": int(self.mem_total.sum()),
            "gpu_count": int(self.num_gpus.sum()),
            "gpu_milli": int(self.gpu_milli_total.sum()),
        }

    def to(self, device) -> "ClusterArrays":
        return _to(self, device)


@dataclasses.dataclass
class PodArrays:
    """Pod requests in input order. ``tie_rank`` is the rank of the pod id
    in lexicographic string order (the reference's equal-time tie-break)."""

    cpu: torch.Tensor  # i32[P]
    mem: torch.Tensor  # i32[P]
    num_gpu: torch.Tensor  # i32[P]
    gpu_milli: torch.Tensor  # i32[P]
    creation_time: torch.Tensor  # i32[P]
    duration: torch.Tensor  # i32[P]
    tie_rank: torch.Tensor  # i32[P]
    pod_mask: torch.Tensor  # bool[P]
    pod_ids: tuple = ()  # host-side names, real pods only

    @property
    def p_padded(self) -> int:
        return int(self.cpu.shape[-1])

    @property
    def num_pods(self) -> int:
        return len(self.pod_ids)

    def to(self, device) -> "PodArrays":
        return _to(self, device)


@dataclasses.dataclass
class FaultEvents:
    """A node fault timeline (fks_tpu.data.entities.FaultEvents): one row
    per NODE_DOWN / NODE_UP event, padded to ``F`` rows and masked like
    every other axis. Both engines merge the rows into the event stream
    ahead of equal-time pod events and flip a per-node availability bit: a
    downed node is cordoned (scores 0 for new placements) until its
    NODE_UP, and running pods are not evicted."""

    time: torch.Tensor  # i32[F] event times (padding: INT32_MAX)
    node: torch.Tensor  # i32[F] node index of the event (padding: 0)
    kind: torch.Tensor  # i32[F] ops.heap.KIND_NODE_DOWN | KIND_NODE_UP
    mask: torch.Tensor  # bool[F] real rows

    @property
    def f_padded(self) -> int:
        return int(self.time.shape[-1])

    @property
    def num_events(self) -> int:
        return int(self.mask.sum())

    def to(self, device) -> "FaultEvents":
        return _to(self, device)


@dataclasses.dataclass
class Workload:
    """A (cluster, pods) pair — the unit of simulation input. ``faults`` is
    None for a plain workload or the ``FaultEvents`` timeline of a
    scenario variant (fks_tpu_torch.scenarios)."""

    cluster: ClusterArrays
    pods: PodArrays
    faults: Optional[FaultEvents] = None

    @property
    def num_nodes(self) -> int:
        return self.cluster.num_nodes

    @property
    def num_pods(self) -> int:
        return self.pods.num_pods

    @property
    def device(self) -> torch.device:
        return self.cluster.cpu_total.device

    def to(self, device) -> "Workload":
        return dataclasses.replace(
            self, cluster=self.cluster.to(device), pods=self.pods.to(device),
            faults=None if self.faults is None else self.faults.to(device))
