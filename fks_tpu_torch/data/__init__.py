"""Trace ingest and the struct-of-tensors data model."""
from fks_tpu_torch.data.build import make_workload
from fks_tpu_torch.data.entities import ClusterArrays, PodArrays, Workload
from fks_tpu_torch.data.traces import TraceParser

__all__ = ["ClusterArrays", "PodArrays", "TraceParser", "Workload",
           "make_workload"]
