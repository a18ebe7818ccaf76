"""Trace ingest and the struct-of-tensors data model."""
from fks_tpu_torch.data.build import make_workload
from fks_tpu_torch.data.entities import (
    ClusterArrays, FaultEvents, PodArrays, Workload,
)
from fks_tpu_torch.data.synthetic import (
    BucketShape, bucket_shape, bucket_workloads, pad_workload,
    synthetic_workload,
)
from fks_tpu_torch.data.traces import TraceParser, parse_node_yaml

__all__ = ["BucketShape", "ClusterArrays", "FaultEvents", "PodArrays",
           "TraceParser",
           "Workload", "bucket_shape", "bucket_workloads", "make_workload",
           "pad_workload", "parse_node_yaml", "synthetic_workload"]
