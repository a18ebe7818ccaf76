"""Field-by-field comparison of a port result with a reference, and the
small workloads the comparisons run on.

The split and tolerances are fks_tpu's own bar between its fused kernel
and its flat engine (tests/test_fused.py:24-45): integer observables must
be equal; float accumulators may differ by a few ulp (rtol = atol = 2e-6).
"""
from __future__ import annotations

import contextlib
from typing import Mapping

import numpy as np
import torch

INT_FIELDS = (
    "events_processed", "scheduled_pods", "num_snapshots",
    "num_fragmentation_events", "assigned_node", "assigned_gpus",
    "cpu_left", "mem_left", "gpu_left", "gpu_milli_left", "max_nodes",
    "truncated", "failed", "invariant_violations",
)
FLOAT_FIELDS = (
    "policy_score", "avg_cpu_utilization", "avg_memory_utilization",
    "avg_gpu_count_utilization", "avg_gpu_memory_utilization",
    "gpu_fragmentation_score",
)
RTOL = ATOL = 2e-6


@contextlib.contextmanager
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the engine's per-event tensors
    are tiny, so intra-op threads only spin and contend with other
    processes (as parallel test workers do)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def port_workload(ref, device="cpu"):
    """The port's copy of a reference workload object (anything with
    fks_tpu's ``cluster``/``pods`` field names), through numpy."""
    from fks_tpu_torch.convert import (
        CLUSTER_FIELDS, POD_FIELDS, workload_from_numpy,
    )

    cluster = {k: np.asarray(getattr(ref.cluster, k)) for k in CLUSTER_FIELDS}
    pods = {k: np.asarray(getattr(ref.pods, k)) for k in POD_FIELDS}
    cluster["node_ids"] = ref.cluster.node_ids
    pods["pod_ids"] = ref.pods.pod_ids
    return workload_from_numpy(cluster, pods, device=device)


def roomy_workload():
    """4 roomy 8-GPU nodes x 48 pods: every pod places (fks_tpu's
    tests/test_fused.py ``_roomy``, same seed and specs)."""
    from fks_tpu_torch.data.build import make_workload

    rng = np.random.default_rng(11)
    nodes = [{"node_id": f"n{i}", "cpu_milli": 64000, "memory_mib": 262144,
              "gpus": [1000] * 8, "gpu_memory_mib": 16384} for i in range(4)]
    pods = [{"pod_id": f"pod-{i:04d}",
             "cpu_milli": int(rng.integers(100, 1500)),
             "memory_mib": int(rng.integers(100, 4000)),
             "num_gpu": int(rng.integers(0, 3)),
             "gpu_milli": int(rng.integers(1, 300)),
             "creation_time": int(rng.integers(0, 1000)),
             "duration_time": int(rng.integers(0, 500))}
            for i in range(48)]
    for p in pods:
        if p["num_gpu"] == 0:
            p["gpu_milli"] = 0
    return make_workload(nodes, pods, pad_nodes_to=4, pad_gpus_to=8,
                         pad_pods_to=64)


def contended_workload():
    """4 small 2-GPU nodes x 96 pods: retries, fragmentation events, silent
    drops and (under a tight max_steps) truncation (fks_tpu's
    tests/test_fused.py ``_contended``, same seed and specs)."""
    from fks_tpu_torch.data.build import make_workload

    rng = np.random.default_rng(7)
    nodes = [{"node_id": f"n{i}", "cpu_milli": 16000, "memory_mib": 32000,
              "gpus": [1000] * 2, "gpu_memory_mib": 8000} for i in range(4)]
    pods = [{"pod_id": f"pod-{i:04d}",
             "cpu_milli": int(rng.integers(500, 6000)),
             "memory_mib": int(rng.integers(500, 12000)),
             "num_gpu": int(rng.integers(0, 3)),
             "gpu_milli": int(rng.integers(100, 1000)),
             "creation_time": int(rng.integers(0, 300)),
             "duration_time": int(rng.integers(10, 200))}
            for i in range(96)]
    for p in pods:
        if p["num_gpu"] == 0:
            p["gpu_milli"] = 0
    return make_workload(nodes, pods, pad_nodes_to=4, pad_gpus_to=2,
                         pad_pods_to=128)


def result_fields(result) -> dict:
    """The compared fields of any result object (a port ``SimResult`` or
    fks_tpu's) as numpy arrays."""
    out = {}
    for f in INT_FIELDS + FLOAT_FIELDS:
        v = getattr(result, f)
        out[f] = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
    return out


def assert_result_matches(result, ref: Mapping[str, np.ndarray],
                          rtol: float = RTOL, atol: float = ATOL) -> None:
    """Integer fields exact, float fields within rtol/atol."""
    got = result_fields(result)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(ref[f]), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(ref[f]), rtol=rtol,
                                   atol=atol, err_msg=f)
