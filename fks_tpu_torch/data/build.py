"""Programmatic workload construction (tests, small synthetic cases).

Port of fks_tpu.data.build: the same padded structures the CSV parser
emits, from plain Python specs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from fks_tpu_torch.data.entities import ClusterArrays, PodArrays, Workload


def make_cluster(nodes: Sequence[dict], pad_nodes_to: Optional[int] = None,
                 pad_gpus_to: Optional[int] = None) -> ClusterArrays:
    """nodes: dicts with node_id, cpu_milli, memory_mib, and either
    ``gpus`` (per-GPU milli capacities) or ``gpu_count`` +
    ``gpu_milli_capacity``; optional ``gpu_memory_mib``, ``gpu_declared``."""
    n = len(nodes)
    n_pad = pad_nodes_to or max(1, n)
    caps = []
    for spec in nodes:
        if "gpus" in spec:
            caps.append(list(spec["gpus"]))
        else:
            caps.append([spec.get("gpu_milli_capacity", 1000)]
                        * spec.get("gpu_count", 0))
    g_pad = pad_gpus_to or max(1, max((len(c) for c in caps), default=1))

    cpu = np.zeros(n_pad, np.int32)
    mem = np.zeros(n_pad, np.int32)
    declared = np.zeros(n_pad, np.int32)
    num = np.zeros(n_pad, np.int32)
    gmt = np.zeros((n_pad, g_pad), np.int32)
    gmem = np.zeros((n_pad, g_pad), np.int32)
    gmask = np.zeros((n_pad, g_pad), bool)
    nmask = np.zeros(n_pad, bool)
    for i, spec in enumerate(nodes):
        cpu[i] = spec["cpu_milli"]
        mem[i] = spec["memory_mib"]
        k = len(caps[i])
        declared[i] = spec.get("gpu_declared", k)
        num[i] = k
        gmt[i, :k] = caps[i]
        gmem[i, :k] = spec.get("gpu_memory_mib", 0)
        gmask[i, :k] = True
        nmask[i] = True
    t = torch.from_numpy
    return ClusterArrays(
        cpu_total=t(cpu), mem_total=t(mem), gpu_declared=t(declared),
        num_gpus=t(num), gpu_milli_total=t(gmt), gpu_mem_total=t(gmem),
        gpu_mask=t(gmask), node_mask=t(nmask),
        node_ids=tuple(s["node_id"] for s in nodes))


def make_pods(pods: Sequence[dict],
              pad_pods_to: Optional[int] = None) -> PodArrays:
    """pods: dicts with pod_id, cpu_milli, memory_mib, num_gpu, gpu_milli,
    creation_time, duration_time."""
    p = len(pods)
    p_pad = pad_pods_to or max(1, p)
    arr = {k: np.zeros(p_pad, np.int32) for k in
           ("cpu", "mem", "num_gpu", "gpu_milli", "creation_time", "duration")}
    mask = np.zeros(p_pad, bool)
    ids = [s["pod_id"] for s in pods]
    for i, spec in enumerate(pods):
        arr["cpu"][i] = spec["cpu_milli"]
        arr["mem"][i] = spec["memory_mib"]
        arr["num_gpu"][i] = spec["num_gpu"]
        arr["gpu_milli"][i] = spec["gpu_milli"]
        arr["creation_time"][i] = spec["creation_time"]
        arr["duration"][i] = spec["duration_time"]
        mask[i] = True
    order = sorted(range(p), key=lambda i: ids[i])
    rank = np.zeros(p_pad, np.int32)
    for r, i in enumerate(order):
        rank[i] = r
    return PodArrays(tie_rank=torch.from_numpy(rank),
                     pod_mask=torch.from_numpy(mask), pod_ids=tuple(ids),
                     **{k: torch.from_numpy(v) for k, v in arr.items()})


def make_workload(nodes: Sequence[dict], pods: Sequence[dict],
                  **pad) -> Workload:
    return Workload(
        cluster=make_cluster(nodes, pad.get("pad_nodes_to"),
                             pad.get("pad_gpus_to")),
        pods=make_pods(pods, pad.get("pad_pods_to")))
