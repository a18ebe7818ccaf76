"""Synthetic trace generation and shape bucketing.

Port of fks_tpu.data.synthetic, in host numpy, so a seed gives the same
arrays as fks_tpu's:

- ``synthetic_workload``: clusters and pod streams of any size (up to
  100k pods x 1k nodes), shaped like the OpenB default trace: mostly
  1-GPU pods, a tail of 2/4/8-GPU jobs, ~13% CPU-only pods, a node park
  mixing CPU-only and 2/4/8-GPU machines of 1000 milli per GPU;
- shape buckets: workloads of different sizes padded up to shared
  (N, G, P) shapes, so one set of compiled kernels or captured graphs
  serves a bucket while padding waste stays bounded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from fks_tpu_torch.data.build import make_workload
from fks_tpu_torch.data.entities import ClusterArrays, PodArrays, Workload

#: Node archetypes: (weight, cpu_milli, memory_mib, gpu_count), after the
#: default 16-node park plus the CPU-only machines of the full park.
_NODE_TYPES = (
    (0.25, 32000, 131072, 0),
    (0.35, 64000, 262144, 2),
    (0.15, 96000, 393216, 4),
    (0.25, 128000, 786432, 8),
)

#: num_gpu distribution of GPU pods (default trace: {1: 6989, 2: 16,
#: 4: 15, 8: 44} of 7,064 GPU pods).
_GPU_COUNTS = ((1, 0.9894), (2, 0.0023), (4, 0.0021), (8, 0.0062))


def synthetic_workload(num_nodes: int, num_pods: int, seed: int = 0,
                       horizon: int = 12_900_000,
                       gpu_pod_frac: float = 0.8665,
                       load: float | None = 0.45,
                       pad_to: Tuple[int, int, int] | None = None,
                       nodes: Sequence[dict] | None = None) -> Workload:
    """A cluster + pod stream of the requested size, on the CPU.

    ``horizon`` is the creation-time span (default: the default trace's
    ~12.9M seconds). ``load`` rescales durations so the binding resource's
    expected concurrent demand is ``load`` x capacity (None skips it and
    allows oversubscription, which drives the retry and drop paths).
    ``pad_to`` forces (N, G, P) padded shapes. ``nodes`` injects a node
    park (``make_cluster`` dicts, e.g. ``traces.parse_node_yaml()``) in
    place of the archetype sampler; ``num_nodes`` selects its prefix."""
    rng = np.random.default_rng(seed)

    if nodes is not None:
        nodes = list(nodes)
        if num_nodes > len(nodes):
            raise ValueError(
                f"num_nodes {num_nodes} exceeds the injected node list "
                f"({len(nodes)} nodes)")
        nodes = nodes[:num_nodes]
    else:
        weights = np.array([t[0] for t in _NODE_TYPES])
        kinds = rng.choice(len(_NODE_TYPES), size=num_nodes,
                           p=weights / weights.sum())
        nodes = []
        for i, k in enumerate(kinds):
            _, cpu, mem, ng = _NODE_TYPES[k]
            nodes.append({
                "node_id": f"snode-{i:05d}", "cpu_milli": int(cpu),
                "memory_mib": int(mem), "gpus": [1000] * ng,
                "gpu_memory_mib": 16384,
            })

    is_gpu = rng.random(num_pods) < gpu_pod_frac
    counts = np.array([c for c, _ in _GPU_COUNTS])
    probs = np.array([p for _, p in _GPU_COUNTS])
    num_gpu = np.where(
        is_gpu, rng.choice(counts, size=num_pods, p=probs / probs.sum()), 0)
    gpu_milli = np.where(
        is_gpu, rng.choice((100, 250, 500, 1000), size=num_pods,
                           p=(0.2, 0.3, 0.3, 0.2)), 0)
    creation = np.sort(rng.integers(0, horizon, num_pods))
    duration = rng.integers(60, max(61, horizon // 4), num_pods)
    cpu = rng.integers(100, 16000, num_pods)
    mem = rng.integers(128, 65536, num_pods)

    if load is not None:
        # offered load per resource = sum(demand_i * dur_i) / (horizon *
        # capacity); rescale durations so the binding resource sits at load
        cap = {
            "cpu": sum(n["cpu_milli"] for n in nodes),
            "mem": sum(n["memory_mib"] for n in nodes),
            "gpus": sum(len(n["gpus"]) for n in nodes),
            "milli": sum(sum(n["gpus"]) for n in nodes),
        }
        demand = {
            "cpu": cpu.astype(np.int64), "mem": mem.astype(np.int64),
            "gpus": num_gpu.astype(np.int64),
            "milli": (num_gpu * gpu_milli).astype(np.int64),
        }
        worst = max(
            float(np.sum(demand[k] * duration.astype(np.int64)))
            / (horizon * cap[k])
            for k in cap if cap[k] > 0)
        if worst > 0:
            duration = np.maximum(
                60, (duration * (load / worst)).astype(np.int64))

    pods = [{
        "pod_id": f"spod-{i:06d}", "cpu_milli": int(cpu[i]),
        "memory_mib": int(mem[i]), "num_gpu": int(num_gpu[i]),
        "gpu_milli": int(gpu_milli[i]), "creation_time": int(creation[i]),
        "duration_time": int(duration[i]),
    } for i in range(num_pods)]

    pad = {}
    if pad_to is not None:
        pad = {"pad_nodes_to": pad_to[0], "pad_gpus_to": pad_to[1],
               "pad_pods_to": pad_to[2]}
    return make_workload(nodes, pods, **pad)


# ------------------------------------------------------------- bucketing

def _round_up(x: int, quantum: int) -> int:
    return max(quantum, -(-x // quantum) * quantum)


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """A shared padded shape."""

    n: int  # padded node count
    g: int  # padded per-node GPU count
    p: int  # padded pod count


def bucket_shape(wl: Workload, node_quantum: int = 16,
                 pod_quantum: int = 2048) -> BucketShape:
    """A workload's natural shape rounded up to bucket boundaries. The GPU
    width rounds to the next power of two (a 32-bit bitmask, cap 32)."""
    g = 1
    while g < max(1, wl.cluster.g_padded):
        g *= 2
    return BucketShape(
        n=_round_up(wl.cluster.num_nodes or 1, node_quantum),
        g=min(g, 32),
        p=_round_up(wl.num_pods or 1, pod_quantum))


def pad_workload(wl: Workload, shape: BucketShape) -> Workload:
    """An existing workload re-padded to a bucket shape, on its device
    (masks keep padding out of every decision and denominator)."""
    c, p = wl.cluster, wl.pods
    if shape.n < c.num_nodes or shape.g < c.g_padded \
            or shape.p < p.num_pods:
        raise ValueError(f"bucket {shape} smaller than workload "
                         f"({c.num_nodes}, {c.g_padded}, {p.num_pods})")

    def pad(a: torch.Tensor, *target) -> torch.Tensor:
        out = a.new_zeros(target + tuple(a.shape[len(target):]))
        out[tuple(slice(0, k) for k in a.shape[:len(target)])] = a
        return out

    cluster = ClusterArrays(
        cpu_total=pad(c.cpu_total, shape.n),
        mem_total=pad(c.mem_total, shape.n),
        gpu_declared=pad(c.gpu_declared, shape.n),
        num_gpus=pad(c.num_gpus, shape.n),
        gpu_milli_total=pad(c.gpu_milli_total, shape.n, shape.g),
        gpu_mem_total=pad(c.gpu_mem_total, shape.n, shape.g),
        gpu_mask=pad(c.gpu_mask, shape.n, shape.g),
        node_mask=pad(c.node_mask, shape.n), node_ids=c.node_ids)
    pods = PodArrays(
        cpu=pad(p.cpu, shape.p), mem=pad(p.mem, shape.p),
        num_gpu=pad(p.num_gpu, shape.p),
        gpu_milli=pad(p.gpu_milli, shape.p),
        creation_time=pad(p.creation_time, shape.p),
        duration=pad(p.duration, shape.p), tie_rank=pad(p.tie_rank, shape.p),
        pod_mask=pad(p.pod_mask, shape.p), pod_ids=p.pod_ids)
    return Workload(cluster=cluster, pods=pods)


def bucket_workloads(workloads: Sequence[Workload],
                     node_quantum: int = 16, pod_quantum: int = 2048,
                     ) -> Dict[BucketShape, List[Workload]]:
    """Workloads grouped by shared padded shape, each re-padded to it."""
    out: Dict[BucketShape, List[Workload]] = {}
    for wl in workloads:
        shape = bucket_shape(wl, node_quantum, pod_quantum)
        out.setdefault(shape, []).append(pad_workload(wl, shape))
    return out
