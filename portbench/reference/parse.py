"""The benchmark's own reading of the raw input files.

Plain Python and NumPy: the node CSV (``sn,cpu_milli,memory_mib,gpu,
model``), the pod CSV (``name,cpu_milli,memory_mib,num_gpu,gpu_milli,...,
creation_time,deletion_time``), the Kubernetes node manifests of the full
OpenB park, and the card-model memory map. The semantics are those of the
reference simulator's parser: every GPU holds 1,000 milli, a GPU exists
only when its card model is in the memory map while the node's declared
GPU count stays the CSV's, a pod lives from its creation to its deletion
time, and pods tie-break on their names in string order.

Nothing here imports the program under test.
"""
from __future__ import annotations

import csv
import gzip
import io
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

GPU_MILLI = 1000


def _open_text(path: Path):
    path = Path(path)
    if path.suffix == ".gz":
        return io.TextIOWrapper(gzip.open(path, "rb"), newline="")
    return open(path, "r", newline="")


def read_csv(path) -> List[dict]:
    with _open_text(path) as f:
        return list(csv.DictReader(f))


def gpu_memory_map(path) -> Dict[str, int]:
    with open(path) as f:
        return json.load(f)


def nodes_from_csv(path, mem_map: Dict[str, int]) -> List[dict]:
    """Node dicts: ``cpu``, ``mem``, ``declared`` (the CSV's GPU count) and
    ``gpus`` (per-GPU milli of the GPUs that exist)."""
    out = []
    for row in read_csv(path):
        count = int(row["gpu"])
        real = count if count > 0 and row.get("model", "") in mem_map else 0
        out.append({"name": row["sn"], "cpu": int(row["cpu_milli"]),
                    "mem": int(row["memory_mib"]), "declared": count,
                    "gpus": [GPU_MILLI] * real})
    return out


def _cpu_milli(v: str) -> int:
    v = v.strip().strip("'\"")
    return int(v[:-1]) if v.endswith("m") else int(float(v) * 1000)


def _memory_mib(v: str) -> int:
    v = v.strip().strip("'\"")
    scale = {"Ki": 1.0 / 1024, "Mi": 1.0, "Gi": 1024.0, "Ti": 1024.0 ** 2}
    for suffix, k in scale.items():
        if v.endswith(suffix):
            return int(float(v[:-2]) * k)
    return int(v)


def nodes_from_yaml(path) -> List[dict]:
    """The node park from flat Kubernetes node manifests, in file order.
    The ``allocatable`` block comes before ``capacity`` and its values are
    the ones taken. Per-GPU milli is ``gpu-milli / gpu-count``."""
    keys = {"alibabacloud.com/gpu-count": "count",
            "alibabacloud.com/gpu-milli": "milli",
            "kubernetes.io/hostname": "name", "cpu": "cpu",
            "memory": "memory"}
    out: List[dict] = []
    rec: Dict[str, str] = {}

    def flush():
        if "cpu" not in rec:
            return
        count = int(rec.get("count", "0").strip("'\""))
        milli = int(rec.get("milli", "0").strip("'\""))
        out.append({"name": rec.get("name", f"node-{len(out)}"),
                    "cpu": _cpu_milli(rec["cpu"]),
                    "mem": _memory_mib(rec["memory"]), "declared": count,
                    "gpus": [milli // count if count else 0] * count})

    with _open_text(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("---"):
                flush()
                rec = {}
                continue
            k, sep, v = s.partition(":")
            name = keys.get(k.strip())
            if sep and name is not None and v.strip() and name not in rec:
                rec[name] = v.strip()
    flush()
    return out


def pods_from_csv(path) -> List[dict]:
    out = []
    for row in read_csv(path):
        c = int(row.get("creation_time") or 0)
        d = int(row.get("deletion_time") or 0)
        out.append({"name": row["name"], "cpu": int(row["cpu_milli"]),
                    "mem": int(row["memory_mib"]),
                    "num_gpu": int(row["num_gpu"]),
                    "gpu_milli": int(row.get("gpu_milli") or 0),
                    "ctime": c, "dur": d - c})
    return out


class Cluster:
    """Node tables as NumPy arrays: ``[N]`` per node, ``[N, G]`` per GPU
    slot (``G`` the most GPUs any node has; absent slots masked)."""

    def __init__(self, nodes: List[dict]):
        n = len(nodes)
        g = max(1, max((len(x["gpus"]) for x in nodes), default=1))
        self.names = [x["name"] for x in nodes]
        self.cpu = np.array([x["cpu"] for x in nodes], np.int64)
        self.mem = np.array([x["mem"] for x in nodes], np.int64)
        self.declared = np.array([x["declared"] for x in nodes], np.int64)
        self.num_gpus = np.array([len(x["gpus"]) for x in nodes], np.int64)
        self.gpu_mask = np.zeros((n, g), bool)
        self.gpu_milli = np.zeros((n, g), np.int64)
        for i, x in enumerate(nodes):
            k = len(x["gpus"])
            self.gpu_mask[i, :k] = True
            self.gpu_milli[i, :k] = x["gpus"]
        self.n, self.g = n, g


class Pods:
    """Pod columns in input order, and ``order``: input indices sorted by
    pod name (the tie-break among events at the same time)."""

    def __init__(self, pods: List[dict]):
        self.names = [p["name"] for p in pods]
        for k in ("cpu", "mem", "num_gpu", "gpu_milli", "ctime", "dur"):
            setattr(self, k, np.array([p[k] for p in pods], np.int64))
        self.order = np.array(sorted(range(len(pods)),
                                     key=lambda i: self.names[i]), np.int64)
        self.count = len(pods)
