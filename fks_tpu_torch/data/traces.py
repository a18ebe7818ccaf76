"""Host-side trace ingest: OpenB/Alibaba CSVs -> padded int32 tensors.

Port of fks_tpu.data.traces (the port keeps its own copy; it does not
import fks_tpu). Same schema and semantics:

- node CSV ``sn,cpu_milli,memory_mib,gpu,model`` + gpu_mem_mapping.json;
  every GPU gets 1000 milli; GPUs are materialized only when the model is
  in the mapping while ``gpu_declared`` keeps the CSV count;
- pod CSV ``name,cpu_milli,memory_mib,num_gpu,gpu_milli,...``;
  ``duration = deletion_time - creation_time``; empty ``gpu_milli`` -> 0;
- node order == CSV row order; files may be gzip-compressed;
- padding: nodes to a multiple of 8, pods to a multiple of 128;
- ``tie_rank`` = rank of the pod id in lexicographic order.

Parsing is host work; the result lives on the CPU until the caller moves
it (``Workload.to(device)``). ``parse_node_yaml`` reads the full OpenB
node park (1,213 nodes) from the vendored k8s node manifests.
"""
from __future__ import annotations

import csv
import gzip
import io
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from fks_tpu_torch.data.entities import ClusterArrays, PodArrays, Workload


def default_traces_dir() -> Path:
    """benchmarks/traces of the source checkout, else of the cwd."""
    checkout = (Path(__file__).resolve().parent.parent.parent
                / "benchmarks" / "traces")
    if checkout.is_dir():
        return checkout
    return Path.cwd() / "benchmarks" / "traces"


# per-GPU compute capacity (reference parser.py:45-46)
GPU_MILLI_CAPACITY = 1000


def _open_text(path: Path):
    """Open a csv that may exist as plain or .gz."""
    if path.exists():
        return open(path, "r", newline="")
    gz = path.with_name(path.name + ".gz")
    if gz.exists():
        return io.TextIOWrapper(gzip.open(gz, "rb"), newline="")
    raise FileNotFoundError(f"{path} (or {gz})")


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _parse_cpu_milli(v: str) -> int:
    """k8s CPU quantity -> milli-cores: ``64000m`` or bare cores."""
    v = v.strip().strip("'\"")
    if v.endswith("m"):
        return int(v[:-1])
    return int(float(v) * 1000)


def _parse_memory_mib(v: str) -> int:
    """k8s memory quantity -> MiB: ``262144Mi`` plus the Ki/Gi/Ti scales."""
    v = v.strip().strip("'\"")
    for suffix, scale in (("Mi", 1.0), ("Gi", 1024.0), ("Ti", 1024.0 * 1024),
                          ("Ki", 1.0 / 1024)):
        if v.endswith(suffix):
            return int(float(v[: -len(suffix)]) * scale)
    return int(v)


#: node-YAML keys lifted (allocatable block first -> first-seen wins)
_NODE_YAML_KEYS = {
    "alibabacloud.com/gpu-card-model": "model",
    "kubernetes.io/hostname": "hostname",
    "alibabacloud.com/gpu-count": "gpu_count",
    "alibabacloud.com/gpu-milli": "gpu_milli",
    "cpu": "cpu",
    "memory": "memory",
}


def parse_node_yaml(path: str | Path | None = None,
                    traces_dir: str | Path | None = None) -> List[dict]:
    """The full OpenB node park (1,213 nodes) from the k8s node manifests
    at ``benchmarks/traces/node_yaml/`` (gzipped or plain), as node dicts
    in ``data.build.make_cluster``'s schema, in manifest order. Per-GPU
    milli is ``gpu-milli / gpu-count``; GPU memory comes from
    ``gpu_mem_mapping.json`` by card model (0 when unmapped). The
    manifests are flat two-level YAML, read by line scanning."""
    base = (Path(traces_dir) if traces_dir is not None
            else default_traces_dir())
    if path is None:
        path = base / "node_yaml" / "openb_node_list_gpu_node.yaml"
    with open(base / "gpu_mem_mapping.json") as f:
        gpu_mem = json.load(f)

    nodes: List[dict] = []

    def flush(rec: Dict[str, str]) -> None:
        if "cpu" not in rec:  # blank separator documents
            return
        count = int(rec.get("gpu_count", "0").strip("'\""))
        milli = int(rec.get("gpu_milli", "0").strip("'\""))
        per_gpu = milli // count if count else 0
        nodes.append({
            "node_id": rec.get("hostname", f"openb-node-{len(nodes):04d}"),
            "cpu_milli": _parse_cpu_milli(rec["cpu"]),
            "memory_mib": _parse_memory_mib(rec["memory"]),
            "gpus": [per_gpu] * count,
            "gpu_memory_mib": int(gpu_mem.get(rec.get("model", ""), 0)),
        })

    rec: Dict[str, str] = {}
    with _open_text(Path(path)) as f:
        for line in f:
            stripped = line.strip()
            if stripped.startswith("---"):
                flush(rec)
                rec = {}
                continue
            key, sep, value = stripped.partition(":")
            if not sep:
                continue
            name = _NODE_YAML_KEYS.get(key.strip())
            # first-seen wins: the allocatable block precedes capacity
            if name is not None and value.strip() and name not in rec:
                rec[name] = value.strip()
    flush(rec)
    return nodes


class TraceParser:
    """Parse OpenB dataset traces into tensor simulation inputs
    (``parse_cluster`` / ``parse_pods`` / ``parse_workload``)."""

    def __init__(self, traces_dir: str | Path | None = None):
        self.traces_dir = (Path(traces_dir) if traces_dir is not None
                           else default_traces_dir())
        self.csv_dir = self.traces_dir / "csv"
        with open(self.traces_dir / "gpu_mem_mapping.json") as f:
            self.gpu_mem_mapping: Dict[str, int] = json.load(f)

    # ---------------------------------------------------------------- nodes
    def parse_cluster(self, node_file: str = "openb_node_list_gpu_node.csv",
                      pad_nodes_to: Optional[int] = None,
                      pad_gpus_to: Optional[int] = None) -> ClusterArrays:
        rows = self._read_csv(self.csv_dir / node_file)
        node_ids: List[str] = []
        cpu, mem, declared, materialized, gpu_mem = [], [], [], [], []
        for row in rows:
            node_ids.append(row["sn"])
            cpu.append(int(row["cpu_milli"]))
            mem.append(int(row["memory_mib"]))
            gcount = int(row["gpu"])
            model = row.get("model", "")
            declared.append(gcount)
            if gcount > 0 and model in self.gpu_mem_mapping:
                materialized.append(gcount)
                gpu_mem.append(self.gpu_mem_mapping[model])
            else:
                materialized.append(0)
                gpu_mem.append(0)

        n = len(node_ids)
        g_needed = max(materialized, default=0)
        n_pad = pad_nodes_to or _pad_to(n, 8)
        g_pad = pad_gpus_to or max(1, g_needed)
        if n_pad < n or g_pad < g_needed:
            raise ValueError(f"padding too small: nodes {n}>{n_pad} or "
                             f"gpus {g_needed}>{g_pad}")

        def vec(xs):
            out = np.zeros(n_pad, dtype=np.int32)
            out[:n] = xs
            return _t(out)

        gpu_mask = np.zeros((n_pad, g_pad), dtype=bool)
        gpu_milli_total = np.zeros((n_pad, g_pad), dtype=np.int32)
        gpu_mem_total = np.zeros((n_pad, g_pad), dtype=np.int32)
        for i in range(n):
            k = materialized[i]
            gpu_mask[i, :k] = True
            gpu_milli_total[i, :k] = GPU_MILLI_CAPACITY
            gpu_mem_total[i, :k] = gpu_mem[i]
        node_mask = np.zeros(n_pad, dtype=bool)
        node_mask[:n] = True

        return ClusterArrays(
            cpu_total=vec(cpu), mem_total=vec(mem), gpu_declared=vec(declared),
            num_gpus=vec(materialized), gpu_milli_total=_t(gpu_milli_total),
            gpu_mem_total=_t(gpu_mem_total), gpu_mask=_t(gpu_mask),
            node_mask=_t(node_mask), node_ids=tuple(node_ids))

    # ----------------------------------------------------------------- pods
    def parse_pods(self, pod_file: str = "openb_pod_list_default.csv",
                   pad_pods_to: Optional[int] = None,
                   max_pods: Optional[int] = None) -> PodArrays:
        """The pod table; ``max_pods`` keeps only the trace's first rows
        (cut before any array is made, so ranks and padding are the
        prefix's own)."""
        rows = self._read_csv(self.csv_dir / pod_file)[:max_pods]
        ids, cpu, mem, ngpu, gmilli, ctime, dur = [], [], [], [], [], [], []
        for row in rows:
            ids.append(row["name"])
            cpu.append(int(row["cpu_milli"]))
            mem.append(int(row["memory_mib"]))
            ngpu.append(int(row["num_gpu"]))
            gmilli.append(int(row["gpu_milli"]) if row.get("gpu_milli") else 0)
            creation = int(row.get("creation_time") or 0)
            deletion = int(row.get("deletion_time") or 0)
            ctime.append(creation)
            dur.append(deletion - creation)

        p = len(ids)
        p_pad = pad_pods_to or _pad_to(p, 128)
        if p_pad < p:
            raise ValueError(f"padding too small: pods {p}>{p_pad}")

        def vec(xs):
            out = np.zeros(p_pad, dtype=np.int32)
            out[:p] = xs
            return _t(out)

        order = sorted(range(p), key=lambda i: ids[i])
        rank = np.zeros(p_pad, dtype=np.int32)
        for r, i in enumerate(order):
            rank[i] = r
        pod_mask = np.zeros(p_pad, dtype=bool)
        pod_mask[:p] = True

        return PodArrays(
            cpu=vec(cpu), mem=vec(mem), num_gpu=vec(ngpu),
            gpu_milli=vec(gmilli), creation_time=vec(ctime),
            duration=vec(dur), tie_rank=_t(rank), pod_mask=_t(pod_mask),
            pod_ids=tuple(ids))

    # ------------------------------------------------------------- combined
    def parse_workload(self, node_file: str = "gpu_models_filtered.csv",
                       pod_file: str = "openb_pod_list_default.csv",
                       pad_nodes_to: Optional[int] = None,
                       pad_gpus_to: Optional[int] = None,
                       pad_pods_to: Optional[int] = None,
                       max_pods: Optional[int] = None) -> Workload:
        """Defaults match the reference benchmark workload: 16 nodes x
        8,152 pods; ``max_pods`` cuts the pod trace to its first rows."""
        cluster = self.parse_cluster(node_file, pad_nodes_to, pad_gpus_to)
        pods = self.parse_pods(pod_file, pad_pods_to, max_pods)
        return Workload(cluster=cluster, pods=pods)

    # ------------------------------------------------------------ discovery
    def get_available_node_files(self) -> List[str]:
        return sorted({f.name.removesuffix(".gz")
                       for f in self.csv_dir.glob("openb_node_list_*.csv*")})

    def get_available_pod_files(self) -> List[str]:
        return sorted({f.name.removesuffix(".gz")
                       for f in self.csv_dir.glob("openb_pod_list_*.csv*")})

    @staticmethod
    def _read_csv(path: Path) -> List[dict]:
        with _open_text(path) as f:
            return list(csv.DictReader(f))
