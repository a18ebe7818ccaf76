"""A configuration's inputs, made once from its data files and handed to
both sides: the program under test gets them through its own readers and
constructors, the reference through ``reference.parse``.

A configuration's ``cluster`` is a node CSV (``"kind": "csv"``) or the
park's node manifests (``"node_yaml"``); its ``pods`` a pod CSV or a
``resampled`` stream that the benchmark draws from a pod CSV's rows
(``pod_stream``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from portbench.harness import DATA
from portbench.reference import parse


def reference_nodes(cfg: dict) -> List[dict]:
    c = cfg["cluster"]
    if c["kind"] == "csv":
        return parse.nodes_from_csv(
            DATA / "csv" / c["file"],
            parse.gpu_memory_map(DATA / cfg["gpu_memory_map"]))
    if c["kind"] == "node_yaml":
        return parse.nodes_from_yaml(DATA / "node_yaml" / c["file"])
    raise ValueError(f"unknown cluster kind {c['kind']!r}")


def pod_stream(spec: dict, nodes: List[dict]) -> List[dict]:
    """``spec["count"]`` pods drawn with replacement, from ``spec["seed"]``,
    from the rows of the pod CSV ``spec["file"]``, as the OpenB source
    inflates its trace onto the full node park. Each pod keeps its row's
    CPU, memory, GPU count, per-GPU milli and duration together. The
    arrivals are spread uniformly over a horizon sized so that the most
    loaded resource of ``nodes`` is ``spec["load"]`` busy on average over
    the horizon, each pod counted for the part of its life inside it.
    Pod names follow creation order."""
    rows = parse.pods_from_csv(DATA / "csv" / spec["file"])
    rng = np.random.default_rng(spec["seed"])
    n = spec["count"]
    pick = rng.integers(0, len(rows), n)
    arrive = np.sort(rng.random(n))
    col = {k: np.array([rows[i][k] for i in pick], np.int64)
           for k in ("cpu", "mem", "num_gpu", "gpu_milli", "dur")}
    cap = {"cpu": sum(x["cpu"] for x in nodes),
           "mem": sum(x["mem"] for x in nodes),
           "gpus": sum(len(x["gpus"]) for x in nodes),
           "milli": sum(sum(x["gpus"]) for x in nodes)}
    demand = {"cpu": col["cpu"], "mem": col["mem"], "gpus": col["num_gpu"],
              "milli": col["num_gpu"] * col["gpu_milli"]}
    dur = col["dur"].astype(np.float64)

    def busy(horizon: float) -> float:
        inside = np.minimum(dur / horizon, 1.0 - arrive)
        return max(float(np.sum(demand[k] * inside)) / cap[k]
                   for k in cap if cap[k] > 0)

    lo, hi = 1.0, 1e12  # busy(lo) >= load > busy(hi): halve the ratio
    for _ in range(200):
        mid = (lo * hi) ** 0.5
        lo, hi = (mid, hi) if busy(mid) >= spec["load"] else (lo, mid)
    ctime = np.floor(arrive * hi).astype(np.int64)
    return [{"name": f"rpod-{i:06d}", "cpu": int(col["cpu"][i]),
             "mem": int(col["mem"][i]), "num_gpu": int(col["num_gpu"][i]),
             "gpu_milli": int(col["gpu_milli"][i]), "ctime": int(ctime[i]),
             "dur": int(col["dur"][i])} for i in range(n)]


def reference_pods(cfg: dict, nodes: List[dict]) -> List[dict]:
    p = cfg["pods"]
    if p["kind"] == "csv":
        return parse.pods_from_csv(DATA / "csv" / p["file"])
    if p["kind"] == "resampled":
        return pod_stream(p, nodes)
    raise ValueError(f"unknown pod kind {p['kind']!r}")


def reference_inputs(cfg: dict, max_pods: Optional[int] = None
                     ) -> Tuple[parse.Cluster, parse.Pods, list]:
    """The reference's cluster and pods, and the pod rows themselves;
    ``max_pods`` keeps the first rows (tests at a small size)."""
    nodes = reference_nodes(cfg)
    rows = reference_pods(cfg, nodes)[:max_pods]
    return parse.Cluster(nodes), parse.Pods(rows), rows


def port_workload(cfg: dict, max_pods: Optional[int] = None):
    """The same inputs as the program's ``Workload``, through its own
    trace readers (``TraceParser``, ``parse_node_yaml``) and, for a drawn
    stream, its workload constructor; ``max_pods`` as in
    ``reference_inputs``."""
    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.data.build import make_workload
    from fks_tpu_torch.data.traces import parse_node_yaml

    c, p = cfg["cluster"], cfg["pods"]
    if c["kind"] == "csv" and p["kind"] == "csv":
        return TraceParser(traces_dir=DATA).parse_workload(
            node_file=c["file"].removesuffix(".gz"),
            pod_file=p["file"].removesuffix(".gz"), max_pods=max_pods)
    if c["kind"] == "node_yaml" and p["kind"] == "resampled":
        nodes = parse_node_yaml(
            path=DATA / "node_yaml" / c["file"].removesuffix(".gz"),
            traces_dir=DATA)
        rows = pod_stream(p, reference_nodes(cfg))[:max_pods]
        return make_workload(nodes, [{
            "pod_id": r["name"], "cpu_milli": r["cpu"],
            "memory_mib": r["mem"], "num_gpu": r["num_gpu"],
            "gpu_milli": r["gpu_milli"], "creation_time": r["ctime"],
            "duration_time": r["dur"]} for r in rows])
    raise ValueError(f"no port reader for {c['kind']} x {p['kind']}")
