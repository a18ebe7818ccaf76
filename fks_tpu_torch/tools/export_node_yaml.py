"""Export a node list as Kubernetes Node manifests (k8s-style YAML).

Port of fks_tpu's ``tools/export_node_yaml.py`` (stdlib only; byte for
byte the same output). Each row of a node CSV becomes a ``kind: Node``
document with Alibaba GPU extended-resource annotations
(``alibabacloud.com/gpu-count`` / ``gpu-milli`` / ``gpu-card-model``),
cpu in millicores, memory in Mi and the OpenB fixed pods capacity of
1001; a ``.gz`` output is gzipped with a fixed mtime, so regeneration is
reproducible.

Unlike fks_tpu's tool, ``--out`` has no default: it writes only where
it is told, never into ``benchmarks/`` unasked.

Usage:
  python -m fks_tpu_torch.tools.export_node_yaml --out FILE[.gz]
      [--nodes benchmarks/traces/csv/openb_node_list_gpu_node.csv.gz]
"""
from __future__ import annotations

import argparse
import csv
import gzip
import io
import os
import sys
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRACES = os.path.join(REPO, "benchmarks", "traces")

#: OpenB node manifests carry a fixed max-pods capacity of 1001.
PODS_CAPACITY = 1001

_DOC = """apiVersion: v1
kind: Node
metadata:
  labels:
{labels}    kubernetes.io/os: linux
  name: {name}
status:
  allocatable:
{resources}  capacity:
{resources}"""


def _resources(cpu_milli: int, memory_mib: int, gpu: int) -> str:
    lines = []
    if gpu > 0:
        lines.append(f"    alibabacloud.com/gpu-count: '{gpu}'")
        lines.append(f"    alibabacloud.com/gpu-milli: '{gpu * 1000}'")
    lines.append(f"    cpu: {cpu_milli}m")
    lines.append(f"    memory: {memory_mib}Mi")
    lines.append(f"    pods: '{PODS_CAPACITY}'")
    return "\n".join(lines) + "\n"


def render_node(sn: str, cpu_milli: int, memory_mib: int, gpu: int,
                model: str) -> str:
    labels = ""
    if gpu > 0 and model:
        labels += f"    alibabacloud.com/gpu-card-model: {model}\n"
    labels += "    beta.kubernetes.io/os: linux\n"
    labels += f"    kubernetes.io/hostname: {sn}\n"
    return _DOC.format(labels=labels, name=sn,
                       resources=_resources(cpu_milli, memory_mib, gpu))


def export(nodes_csv: str, out_path: str) -> int:
    """Render every row of ``nodes_csv`` into ``out_path``; returns the
    number of Node documents written."""
    opener = gzip.open if nodes_csv.endswith(".gz") else open
    with opener(nodes_csv, "rt") as f:
        rows = list(csv.DictReader(f))
    docs = [render_node(r["sn"], int(r["cpu_milli"]), int(r["memory_mib"]),
                        int(r["gpu"]), r.get("model", ""))
            for r in rows]
    body = "\n---\n\n".join(docs)
    buf = io.StringIO()
    buf.write(body)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    if out_path.endswith(".gz"):
        # fixed mtime so regeneration is reproducible byte-for-byte
        with open(out_path, "wb") as raw, \
                gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as gz:
            gz.write(buf.getvalue().encode())
    else:
        with open(out_path, "w") as f:
            f.write(buf.getvalue())
    return len(docs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fks_tpu_torch.tools.export_node_yaml",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", default=os.path.join(
        TRACES, "csv", "openb_node_list_gpu_node.csv.gz"))
    ap.add_argument("--out", required=True,
                    help="the manifest file to write (.gz: gzipped)")
    args = ap.parse_args(argv)
    n = export(args.nodes, args.out)
    print(f"wrote {n} Node manifests to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
