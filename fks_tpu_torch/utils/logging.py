"""Namespaced logging and JSONL metrics.

Port of fks_tpu.utils.logging:

- ``get_logger``: namespaced stdlib loggers under ``fks_tpu_torch``,
  configured once, level from ``FKS_LOG_LEVEL`` (default INFO);
- ``json_ready``: the ``json.dumps`` ``default=`` hook that turns numpy
  scalars and arrays and torch tensors into plain Python;
- ``result_record``: a ``SimResult`` flattened into fks_tpu's metric
  schema (plain floats, ints and bools);
- ``MetricsWriter``: append-only JSONL records, one flushed line per
  record, each stamped with ``ts`` and ``kind`` (the flight recorder's
  ``events.jsonl`` and ``metrics.jsonl`` are two of them).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import IO, Any, Dict, Optional

import torch

_CONFIGURED = False


def json_ready(obj: Any) -> Any:
    """``json.dumps`` ``default=`` hook: coerce numpy and torch leaves to
    plain Python. A tensor is copied to the host explicitly (a CUDA
    tensor included) and becomes its Python value when it is 0-d, else
    nested lists; numpy scalars and 0-d arrays become their value via
    ``.item()``, arrays nested lists via ``.tolist()``. Anything else
    raises ``TypeError`` as ``json.dumps`` would, so a record that cannot
    be written fails loudly."""
    if isinstance(obj, torch.Tensor):
        host = obj.detach().to("cpu")
        return host.item() if host.ndim == 0 else host.tolist()
    if getattr(obj, "ndim", None) == 0 and hasattr(obj, "item"):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(
        f"Object of type {type(obj).__name__} is not JSON serializable")


def get_logger(name: str = "fks_tpu_torch") -> logging.Logger:
    """A logger under ``fks_tpu_torch``; configures that root once, level
    from ``FKS_LOG_LEVEL`` (default INFO)."""
    global _CONFIGURED
    root = logging.getLogger("fks_tpu_torch")
    if not _CONFIGURED:
        level = os.environ.get("FKS_LOG_LEVEL", "INFO").upper()
        root.setLevel(getattr(logging, level, logging.INFO))
        if not root.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname).1s %(message)s",
                datefmt="%H:%M:%S"))
            root.addHandler(h)
        root.propagate = False
        _CONFIGURED = True
    if name == "fks_tpu_torch" or name.startswith("fks_tpu_torch."):
        return logging.getLogger(name)
    return logging.getLogger(f"fks_tpu_torch.{name}")


def result_record(result, **extra) -> Dict[str, Any]:
    """Flatten a one-lane ``SimResult`` (0-d tensors, on any device)
    into fks_tpu's reference-compatible metric schema: the same keys, as
    plain floats, ints and bools (fks_tpu/utils/logging.py:64-83)."""
    rec = {
        "policy_score": float(result.policy_score),
        "avg_cpu_utilization": float(result.avg_cpu_utilization),
        "avg_memory_utilization": float(result.avg_memory_utilization),
        "avg_gpu_count_utilization": float(result.avg_gpu_count_utilization),
        "avg_gpu_memory_utilization": float(result.avg_gpu_memory_utilization),
        "gpu_fragmentation_score": float(result.gpu_fragmentation_score),
        "num_snapshots": int(result.num_snapshots),
        "num_fragmentation_events": int(result.num_fragmentation_events),
        "events_processed": int(result.events_processed),
        "scheduled_pods": int(result.scheduled_pods),
        "max_nodes": int(result.max_nodes),
        "failed": bool(result.failed),
        "truncated": bool(result.truncated),
    }
    rec.update(extra)
    return rec


class MetricsWriter:
    """Append JSON lines (one record per call) to a file or a stream.

    Each record gets a ``ts`` wall-clock field and its ``kind``. Every
    write is flushed, so an interrupted run still leaves a complete
    trail, and a lock keeps one line per call when threads share the
    writer (the batcher thread and a promotion poll thread both record).
    """

    def __init__(self, path_or_stream):
        if isinstance(path_or_stream, (str, os.PathLike)):
            parent = os.path.dirname(os.fspath(path_or_stream))
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._f: IO[str] = open(path_or_stream, "a")
            self._owns = True
        else:
            self._f = path_or_stream
            self._owns = False
        self._lock = threading.Lock()

    def write(self, kind: str, record: Optional[Dict[str, Any]] = None,
              **fields) -> None:
        rec = {"ts": time.time(), "kind": kind}
        if record:
            rec.update(record)
        rec.update(fields)
        line = json.dumps(rec, default=json_ready) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        if self._owns:
            self._f.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
