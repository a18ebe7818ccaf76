"""Compile/device telemetry: a counter of CUDA graph captures + snapshots.

Port of fks_tpu.obs.telemetry. fks_tpu separates compile time from
steady-state device time with a ``jax.monitoring`` listener on XLA's
compile events. PyTorch runs eagerly and compiles nothing per shape; what
the port "compiles" is a CUDA graph, captured once per shape and replayed
after. So the counterpart counts captures:

- ``graph_capture(label)``: the context every capture site of the port
  wraps its ``torch.cuda.graph(...)`` in (``sim.engine.GraphedChunk``,
  ``sim.engine.probe_policy_cost``). On exit it reports the capture's
  wall seconds to every installed watcher.
- ``CompileWatcher``: while installed, records each capture as
  (key, seconds) and appends one ``kind="compile"`` event to its
  recorder. ``backend_compile_count`` / ``backend_compile_seconds`` are
  the captures and their seconds: "zero recompiles on the warm path"
  reads as zero captures.
- ``device_snapshot``/``record_devices``: per-device identity plus the
  caching allocator's counters (``torch.cuda.memory_stats``), None on
  the CPU;
- ``mesh_snapshot``/``record_mesh``: a ``parallel.mesh.Mesh``'s axes,
  shape, device and shard counts, and the pad-lane waste of a padded
  population.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from fks_tpu_torch.obs.recorder import get_recorder

#: the event-key family of one graph capture
COMPILE_PREFIX = "/torch/cuda/graph"
#: the key suffix of a capture (fks_tpu's backend-compile counterpart)
BACKEND_COMPILE = "capture"

_watchers: List["CompileWatcher"] = []
_watchers_lock = threading.Lock()


@contextlib.contextmanager
def graph_capture(label: str) -> Iterator[None]:
    """Wrap one CUDA graph capture: its wall seconds go to every installed
    ``CompileWatcher`` as key ``/torch/cuda/graph/<label>/capture``. A
    capture that raises reports nothing."""
    t0 = time.perf_counter()
    yield
    seconds = time.perf_counter() - t0
    with _watchers_lock:
        watchers = list(_watchers)
    key = f"{COMPILE_PREFIX}/{label}/{BACKEND_COMPILE}"
    for w in watchers:
        w._listen(key, seconds)


class CompileWatcher:
    """Capture every CUDA graph capture's (key, duration) while installed.

    Watchers are process-wide and additive, as ``jax.monitoring``
    listeners are: a capture on any thread reports to every installed
    watcher. Usable as a context manager::

        with CompileWatcher(recorder) as w:
            ...  # any graph captures in here are counted
        w.backend_compile_count, w.backend_compile_seconds
    """

    def __init__(self, recorder=None, prefix: str = COMPILE_PREFIX):
        self.recorder = recorder if recorder is not None else get_recorder()
        self.prefix = prefix
        self.events: List[tuple] = []  # (key, seconds)
        self._lock = threading.Lock()
        self._installed = False

    def _listen(self, key: str, seconds: float, **kwargs) -> None:
        if not self._installed or not key.startswith(self.prefix):
            return
        with self._lock:
            self.events.append((key, float(seconds)))
        self.recorder.event("compile", key=key, seconds=float(seconds))

    def install(self) -> "CompileWatcher":
        if not self._installed:
            self._installed = True
            with _watchers_lock:
                _watchers.append(self)
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        with _watchers_lock:
            if self in _watchers:
                _watchers.remove(self)

    def __enter__(self) -> "CompileWatcher":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ----- summaries

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per event key: {"count", "total_seconds"}."""
        with self._lock:
            events = list(self.events)
        out: Dict[str, Dict[str, float]] = {}
        for key, secs in events:
            s = out.setdefault(key, {"count": 0, "total_seconds": 0.0})
            s["count"] += 1
            s["total_seconds"] += secs
        for s in out.values():
            s["total_seconds"] = round(s["total_seconds"], 6)
        return out

    @property
    def backend_compile_count(self) -> int:
        """Graph captures observed."""
        with self._lock:
            return sum(1 for k, _ in self.events
                       if k.endswith(BACKEND_COMPILE))

    @property
    def backend_compile_seconds(self) -> float:
        """Total capture seconds observed."""
        with self._lock:
            return sum(s for k, s in self.events
                       if k.endswith(BACKEND_COMPILE))


def watch_compiles(recorder=None):
    """A ``CompileWatcher`` context for ``recorder`` — or a null context
    when recording is disabled, so the no-run-dir path pays nothing per
    capture."""
    rec = recorder if recorder is not None else get_recorder()
    if not rec.enabled:
        return contextlib.nullcontext(None)
    return CompileWatcher(rec)


# --------------------------------------------------------- snapshots


def cuda_memory_stats(index: int) -> Optional[Dict[str, int]]:
    """Card ``index``'s allocator counters in fks_tpu's canonical keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), from
    ``torch.cuda.memory_stats``; None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    raw = torch.cuda.memory_stats(index)
    return {
        "bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(index)
                           .total_memory),
    }


def device_snapshot() -> List[Dict[str, Any]]:
    """Per-device identity + allocator counters: one row per card, or one
    CPU row (``memory_stats`` None) without a card."""
    import torch

    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu",
                 "process_index": 0, "memory_stats": None}]
    return [{"id": i, "platform": "gpu",
             "device_kind": torch.cuda.get_device_name(i),
             "process_index": 0, "memory_stats": cuda_memory_stats(i)}
            for i in range(torch.cuda.device_count())]


def record_devices(recorder=None) -> List[Dict[str, Any]]:
    """Write one ``kind="device"`` event per visible device."""
    rec = recorder if recorder is not None else get_recorder()
    snap = device_snapshot() if rec.enabled else []
    for d in snap:
        rec.event("device", **d)
    return snap


def mesh_snapshot(mesh, real_count: Optional[int] = None) -> Dict[str, Any]:
    """Mesh metadata: axes, shape, device count and shard count, plus the
    pad-lane accounting (``parallel.mesh.pad_stats``) when the caller's
    real candidate count is known (fks_tpu/obs/telemetry.py:193-209). A
    logical shard counts as a device: ``devices`` is the mesh's size."""
    from fks_tpu_torch.parallel.mesh import num_shards, pad_stats

    info: Dict[str, Any] = {
        "axis_names": list(mesh.axis_names),
        "shape": {str(k): int(v) for k, v in mesh.shape.items()},
        "devices": int(mesh.devices.size),
        "shards": num_shards(mesh),
    }
    if real_count is not None:
        info.update(pad_stats(real_count, mesh))
    return info


def record_mesh(mesh, real_count: Optional[int] = None,
                recorder=None) -> Dict[str, Any]:
    """Write one ``kind="mesh"`` event describing the mesh."""
    rec = recorder if recorder is not None else get_recorder()
    if not rec.enabled:
        return {}
    snap = mesh_snapshot(mesh, real_count)
    rec.event("mesh", **snap)
    return snap
