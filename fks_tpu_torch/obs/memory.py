"""Memory observability: the executable-footprint ledger.

Port of the footprint part of fks_tpu.obs.memory (``MEMORY_COMPONENTS``,
``record_footprint``; fks_tpu/obs/memory.py:144-170). fks_tpu prices a
compiled XLA program from its ``memory_analysis()``. The port's
counterpart of a compiled program is a captured CUDA graph, priced by
``capture_footprint``: the caching allocator's peak across the capture
(``torch.cuda.max_memory_allocated``, reset around it) above what was
allocated before it, plus the bytes of the graph's static inputs, in
fks_tpu's record fields. On the CPU there is no allocator to read, and
the record is None, as fks_tpu's is on a backend that cannot price a
program. The watermark sampler, the leak sentinel and ``rollup`` wait
for ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Optional

from fks_tpu_torch.obs.recorder import get_recorder

#: closed vocabulary for memory_footprint.component — which tier built
#: the executable (fks_tpu's)
MEMORY_COMPONENTS = ("serve_aot", "serve_vm", "evolve", "bench")

#: canonical footprint byte keys, in ladder-rendering order
FOOTPRINT_KEYS = ("temp_bytes", "argument_bytes", "output_bytes",
                  "generated_code_bytes")


@contextlib.contextmanager
def capture_footprint(device, argument_bytes: int = 0
                      ) -> Iterator[Dict[str, int]]:
    """Price the CUDA graph captured inside the block: yields a dict that
    holds, after the block, the footprint in fks_tpu's keys — temp bytes
    (the allocator's peak during the block above its level before),
    ``argument_bytes`` (the caller's count of the graph's static inputs),
    no output or code bytes (results are read from the inputs' buffers),
    and their ``total_bytes`` sum. Empty on the CPU."""
    import torch

    out: Dict[str, int] = {}
    dev = torch.device(device)
    if dev.type != "cuda":
        yield out
        return
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    yield out
    torch.cuda.synchronize(dev)
    out.update(temp_bytes=max(0, torch.cuda.max_memory_allocated(dev)
                              - base),
               argument_bytes=int(argument_bytes), output_bytes=0,
               generated_code_bytes=0)
    out["total_bytes"] = sum(out[k] for k in FOOTPRINT_KEYS)


def mesh_layout_label(mesh: Any) -> str:
    """A mesh's layout as a stable comparison key, ``"pop=4,scn=2"`` from
    its axis shape (``parallel.mesh.Mesh.shape``); empty without a mesh
    (fks_tpu/obs/memory.py:102-112)."""
    if mesh is None:
        return ""
    return ",".join(f"{k}={int(v)}" for k, v in mesh.shape.items())


class FootprintLedger:
    """Bounded in-process ledger of recorded executable footprints.
    Thread-safe appends (serve captures happen under batcher threads)."""

    def __init__(self, cap: int = 512):
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []

    def add(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._records.append(dict(record))
            if len(self._records) > self.cap:
                del self._records[: len(self._records) - self.cap]

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


#: the process-wide ledger every ``record_footprint`` lands in (alongside
#: the active flight recorder, when one is enabled)
LEDGER = FootprintLedger()


def record_footprint(component: str, exe_key: Any, *,
                     footprint: Optional[Dict[str, int]] = None,
                     mesh: Any = None, recorder=None,
                     **fields) -> Optional[Dict[str, Any]]:
    """One ``memory_footprint`` record for a captured graph: the
    ``footprint`` bytes (``capture_footprint``) tagged with ``component``
    (closed vocabulary), a stable ``exe_key`` (e.g. ``"lanes=2,pods=8"``)
    and the mesh layout. Lands in the in-process ``LEDGER`` and on the
    recorder. Returns the record, or None when there is no footprint (the
    CPU) — callers never branch on it."""
    if component not in MEMORY_COMPONENTS:
        raise ValueError(f"unknown memory component {component!r} "
                         f"(expect one of {sorted(MEMORY_COMPONENTS)})")
    if not footprint:
        return None
    rec: Dict[str, Any] = {
        "component": component,
        "exe_key": str(exe_key),
        "mesh_layout": mesh_layout_label(mesh),
        **footprint,
        **fields,
    }
    LEDGER.add(rec)
    r = recorder if recorder is not None else get_recorder()
    r.metric("memory_footprint", dict(rec))
    return rec
