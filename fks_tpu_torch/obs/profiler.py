"""The disabled stage profiler: the hooks the evolve loop calls, no-ops.

Port of the off path of fks_tpu.obs.profiler: ``NULL_PROFILER`` is a
``StageProfiler`` whose ``stage()`` yields a shared handle that drops its
annotations and returns values unsynced, and whose ``segment_tick()``
counts nothing, so the instrumented call sites need no branch and add no
device fence. Per-stage device-time attribution (wall / compile /
compute, occupancy) waits for the rest of ``obs/`` (ROADMAP queue 1
item 6), where device time comes from CUDA events or ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator

UNPORTED = ("per-stage device-time attribution (fks_tpu.obs.profiler) is "
            "not ported yet: it waits for the rest of obs/ (ROADMAP queue "
            "1 item 6); run with profile=False")


class _NullHandle:
    """The disabled handle: annotate drops fields, sync is identity."""

    __slots__ = ()
    record = None

    def annotate(self, **fields) -> None:
        pass

    def sync(self, value: Any) -> Any:
        return value


_NULL_HANDLE = _NullHandle()


class StageProfiler:
    """The disabled profiler (``enabled=False`` only, see the module
    docstring)."""

    enabled = False

    def __init__(self, enabled: bool = False, scope: str = "null"):
        if enabled:
            raise ValueError(UNPORTED)
        self.scope = scope
        self.records: list = []

    @contextlib.contextmanager
    def stage(self, name: str, **fields) -> Iterator[_NullHandle]:
        yield _NULL_HANDLE

    def segment_tick(self, n: int = 1) -> None:
        pass

    def close(self) -> None:
        pass


NULL_PROFILER = StageProfiler(enabled=False, scope="null")
