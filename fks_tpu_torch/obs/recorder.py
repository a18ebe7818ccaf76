"""The process-wide event recorder seam.

Port of the disabled half of fks_tpu.obs.recorder: ``NullRecorder`` (the
recorder API with no writes), the process-wide active recorder
(``get_recorder``) and ``recording``, which installs a recorder for a
scope. Instrumented paths (``obs.tracing.trace_diff``) write through the
active recorder, so they need no ``if recorder:`` guard. The run-directory
``FlightRecorder`` waits for the port's obs slice; any object with this
API can be installed meanwhile.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional


class NullRecorder:
    """The disabled recorder: the full API, no writes."""

    enabled = False
    run_dir: Optional[str] = None
    run_id: Optional[str] = None

    def event(self, kind: str, **fields) -> None:
        pass

    def metric(self, kind: str, record: Optional[Dict[str, Any]] = None,
               **fields) -> None:
        pass

    def heartbeat(self) -> None:
        pass

    def annotate_meta(self, **fields) -> None:
        pass

    def finish(self, status: str = "ok") -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullRecorder":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL = NullRecorder()
_active: NullRecorder = NULL


def get_recorder() -> NullRecorder:
    """The process-wide active recorder (the shared NullRecorder unless a
    ``recording(...)`` scope is open)."""
    return _active


@contextlib.contextmanager
def recording(recorder: NullRecorder) -> Iterator[NullRecorder]:
    """Install ``recorder`` as the active recorder for the scope; on exit
    finish it (status from the exception state), close it, and restore
    the previous recorder."""
    global _active
    prev = _active
    _active = recorder
    try:
        yield recorder
    except BaseException:
        _active = prev
        recorder.finish("error")
        recorder.close()
        raise
    _active = prev
    recorder.finish("ok")
    recorder.close()
