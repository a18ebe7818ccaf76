"""The flight recorder: one run, one directory, everything the run did.

Port of fks_tpu.obs.recorder. A ``FlightRecorder`` owns a run directory
with fks_tpu's fixed layout, so fks_tpu's tools read the port's runs:

- ``meta.json``     — run identity: run_id, start/finish timestamps,
                      status, plus whatever callers annotate (rewritten
                      atomically on every annotation);
- ``events.jsonl``  — append-only operational events (spans, graph
                      captures, promotion swaps, drains), one JSON object
                      per line with ``ts``/``kind``/``seq``;
- ``metrics.jsonl`` — append-only metric records (ledger rows, serve
                      requests, promotion events) through a
                      ``utils.logging.MetricsWriter``;
- ``heartbeat``     — a small JSON file rewritten (atomic replace) on
                      demand, so a watcher can tell a slow run from a
                      dead one without parsing the JSONL.

The disabled path is a ``NullRecorder``: the same API, no filesystem
writes. The process-wide active recorder defaults to the shared
``NULL``; ``recording(rec)`` installs a real one for a scope (the CLI's
``--run-dir``). Values recorded from device tensors go through
``json_ready``, which copies a CUDA tensor to the host explicitly.
"""
from __future__ import annotations

import contextlib
import json
import os
import secrets
import threading
import time
from typing import Any, Dict, Iterator, Optional

from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.utils.logging import MetricsWriter, json_ready


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


class FlightRecorder(NullRecorder):
    """A live run directory (see the module docstring for the layout)."""

    enabled = True

    def __init__(self, run_dir: str,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = os.fspath(run_dir)
        # sortable and collision-proof: wall-clock stamp, random suffix
        self.run_id = (time.strftime("%Y%m%d_%H%M%S") + "-"
                       + secrets.token_hex(3))
        self._t0 = time.time()
        self._meta: Dict[str, Any] = {
            "run_id": self.run_id,
            "started": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "started_ts": self._t0,
            "status": "running",
        }
        if meta:
            self._meta.update(meta)
        self._meta_lock = threading.Lock()
        self._write_meta()
        self._events = MetricsWriter(os.path.join(run_dir, "events.jsonl"))
        self._metrics = MetricsWriter(os.path.join(run_dir, "metrics.jsonl"))
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._closed = False
        self.heartbeat()

    def event(self, kind: str, **fields) -> None:
        """Operational event -> ``events.jsonl``. ``seq`` is a monotonic
        counter, so concurrent writers (the batcher thread, a promotion
        poll thread) keep a total order when ``ts`` collides. An active
        trace context stamps its trace_id onto the event."""
        if "trace_id" not in fields:
            ctx = trace_ctx.current()
            if ctx is not None:
                fields["trace_id"] = ctx.trace_id
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        self._events.write(kind, seq=seq, **fields)

    def metric(self, kind: str, record: Optional[Dict[str, Any]] = None,
               **fields) -> None:
        """Metric record -> ``metrics.jsonl``."""
        self._metrics.write(kind, record, **fields)

    def heartbeat(self) -> None:
        """Atomically rewrite the heartbeat file with the current time."""
        path = os.path.join(self.run_dir, "heartbeat")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"ts": time.time(), "run_id": self.run_id}, f)
        os.replace(tmp, path)

    def annotate_meta(self, **fields) -> None:
        """Merge fields into ``meta.json`` (atomic rewrite)."""
        with self._meta_lock:
            self._meta.update(fields)
            self._write_meta()

    def finish(self, status: str = "ok") -> None:
        self.annotate_meta(
            status=status,
            finished=time.strftime("%Y-%m-%dT%H:%M:%S"),
            wall_seconds=round(time.time() - self._t0, 3))
        self.heartbeat()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._events.close()
            self._metrics.close()

    def _write_meta(self) -> None:
        path = os.path.join(self.run_dir, "meta.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._meta, f, indent=2, default=json_ready)
        os.replace(tmp, path)

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.finish("ok" if exc_type is None else "error")
        self.close()


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
