"""Preemption-safe drain: the SIGTERM coordinator + serve-state persistence.

Port of fks_tpu.resilience.drain. Kubernetes (and every preemptible cloud
host) delivers SIGTERM, waits a grace period, then SIGKILLs. The
coordinator turns that grace period into a clean handoff:

1. stop admitting (new submits shed with a typed ``ShedError``),
2. drain the batcher — every already-enqueued Future is COMPLETED by a
   final batch pass, or shed with a typed error when the grace budget
   runs out; nothing is ever left hanging,
3. persist the serve replay buffer + summary (fsync'd tmp + rename, the
   ``pipeline/state.py`` durability idiom) so a restarted server can
   refill its shadow-eval replay source, and
4. run any registered callbacks (e.g. HTTP server shutdown).

The state file is fks_tpu's: the same JSON schema and ``STATE_VERSION``,
so either package reloads the other's.

On the card a batch's answers are host values by the time its Futures
complete: the engine copies its results to the host (which waits for
the batch's device work on its stream) before the batcher sets them, so
a drain that completes a Future has the batch's results in hand. A
signal handler runs on the main thread in the middle of whatever Python
was running there, which may be a CUDA graph capture in progress: a
capture rejects unsafe CUDA calls from its own thread, so
``handle_signal`` runs the drain on a thread of its own and waits for
it.

``install()`` registers the real signal handler (main thread only —
returns False elsewhere); drills and tests call ``handle_signal`` /
``drain`` directly for determinism.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

STATE_VERSION = 1


def persist_serve_state(service: Any, path: str) -> str:
    """Durably persist the service's replay buffer + counters as one
    JSON document (write + flush + fsync the temp file, then atomic
    rename — a kill mid-persist leaves the previous state intact)."""
    state = {
        "version": STATE_VERSION,
        "ts": round(time.time(), 3),
        "requests_served": service.requests_served,
        "replay": service.recent_queries(10 ** 9),
        "summary": service.summary(record=False),
    }
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_serve_state(path: str) -> Dict[str, Any]:
    """Read a persisted serve state; raises ValueError on a torn or
    unknown-version document (callers should start fresh, not half-load)."""
    try:
        with open(path) as f:
            state = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: torn serve state ({e})") from e
    if state.get("version") != STATE_VERSION:
        raise ValueError(
            f"{path}: unknown serve-state version {state.get('version')}")
    return state


class DrainCoordinator:
    """SIGTERM -> drain + persist, exactly once, from any thread."""

    def __init__(self, service: Any, *, state_path: str = "",
                 grace_s: float = 5.0, recorder: Any = None):
        from fks_tpu_torch import obs

        self.service = service
        self.state_path = state_path
        self.grace_s = float(grace_s)
        self.recorder = recorder if recorder is not None else obs.get_recorder()
        self.requested = False
        self.report: Optional[Dict[str, Any]] = None
        self._callbacks: List[Callable[[], None]] = []
        self._prev: Dict[int, Any] = {}
        self._lock = threading.Lock()

    def add_callback(self, fn: Callable[[], None]) -> None:
        """Run after the drain completes (e.g. HTTP server shutdown)."""
        self._callbacks.append(fn)

    # ------------------------------------------------------------ signals

    def install(self, signals=(signal.SIGTERM,)) -> bool:
        """Register the handler; returns False when not on the main
        thread (signal.signal raises there) — callers then drain in
        their own shutdown path instead."""
        try:
            for sig in signals:
                self._prev[sig] = signal.signal(sig, self.handle_signal)
        except ValueError:
            self._prev.clear()
            return False
        return True

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def handle_signal(self, signum=signal.SIGTERM, frame=None) -> None:
        """The SIGTERM path: drain on a thread of its own (module
        docstring) and wait for it, then run the callbacks."""
        self.requested = True
        failure: List[BaseException] = []

        def _drain() -> None:
            try:
                self.drain()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                failure.append(e)

        worker = threading.Thread(target=_drain, name="serve-drain")
        worker.start()
        worker.join()
        for fn in self._callbacks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — shutdown callbacks must not
                pass  # keep the process alive past its grace period
        if failure:
            raise failure[0]

    # -------------------------------------------------------------- drain

    def drain(self, grace_s: Optional[float] = None) -> Dict[str, Any]:
        """Drain the service's batcher (complete or shed every in-flight
        Future), persist the replay buffer, record one ``drain`` event.
        Idempotent: the second call returns the first report."""
        with self._lock:
            if self.report is not None:
                return self.report
            t0 = time.perf_counter()
            report = self.service.drain(
                grace_s if grace_s is not None else self.grace_s)
            if self.state_path:
                try:
                    report["state_path"] = persist_serve_state(
                        self.service, self.state_path)
                except OSError as e:
                    report["persist_error"] = str(e)
            report["drain_s"] = round(time.perf_counter() - t0, 6)
            self.recorder.event(
                "drain", pending=report.get("pending", 0),
                completed=report.get("completed", 0),
                shed=report.get("shed", 0),
                persisted=bool(report.get("state_path")),
                drain_s=report["drain_s"])
            self.report = report
            return report
