"""Degraded-mode serving: device-fault classification + the fallback flip.

Port of fks_tpu.resilience.degrade. Opt-in only: nothing arms it but
``ServeService.enable_degraded_mode`` (``cli serve --degraded-fallback``).

When the warm engine dies under a batch (a CUDA runtime error, a
watchdog NaN flood, or a failed engine rebuild), the service must keep
answering — correctly, just slower. The manager here:

1. classifies the exception (``classify_fault``): only DEVICE faults
   degrade; request errors (ValueError from a malformed query) stay
   per-request failures;
2. atomically flips the ``ServeService`` to a reduced-batch exact
   fallback engine on the host CPU via the service's existing
   ``swap_engine`` (one attribute assignment — in-flight batches finish
   on whichever engine they pinned), and records the flip as a
   ``degraded`` event;
3. rebuilds the primary engine OFF the request path (a background
   thread by default; synchronous under ``background_rebuild=False``
   for deterministic drills);
4. gates recovery through PROBATION: the rebuilt engine is swapped back
   in, but the manager only declares ``normal`` after
   ``probation_requests`` clean requests — a fault inside the window
   re-degrades immediately and rebuilds again.

The manager owns no engine construction itself: callers hand it two
factories (``fallback_factory`` -> a warm exact engine,
``rebuild_factory`` -> a warm primary engine).

Pure host code at import time.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

#: exception type names that mean the DEVICE (or its runtime) failed —
#: matched by name, as fks_tpu matches XLA's: fks_tpu's names, and
#: PyTorch's for a CUDA error raised by the runtime or the allocator
_XLA_FAULT_TYPES = frozenset({
    "XlaRuntimeError", "JaxRuntimeError", "InternalError",
    "FailedPreconditionError", "DataLossError",
    "AcceleratorError", "OutOfMemoryError",
})


class DeviceFault(RuntimeError):
    """A device-side failure (real or injected) that warrants degrading
    to the fallback engine rather than failing the request."""


class NaNFlood(DeviceFault):
    """The watchdog saw non-finite scores flooding out of the engine —
    the compiled program is producing garbage; stop trusting it."""


class EngineBuildError(DeviceFault):
    """Building (or rebuilding) an AOT engine failed."""


def classify_fault(exc: BaseException) -> Optional[str]:
    """Map an exception to a device-fault kind, or None for request-level
    errors that must NOT degrade the service."""
    if isinstance(exc, NaNFlood):
        return "nan_flood"
    if isinstance(exc, EngineBuildError):
        return "engine_build"
    if isinstance(exc, DeviceFault):
        return "device_fault"
    if type(exc).__name__ in _XLA_FAULT_TYPES:
        return "xla_runtime"
    return None


@dataclasses.dataclass
class DegradeConfig:
    """Probation + rebuild knobs for ``DegradedModeManager``."""

    #: clean requests required on the rebuilt engine before the manager
    #: declares ``normal`` (the controller's probation-window idiom)
    probation_requests: int = 8
    #: rebuild the primary in a background thread (the production
    #: default); False rebuilds inline in ``on_fault`` so drills are
    #: single-threaded deterministic
    background_rebuild: bool = True


class DegradedModeManager:
    """State machine: ``normal -> degraded -> probation -> normal``.

    Wired into ``ServeService._handle_batch``: ``on_fault(exc)`` from the
    batch-failure path (returns True when the service was flipped and the
    batch should be retried on the fallback), ``after_batch(n)`` from the
    success path (drives recovery + probation accounting)."""

    def __init__(self, service: Any,
                 fallback_factory: Callable[[], Any],
                 rebuild_factory: Optional[Callable[[], Any]] = None,
                 config: Optional[DegradeConfig] = None,
                 recorder: Any = None):
        from fks_tpu_torch.obs.recorder import get_recorder

        self.service = service
        self.cfg = config or DegradeConfig()
        self.recorder = recorder if recorder is not None else get_recorder()
        self._fallback_factory = fallback_factory
        self._rebuild_factory = rebuild_factory
        self._lock = threading.RLock()
        self._fallback: Any = None  # memoized warm fallback engine
        self._rebuilt: Any = None  # rebuilt primary awaiting recovery
        self._rebuild_thread: Optional[threading.Thread] = None
        self._probation_mark = 0
        self.state = "normal"
        self.flips = 0
        self.recoveries = 0
        self.last_fault = ""

    # ------------------------------------------------------------- faults

    def on_fault(self, exc: BaseException) -> bool:
        """Classify; on a device fault flip the service to the fallback
        engine and kick off the rebuild. Returns True when the caller
        should retry its batch on the (now-swapped) fallback."""
        kind = classify_fault(exc)
        if kind is None:
            return False
        with self._lock:
            self.last_fault = kind
            if self.state == "degraded":
                return True  # already on the fallback; just retry
            fallback = self._get_fallback()
            if fallback is None:
                return False  # fallback build failed: fail the batch
            self.service.swap_engine(fallback)
            self.state = "degraded"
            self.flips += 1
            self._rebuilt = None
            self.recorder.event(
                "degraded", fault=kind, state="degraded",
                detail=f"{type(exc).__name__}: {exc}", flips=self.flips)
            self._start_rebuild()
            return True

    def _get_fallback(self) -> Any:
        if self._fallback is None:
            try:
                self._fallback = self._fallback_factory()
            except Exception as e:  # noqa: BLE001 — a fallback that cannot
                # build leaves nothing to degrade TO; surface the original
                # batch failure instead of masking it with this one
                self.recorder.event(
                    "degraded", fault="engine_build", state="dead",
                    detail=f"fallback build failed: {e}")
                return None
        return self._fallback

    def _start_rebuild(self) -> None:
        if self._rebuild_factory is None:
            return
        if self.cfg.background_rebuild:
            t = threading.Thread(target=self._rebuild,
                                 name="degrade-rebuild", daemon=True)
            self._rebuild_thread = t
            t.start()
        else:
            self._rebuild()

    def _rebuild(self) -> None:
        try:
            engine = self._rebuild_factory()
        except Exception as e:  # noqa: BLE001 — a failed rebuild keeps the
            # service on the fallback; the next fault retries the rebuild
            self.recorder.event(
                "degraded", fault="engine_build", state="degraded",
                detail=f"rebuild failed: {type(e).__name__}: {e}")
            return
        with self._lock:
            self._rebuilt = engine

    def wait_rebuilt(self, timeout: Optional[float] = None) -> bool:
        """Block until the background rebuild finished (drill/test hook)."""
        t = self._rebuild_thread
        if t is not None:
            t.join(timeout)
        return self._rebuilt is not None

    # ----------------------------------------------------------- recovery

    def after_batch(self, n: int = 1) -> None:
        """Success-path hook: promote a finished rebuild into probation,
        and release probation after enough clean requests."""
        with self._lock:
            if self.state == "degraded" and self._rebuilt is not None:
                self.service.swap_engine(self._rebuilt)
                self._rebuilt = None
                self.state = "probation"
                self._probation_mark = getattr(
                    self.service, "requests_served", 0)
                self.recorder.event(
                    "degraded", fault=self.last_fault, state="probation",
                    probation_requests=self.cfg.probation_requests)
            elif self.state == "probation":
                served = getattr(self.service, "requests_served", 0)
                if served - self._probation_mark >= self.cfg.probation_requests:
                    self.state = "normal"
                    self.recoveries += 1
                    self.recorder.event(
                        "degraded", fault=self.last_fault, state="normal",
                        recoveries=self.recoveries)

    # -------------------------------------------------------------- views

    def healthz(self) -> dict:
        return {"state": self.state, "flips": self.flips,
                "recoveries": self.recoveries, "last_fault": self.last_fault}


def exact_fallback_factory(champion, workload, envelope,
                           max_batch: int = 1,
                           recorder: Any = None,
                           device: Any = "cpu") -> Callable[[], Any]:
    """A factory building the reduced-batch exact-CPU reference engine:
    the same champion and bucket ladder, ``engine="exact"`` on the host
    CPU, batch cut to ``max_batch`` — correctness over throughput while
    degraded."""
    def build():
        import dataclasses as _dc

        from fks_tpu_torch.serve import ServeEngine

        env = _dc.replace(envelope, max_batch=max_batch)
        eng = ServeEngine(champion, workload, envelope=env, engine="exact",
                          recorder=recorder, device=device)
        eng.warmup()
        return eng
    return build
