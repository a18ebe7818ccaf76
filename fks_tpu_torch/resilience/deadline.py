"""Per-request deadline budgets and the typed resilience errors.

Port of fks_tpu.resilience.deadline (pure stdlib), unchanged.

A ``Deadline`` is an absolute point on the monotonic clock; requests
carry one from the front (HTTP/JSONL ``deadline_ms`` field, or the
service default) through the batcher, so every layer can ask the same
two questions — ``remaining()`` and ``expired()`` — against one budget
instead of stacking independent timeouts.

The two failure modes are TYPED exceptions, not bare RuntimeErrors,
because the fronts must map them to structured responses (503 +
Retry-After):

- ``ShedError``: admission control refused the request up front (queue
  full, or the projected wait already exceeds the deadline). Carries
  ``retry_after_s`` — the client hint the HTTP front forwards as a
  Retry-After header.
- ``DeadlineExceeded``: the request was admitted but its budget ran out
  before (or while) a batch could answer it; its Future completes with
  this error instead of hanging.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional


class ResilienceError(RuntimeError):
    """Base class for typed serve-tier resilience failures.

    ``http_status``/``to_json()`` give the fronts one structured-body
    rendering for every subclass."""

    kind = "resilience"
    http_status = 503

    def __init__(self, message: str, *,
                 retry_after_s: Optional[float] = None,
                 reason: Optional[str] = None,
                 trace_id: Optional[str] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.reason = reason if reason is not None else self.kind
        # causal correlation (obs.trace_ctx): set by the layer
        # that knows the request's trace, so a 503 body names the trace
        # whose flight-recorder spans explain it
        self.trace_id = trace_id

    def to_json(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"error": str(self), "kind": self.kind}
        if self.retry_after_s is not None:
            doc["retry_after_s"] = round(float(self.retry_after_s), 4)
        if self.trace_id:
            doc["trace_id"] = self.trace_id
        return doc


class ShedError(ResilienceError):
    """Admission control refused the request (queue full or the
    projected wait exceeds the deadline); retry after ``retry_after_s``."""

    kind = "shed"


class DeadlineExceeded(ResilienceError):
    """The request's deadline budget expired before it was answered."""

    kind = "deadline"


class Deadline:
    """An absolute monotonic-clock budget. ``Deadline.never()`` (or
    ``None`` where the API allows it) means no budget at all."""

    __slots__ = ("at",)

    def __init__(self, at: Optional[float]):
        self.at = at  # absolute time.perf_counter() point; None = never

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.perf_counter() + max(0.0, float(seconds)))

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    @classmethod
    def from_query(cls, query: Any,
                   default_s: float = 0.0) -> Optional["Deadline"]:
        """The request's own ``deadline_ms`` wins; otherwise the service
        default (0 = no deadline -> None)."""
        if isinstance(query, dict) and query.get("deadline_ms") is not None:
            return cls.after(float(query["deadline_ms"]) / 1e3)
        if default_s and default_s > 0:
            return cls.after(default_s)
        return None

    def remaining(self) -> float:
        if self.at is None:
            return float("inf")
        return self.at - time.perf_counter()

    def expired(self) -> bool:
        return self.at is not None and time.perf_counter() >= self.at

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if self.at is None:
            return "Deadline(never)"
        return f"Deadline(remaining={self.remaining():.4f}s)"
