"""Admission control for the request coalescer: bounded queue + shed.

Port of fks_tpu.resilience.admission (pure stdlib), unchanged.

The controller answers one question at submit time — "can this request
still meet its deadline if we accept it?" — from two cheap signals it
maintains itself: the current queue depth and an EWMA of observed
per-request service time. ``projected_wait = depth * ewma_service_s``
is deliberately conservative (it ignores batching speedup), so the
shed decision errs toward refusing work the deadline would lose anyway;
a shed costs the client one Retry-After round-trip, a missed deadline
costs a full budget.

All counters are lock-guarded and the controller is shared between the
submitting threads and the batcher worker; it never blocks on anything.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from fks_tpu_torch.resilience.deadline import Deadline, ShedError


@dataclasses.dataclass
class AdmissionConfig:
    """Knobs for the bounded queue + shed policy.

    - ``max_queue``: requests allowed in the queue (enqueued, not yet
      handed to a batch). 0 = unbounded, the historical behaviour.
    - ``default_deadline_s``: deadline attached to requests that do not
      carry their own ``deadline_ms``. 0 = none.
    - ``ewma_alpha``: weight of the newest batch in the service-time
      estimate (0 < alpha <= 1).
    - ``min_retry_after_s``: floor for the Retry-After hint, so a cold
      estimator never tells clients to hammer back immediately.
    """

    max_queue: int = 0
    default_deadline_s: float = 0.0
    ewma_alpha: float = 0.2
    min_retry_after_s: float = 0.05


class AdmissionController:
    """Queue-depth accounting + EWMA service-time estimate + the shed
    decision. One instance per ``RequestBatcher``."""

    def __init__(self, config: Optional[AdmissionConfig] = None):
        self.cfg = config or AdmissionConfig()
        self._lock = threading.Lock()
        self._depth = 0
        self._ewma_service_s: Optional[float] = None
        self.submitted = 0
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.expired = 0  # admitted but completed with DeadlineExceeded
        # optional per-tenant service-time source (tenant -> seconds, or
        # None while that tenant is cold): when the service runs with
        # accounting on, this is TenantAccountant.ewma_service_s, and a
        # shed request's Retry-After is priced at the SHEDDING tenant's
        # observed service time instead of the single global EWMA — a
        # slow tenant is told to back off longer, a fast one shorter
        # (first step of weighted-fair shedding). Never called under the
        # accountant's own lock from here (lock order: admission ->
        # accountant, and the accountant never calls admission).
        self.service_time_for: Optional[
            Callable[[str], Optional[float]]] = None

    # ------------------------------------------------------------ signals

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def shed_total(self) -> int:
        return self.shed_queue_full + self.shed_deadline

    @property
    def shed_rate(self) -> float:
        """Fraction of all submit attempts refused at admission."""
        total = self.submitted + self.shed_total
        return self.shed_total / total if total else 0.0

    def note_batch(self, n: int, seconds: float) -> None:
        """Fold one completed batch into the service-time estimate."""
        if n <= 0:
            return
        per_item = max(0.0, float(seconds)) / n
        with self._lock:
            if self._ewma_service_s is None:
                self._ewma_service_s = per_item
            else:
                a = self.cfg.ewma_alpha
                self._ewma_service_s = (a * per_item
                                        + (1.0 - a) * self._ewma_service_s)

    def note_expired(self, n: int = 1) -> None:
        with self._lock:
            self.expired += n

    def projected_wait_s(self, extra_depth: int = 0) -> float:
        """Expected wait for a request arriving now: everything ahead of
        it priced at the EWMA service time (0.0 while the estimator is
        cold — never shed on a guess)."""
        est = self._ewma_service_s
        if est is None:
            return 0.0
        return (self._depth + extra_depth) * est

    def retry_after_s(self) -> float:
        """Client back-off hint: drain time for the current queue."""
        return max(self.cfg.min_retry_after_s, self.projected_wait_s())

    # ----------------------------------------------------------- decision

    def admit(self, deadline: Optional[Deadline],
              tenant: Optional[str] = None) -> None:
        """Admit (incrementing depth) or raise ``ShedError``. Called by
        ``RequestBatcher.submit`` before enqueueing. ``tenant`` (when the
        service threads it through) prices the shed hint per tenant; the
        shed DECISION stays global — fairness of refusal is the queue's
        concern, honesty of the back-off hint is the tenant's."""
        with self._lock:
            if self.cfg.max_queue and self._depth >= self.cfg.max_queue:
                self.shed_queue_full += 1
                raise ShedError(
                    f"queue full ({self._depth}/{self.cfg.max_queue})",
                    retry_after_s=self._retry_after_locked(tenant),
                    reason="queue_full")
            if deadline is not None:
                est = self._ewma_service_s
                projected = (self._depth + 1) * est if est is not None else 0.0
                if projected > deadline.remaining():
                    self.shed_deadline += 1
                    raise ShedError(
                        f"projected wait {projected * 1e3:.1f}ms exceeds "
                        "deadline budget "
                        f"{max(0.0, deadline.remaining()) * 1e3:.1f}ms",
                        retry_after_s=self._retry_after_locked(tenant),
                        reason="deadline_budget")
            self._depth += 1
            self.submitted += 1

    def release(self, n: int = 1) -> None:
        """Requests left the queue (handed to a batch, or drained)."""
        with self._lock:
            self._depth = max(0, self._depth - n)

    def _retry_after_locked(self, tenant: Optional[str] = None) -> float:
        est = self._ewma_service_s or 0.0
        if tenant and self.service_time_for is not None:
            tenant_est = self.service_time_for(tenant)
            if tenant_est:  # cold tenants fall back to the global EWMA
                est = float(tenant_est)
        return max(self.cfg.min_retry_after_s, self._depth * est)
