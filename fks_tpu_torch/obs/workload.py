"""Workload observability: query fingerprints, tenant accounting, loadgen.

Port of fks_tpu.obs.workload (host code; the fingerprint's snapshot-table
digest comes from the port's ``sim.evaluator``). Classes, mixes, tenant
rows and loadgen summaries equal fks_tpu's on the same traffic.

- ``QueryFingerprinter``: a deterministic content/shape signature per
  query — pod-count bucket, per-pod resource-mix decade histogram (sign
  + magnitude decade, so 120 and 160 cluster while 120 and 12000 split),
  and the snapshot-trigger-table content hash (the ``blake2b`` idiom the
  serve engine's device ktable cache uses). Classes are stable across
  processes and pod orderings, so live traffic clusters into workload
  classes and a windowed ``workload_mix`` metric records the
  distribution.
- ``TenantAccountant``: per-tenant request/shed/expiry/degraded
  counters, EWMA service time, per-tenant SLO burn through the
  ``SLOConfig``/``slo_burn`` math (obs.history), and a Jain's fairness
  index over per-tenant goodput — recorded as one ``tenant_stats``
  metric per tenant.
- ``run_loadgen``: a sustained multi-tenant arrival driver (open-loop
  Poisson rates and closed-loop worker counts per tenant) over any
  ``send(query) -> outcome`` client — in-process ``service_client`` or
  the concurrent-HTTP ``http_client`` — summarized into
  ``loadgen_qps`` / ``loadgen_p99_ms`` / ``loadgen_shed_rate`` /
  ``loadgen_fairness_index`` and recorded as a ``loadgen_summary``
  metric.

Disabled path discipline: the service holds ``accountant=None`` /
``fingerprinter=None`` by default — no object, no lock, no per-request
cost.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import random
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

from fks_tpu_torch.obs.history import SLOConfig, slo_burn

#: queries that name no tenant all account to one bucket — the
#: single-tenant deployments that existed before this module
DEFAULT_TENANT = "default"

#: loadgen arrival modes (closed vocabulary, fks_tpu's)
LOADGEN_MODES = ("open", "closed", "mixed")


def tenant_of(query: Dict[str, Any]) -> str:
    """The tenant a request accounts to: its ``tenant`` field, else
    ``DEFAULT_TENANT``. Always a str — accounting keys must never be
    unhashable or collide across JSON round trips."""
    t = query.get("tenant") if isinstance(query, dict) else None
    return str(t) if t else DEFAULT_TENANT


# ------------------------------------------------------------ fingerprints


def _decade(v: float) -> str:
    """Sign + magnitude-decade token (``analysis.candidate._bucket``):
    "0" for zero, else "+eK"/"-eK" — the resolution at which resource
    requests cluster into classes without hashing exact values."""
    v = float(v)
    if v == 0:
        return "0"
    mag = abs(v)
    dec = 0 if mag <= 1.0 else int(math.floor(math.log10(mag))) + 1
    return f"{'+' if v > 0 else '-'}e{dec}"


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class QueryFingerprinter:
    """Deterministic workload-class signatures + a windowed class mix.

    ``classify(pods)`` is pure and ORDER-INDEPENDENT: the signature is
    (pod-count power-of-two bucket, sorted resource-mix histogram,
    snapshot-trigger-table hash), digested with ``blake2b`` — the same
    query permuted, re-serialized, or classified in another process
    lands in the same class. ``observe`` classifies AND counts;
    ``record_mix`` emits the windowed ``workload_mix`` metric."""

    def __init__(self, *, snapshot_interval: float = 0.05,
                 max_steps_per_pod: int = 8, window: int = 256):
        self.snapshot_interval = float(snapshot_interval)
        self.max_steps_per_pod = int(max_steps_per_pod)
        self.window = max(1, int(window))
        self._counts: Dict[str, int] = {}
        self._seen = 0
        self._lock = threading.Lock()

    def _ktable_digest(self, n_pods: int) -> str:
        """Content hash of the snapshot trigger table this query would
        ship (the serve upload's third tensor): sized from the REAL pod
        count exactly as ``batcher._query_ktable`` sizes it, hashed with
        the engine's device-cache ``blake2b`` idiom."""
        from fks_tpu_torch.sim.evaluator import (
            max_snapshot_count, snapshot_trigger_table,
        )

        tbl = snapshot_trigger_table(
            n_pods,
            max_snapshot_count(self.max_steps_per_pod * n_pods, n_pods,
                               self.snapshot_interval),
            self.snapshot_interval)
        import numpy as np
        return hashlib.blake2b(np.asarray(tbl, np.int32).tobytes(),
                               digest_size=8).hexdigest()

    def classify(self, pods: Sequence[Dict[str, Any]]) -> str:
        """Pod list -> class label ``p{bucket}:{digest}`` (stable across
        processes, pod orderings, and dict key orders)."""
        n = len(pods)
        bucket = _pow2_bucket(max(1, n))
        mix: Dict[str, int] = {}
        for p in pods:
            tok = "/".join((
                _decade(p.get("cpu_milli", 0)),
                _decade(p.get("memory_mib", 0)),
                _decade(p.get("gpu_milli", 0)),
                _decade(p.get("duration_time", 0)),
            ))
            mix[tok] = mix.get(tok, 0) + 1
        canon = json.dumps(
            [bucket, sorted(mix.items()), self._ktable_digest(n)],
            separators=(",", ":"))
        digest = hashlib.blake2b(canon.encode(), digest_size=6).hexdigest()
        return f"p{bucket}:{digest}"

    def observe(self, pods: Sequence[Dict[str, Any]]) -> str:
        cls = self.classify(pods)
        with self._lock:
            self._counts[cls] = self._counts.get(cls, 0) + 1
            self._seen += 1
        return cls

    def mix(self) -> Dict[str, int]:
        """Class -> count for the current window (insertion order by
        first sighting; copy, safe to mutate)."""
        with self._lock:
            return dict(self._counts)

    def record_mix(self, recorder, *, reset: bool = True) -> dict:
        """Emit the windowed ``workload_mix`` metric and (by default)
        start a fresh window. Returns the record (empty window -> {})."""
        with self._lock:
            if not self._seen:
                return {}
            classes = dict(self._counts)
            seen = self._seen
            if reset:
                self._counts = {}
                self._seen = 0
        rec = {"window": seen, "distinct": len(classes),
               "classes": classes}
        if recorder is not None:
            recorder.metric("workload_mix", **rec)
        return rec


# ------------------------------------------------------------- accounting


def jain_fairness(values: Sequence[float]) -> float:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` over
    per-tenant goodput: 1.0 = perfectly even, 1/n = one tenant has it
    all. Empty or all-zero inputs read as fair (1.0) — an idle service
    is not unfair."""
    vals = [float(v) for v in values]
    n = len(vals)
    total = sum(vals)
    if n == 0 or total == 0:
        return 1.0
    return (total * total) / (n * sum(v * v for v in vals))


class _TenantSlot:
    __slots__ = ("requests", "shed", "expired", "degraded", "ewma_ms",
                 "latencies_ms")

    def __init__(self):
        self.requests = 0
        self.shed = 0
        self.expired = 0
        self.degraded = 0
        self.ewma_ms = 0.0
        self.latencies_ms: List[float] = []


class TenantAccountant:
    """Per-tenant serve accounting with SLO burn and fairness.

    One slot per tenant: completed/shed/expired/degraded counts, an EWMA
    of service time (``alpha`` — recent traffic dominates), and the
    latency tail for percentile + burn math. ``record`` emits one
    ``tenant_stats`` metric per tenant; every row carries the GLOBAL
    ``fairness_index`` (Jain over per-tenant goodput) so any single row
    answers "is the service being fair right now". Thread-safe: sheds
    land from submitter threads (HTTP handlers), completions from the
    batcher thread."""

    def __init__(self, *, slo: Optional[SLOConfig] = None,
                 alpha: float = 0.2, max_latencies: int = 4096):
        self.slo = slo if slo is not None else SLOConfig()
        self.alpha = float(alpha)
        self.max_latencies = max(16, int(max_latencies))
        self._slots: Dict[str, _TenantSlot] = {}
        self._lock = threading.Lock()
        self._t_first: Optional[float] = None
        self._t_last: float = 0.0

    def _slot(self, tenant: str) -> _TenantSlot:
        s = self._slots.get(tenant)
        if s is None:
            s = self._slots[tenant] = _TenantSlot()
        return s

    def note_request(self, tenant: str, latency_ms: float, *,
                     degraded: bool = False) -> None:
        now = time.perf_counter()
        with self._lock:
            s = self._slot(tenant)
            s.requests += 1
            if degraded:
                s.degraded += 1
            s.ewma_ms = (latency_ms if s.requests == 1 else
                         self.alpha * latency_ms
                         + (1.0 - self.alpha) * s.ewma_ms)
            s.latencies_ms.append(float(latency_ms))
            if len(s.latencies_ms) > self.max_latencies:
                del s.latencies_ms[: len(s.latencies_ms) // 2]
            if self._t_first is None:
                self._t_first = now
            self._t_last = now

    def note_shed(self, tenant: str) -> None:
        with self._lock:
            self._slot(tenant).shed += 1

    def note_expired(self, tenant: str) -> None:
        with self._lock:
            self._slot(tenant).expired += 1

    def ewma_service_s(self, tenant: str) -> Optional[float]:
        """This tenant's EWMA service time in SECONDS, or None while the
        tenant is cold — the per-tenant Retry-After source the admission
        controller plugs in (``AdmissionController.service_time_for``)."""
        with self._lock:
            s = self._slots.get(tenant)
            if s is None or not s.requests:
                return None
            return s.ewma_ms / 1e3

    def _elapsed(self) -> float:
        return (self._t_last - self._t_first) \
            if self._t_first is not None else 0.0

    def fairness_index(self) -> float:
        with self._lock:
            return jain_fairness([s.requests
                                  for s in self._slots.values()])

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant snapshot: counters, EWMA/percentile latencies,
        goodput qps over the accountant's own observation window, and
        the p99 SLO burn rate (0.0 when no SLO is set)."""
        elapsed = self._elapsed()
        fair = self.fairness_index()
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            items = [(t, s, list(s.latencies_ms))
                     for t, s in sorted(self._slots.items())]
        for tenant, s, lat in items:
            srt = sorted(lat)
            n = len(srt)
            burn = 0.0
            if self.slo.p99_ms and n:
                recs = slo_burn(SLOConfig(p99_ms=self.slo.p99_ms,
                                          error_budget=self.slo.error_budget),
                                lat, elapsed)
                burn = recs[0]["burn_rate"] if recs else 0.0
            out[tenant] = {
                "tenant": tenant,
                "requests": s.requests,
                "shed": s.shed,
                "expired": s.expired,
                "degraded": s.degraded,
                "ewma_ms": round(s.ewma_ms, 3),
                "p50_ms": round(srt[n // 2], 3) if n else 0.0,
                "p99_ms": round(srt[min(n - 1, int(0.99 * n))], 3)
                if n else 0.0,
                "goodput_qps": round(s.requests / elapsed, 2)
                if elapsed > 0 else 0.0,
                "burn_rate": burn,
                "fairness_index": round(fair, 4),
            }
        return out

    def record(self, recorder) -> Dict[str, Dict[str, Any]]:
        """One ``tenant_stats`` metric per tenant onto ``recorder``;
        returns the snapshot."""
        stats = self.stats()
        if recorder is not None:
            for row in stats.values():
                recorder.metric("tenant_stats", **row)
        return stats


# ---------------------------------------------------------------- loadgen


@dataclasses.dataclass(frozen=True)
class TenantLoad:
    """One tenant's arrival process. ``closed``: ``concurrency`` workers
    each submit-wait-repeat (throughput-seeking, self-clocking).
    ``open``: Poisson arrivals at ``rate_qps`` regardless of response
    times (latency-honest under overload — the arrival rate does not
    slow down because the server did)."""

    tenant: str
    mode: str = "closed"
    concurrency: int = 1
    rate_qps: float = 0.0
    pods_per_query: int = 2

    def __post_init__(self):
        if self.mode not in ("open", "closed"):
            raise ValueError(f"mode must be open|closed, got {self.mode!r}")
        if self.mode == "open" and self.rate_qps <= 0:
            raise ValueError("open-loop tenant needs rate_qps > 0")
        if self.mode == "closed" and self.concurrency < 1:
            raise ValueError("closed-loop tenant needs concurrency >= 1")


def parse_tenant_spec(spec: str) -> List[TenantLoad]:
    """``"a:closed:2,b:open:25"`` -> TenantLoads (third field: workers
    for closed, qps for open; optional fourth: pods per query)."""
    plan: List[TenantLoad] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 3:
            raise ValueError(
                f"tenant spec {part!r} needs name:mode:rate_or_workers")
        name, mode, amount = bits[0], bits[1], float(bits[2])
        pods = int(bits[3]) if len(bits) > 3 else 2
        if mode == "open":
            plan.append(TenantLoad(name, "open", rate_qps=amount,
                                   pods_per_query=pods))
        else:
            plan.append(TenantLoad(name, mode, concurrency=int(amount),
                                   pods_per_query=pods))
    if not plan:
        raise ValueError(f"empty tenant spec {spec!r}")
    return plan


def default_make_pods(load: TenantLoad, i: int) -> List[dict]:
    """Deterministic per-request pod lists: resources vary with the
    request ordinal so fingerprint classes differ across tenants but
    repeat runs are bit-identical."""
    return [{"cpu_milli": 10 + (i * 7 + j * 13) % 60,
             "memory_mib": 50 + 11 * j,
             "creation_time": j, "duration_time": 40}
            for j in range(load.pods_per_query)]


def service_client(service) -> Callable[[dict], dict]:
    """In-process client: ``submit().result()`` with shed/expiry mapped
    to outcomes (no socket — the accounting-overhead measurement path)."""
    from fks_tpu_torch.resilience.deadline import ResilienceError

    def send(query: dict) -> dict:
        try:
            service.submit(query).result(timeout=60)
            return {"outcome": "ok"}
        except ResilienceError as e:
            return {"outcome": "shed", "reason": e.reason}
        except Exception as e:  # noqa: BLE001 — loadgen counts, not raises
            return {"outcome": "error", "reason": str(e)}
    return send


def http_client(port: int, *, host: str = "127.0.0.1",
                timeout_s: float = 30.0) -> Callable[[dict], dict]:
    """HTTP client against the serve front: POST /query, 503 -> shed
    (Retry-After honored as data, not by waiting), other non-200 ->
    error. One connection per request — loadgen measures the service,
    not a keep-alive pool."""
    import urllib.error
    import urllib.request

    url = f"http://{host}:{port}/query"

    def send(query: dict) -> dict:
        req = urllib.request.Request(
            url, data=json.dumps(query).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                resp.read()
                return {"outcome": "ok"}
        except urllib.error.HTTPError as e:
            e.read()
            if e.code == 503:
                return {"outcome": "shed",
                        "retry_after": e.headers.get("Retry-After")}
            return {"outcome": "error", "status": e.code}
        except Exception as e:  # noqa: BLE001 — loadgen counts, not raises
            return {"outcome": "error", "reason": str(e)}
    return send


def run_loadgen(send: Callable[[dict], dict], plan: Sequence[TenantLoad],
                duration_s: float, *, seed: int = 0,
                make_pods: Callable[[TenantLoad, int], List[dict]] = None,
                recorder=None) -> dict:
    """Drive the arrival plan against ``send`` for ``duration_s`` and
    summarize into the gated loadgen vocabulary.

    Closed-loop tenants run ``concurrency`` synchronous worker threads;
    open-loop tenants run one seeded-Poisson dispatcher firing each
    arrival on its own thread (arrivals never wait on responses — the
    open-loop contract; a shed answer is an outcome, not an error).
    Returns the summary dict and records it as ``loadgen_summary``."""
    make_pods = make_pods or default_make_pods
    results: List[tuple] = []  # (tenant, outcome, latency_ms)
    lock = threading.Lock()
    t_start = time.perf_counter()
    t_end = t_start + float(duration_s)

    def fire(load: TenantLoad, i: int) -> None:
        q = {"id": f"{load.tenant}-{i:05d}", "tenant": load.tenant,
             "pods": make_pods(load, i)}
        t0 = time.perf_counter()
        out = send(q)
        dt_ms = (time.perf_counter() - t0) * 1e3
        with lock:
            results.append((load.tenant, out.get("outcome", "error"),
                            dt_ms))

    threads: List[threading.Thread] = []
    arrival_threads: List[threading.Thread] = []

    def closed_worker(load: TenantLoad, w: int) -> None:
        i = w
        while time.perf_counter() < t_end:
            fire(load, i)
            i += load.concurrency

    def open_dispatcher(load: TenantLoad) -> None:
        rng = random.Random(seed ^ zlib.crc32(load.tenant.encode()))
        i = 0
        next_t = time.perf_counter()
        while True:
            next_t += rng.expovariate(load.rate_qps)
            if next_t >= t_end:
                return
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t = threading.Thread(target=fire, args=(load, i), daemon=True)
            t.start()
            arrival_threads.append(t)
            i += 1

    for load in plan:
        if load.mode == "closed":
            for w in range(load.concurrency):
                threads.append(threading.Thread(
                    target=closed_worker, args=(load, w), daemon=True))
        else:
            threads.append(threading.Thread(
                target=open_dispatcher, args=(load,), daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for t in arrival_threads:  # open-loop stragglers finish their answer
        t.join(timeout=60)
    elapsed = time.perf_counter() - t_start

    modes = {load.mode for load in plan}
    mode = modes.pop() if len(modes) == 1 else "mixed"
    ok_lat = sorted(dt for _, outcome, dt in results if outcome == "ok")
    n_ok = len(ok_lat)
    n_shed = sum(1 for _, o, _ in results if o == "shed")
    n_err = sum(1 for _, o, _ in results if o == "error")
    per_tenant: Dict[str, Dict[str, Any]] = {}
    for load in plan:
        rows = [(o, dt) for t, o, dt in results if t == load.tenant]
        lat = sorted(dt for o, dt in rows if o == "ok")
        k = len(lat)
        per_tenant[load.tenant] = {
            "mode": load.mode,
            "sent": len(rows),
            "ok": k,
            "shed": sum(1 for o, _ in rows if o == "shed"),
            "errors": sum(1 for o, _ in rows if o == "error"),
            "p50_ms": round(lat[k // 2], 3) if k else 0.0,
            "p99_ms": round(lat[min(k - 1, int(0.99 * k))], 3) if k
            else 0.0,
            "goodput_qps": round(k / elapsed, 2) if elapsed > 0 else 0.0,
        }
    summary = {
        "mode": mode,
        "tenant_count": len(plan),
        "duration_s": round(elapsed, 3),
        "requests": len(results),
        "completed": n_ok,
        "shed": n_shed,
        "errors": n_err,
        "loadgen_qps": round(n_ok / elapsed, 2) if elapsed > 0 else 0.0,
        "loadgen_p50_ms": round(ok_lat[n_ok // 2], 3) if n_ok else 0.0,
        "loadgen_p99_ms": round(ok_lat[min(n_ok - 1, int(0.99 * n_ok))], 3)
        if n_ok else 0.0,
        "loadgen_shed_rate": round(n_shed / len(results), 4)
        if results else 0.0,
        "loadgen_fairness_index": round(jain_fairness(
            [v["ok"] for v in per_tenant.values()]), 4),
        "tenants": per_tenant,
    }
    if recorder is not None:
        recorder.metric("loadgen_summary", **summary)
    return summary
