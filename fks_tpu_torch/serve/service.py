"""Serving front: requests in, audited answers + latency metrics out.

Port of fks_tpu.serve.service. ``ServeService`` wraps a ``ServeEngine``
with the request-side concerns the engine itself stays free of: query
resolution ("place this pod list" vs "replay this what-if trace"), the
``RequestBatcher`` coalescer, the per-request ``serve_request`` metric
(latency, batch occupancy, bucket shape) through the recorder, tenant
accounting, SLO burn, hot swaps, degraded mode, and the every-Nth
``ParitySentinel`` audit of served answers against the unbatched exact
engine. Two fronts ride on it: stdin/JSONL (``run_jsonl``) and a
localhost-only HTTP listener (``run_http``); both are thin — the service
is the library entrypoint.

The batcher's worker thread answers every batch; the engine sets its
device and runs on its own stream in whichever thread calls it, so the
graphs it replays there are the ones ``warmup`` captured.

``selftest`` is the batched-vs-unbatched parity sweep ``cli serve
--selftest`` runs.
"""
from __future__ import annotations

import json
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fks_tpu_torch import obs
from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.obs.history import SLOConfig, record_slo_burn
from fks_tpu_torch.obs.watchdog import ParitySentinel
from fks_tpu_torch.obs.workload import (
    QueryFingerprinter, TenantAccountant, tenant_of,
)
from fks_tpu_torch.resilience.deadline import Deadline, ResilienceError
from fks_tpu_torch.resilience.degrade import (
    DegradeConfig, DegradedModeManager,
)
from fks_tpu_torch.serve.artifact import ChampionSpec, ServeEngine
from fks_tpu_torch.serve.batcher import RequestBatcher, pods_to_dicts


class ServeService:
    """The request/metrics layer over a warm ``ServeEngine``.

    ``submit(query)`` resolves the query to a pod list (failing fast on
    malformed input, before it can poison a batch), hands it to the
    coalescer, and returns a Future of the answer dict. ``audit_every=N``
    routes every Nth request back through ``engine.reference_answer`` and
    the ParitySentinel — a served answer that drifts from the exact
    engine raises an alert event, not just a log line."""

    def __init__(self, engine: ServeEngine, *, recorder=None,
                 max_batch: Optional[int] = None, max_wait_s: float = 0.005,
                 audit_every: int = 0, audit_tol: float = 1e-5,
                 slo: Optional[SLOConfig] = None, slo_every: int = 100,
                 replay_buffer: int = 64,
                 max_queue: int = 0, default_deadline_s: float = 0.0,
                 accounting: bool = False, workload_every: int = 100):
        self.engine = engine
        self.recorder = recorder if recorder is not None else obs.get_recorder()
        self.audit_every = int(audit_every)
        # tenant/workload accounting (obs.workload): OFF by default —
        # the disabled path allocates nothing and touches no lock, the
        # NullRecorder rule applied to accounting
        self.accountant: Optional[TenantAccountant] = None
        self.fingerprinter: Optional[QueryFingerprinter] = None
        self.workload_every = max(1, int(workload_every))
        self._wl_marks = 0
        if accounting:
            self.accountant = TenantAccountant(slo=slo)
            self.fingerprinter = QueryFingerprinter()
        # resilience knobs: bounded queue + per-request deadline default
        # (a query's own deadline_ms always wins); 0 disables each
        self.default_deadline_s = float(default_deadline_s)
        self._degrade: Optional[DegradedModeManager] = None
        # serve-tier SLO (obs.history.SLOConfig): p99/qps targets
        # priced as error-budget burn rates — one slo_burn metric every
        # ``slo_every`` requests plus one at summary(), so ``cli watch``
        # alerts live and the exporter publishes fks_slo_* gauges
        self.slo = slo if slo is not None else SLOConfig()
        self.slo_every = max(1, int(slo_every))
        self._slo_marks = 0
        self.sentinel = ParitySentinel(None, tol=audit_tol,
                                       recorder=self.recorder)
        self._batcher = RequestBatcher(
            self._handle_batch,
            max_batch=max_batch or engine.envelope.max_batch,
            max_wait_s=max_wait_s, max_queue=max_queue,
            recorder=self.recorder, expired_cb=self._note_expired)
        if self.accountant is not None:
            # per-tenant Retry-After: a shed request's back-off hint is
            # priced at the shedding tenant's own EWMA service time
            self._batcher.admission.service_time_for = \
                self.accountant.ewma_service_s
        self._seq = 0
        self._latencies_ms: List[float] = []
        self._t_first: Optional[float] = None
        self._t_last: float = 0.0
        self.audits = 0
        self.audit_failures = 0
        # last-N answered pod lists: the shadow-eval replay source for
        # the promotion pipeline (a candidate is judged on the traffic
        # the incumbent actually saw, not a synthetic guess)
        self._replay: deque = deque(maxlen=max(1, int(replay_buffer)))
        self.swaps = 0

    # ----- engine hot-swap + replay

    def swap_engine(self, new_engine):
        """Flip what the service serves; returns the rollback handle.

        Two shapes, one seam:

        - a warm ``ServeEngine`` (the AOT closure path): a single
          attribute assignment is the entire swap — ``_handle_batch``
          reads ``self.engine`` once per batch, so an in-flight batch
          finishes on the old engine and the next lands on the new one;
          returns the old ENGINE. Safe only if ``new_engine`` is already
          warm (the promotion controller builds and warms the bucket
          ladder off the request path).
        - a ``ChampionSpec`` (the VM-native path): the resident engine
          re-binds its champion tables IN PLACE via ``swap_program`` —
          a packed H2D upload, no rebuild, no new object; returns the
          old ``ChampionSpec``, so a probation rollback passing it back
          here symmetrically re-uploads the old tables."""
        if isinstance(new_engine, ChampionSpec):
            swap = getattr(self.engine, "swap_program", None)
            if swap is None:
                raise TypeError(
                    "swap_engine(ChampionSpec) requires a VM-native engine "
                    "with swap_program; this service runs "
                    f"engine_kind={getattr(self.engine, 'engine_kind', '?')}")
            old = swap(new_engine)
        else:
            old = self.engine
            self.engine = new_engine
        self.swaps += 1
        return old

    def enable_degraded_mode(self, fallback_factory, rebuild_factory=None,
                             config: Optional[DegradeConfig] = None
                             ) -> DegradedModeManager:
        """Arm device-fault degradation: a classified device fault inside
        ``_handle_batch`` flips this service to ``fallback_factory``'s
        reduced-batch exact engine (via ``swap_engine``) and retries the
        batch there, while ``rebuild_factory`` rebuilds the primary off
        the request path; recovery is gated through probation."""
        self._degrade = DegradedModeManager(
            self, fallback_factory, rebuild_factory=rebuild_factory,
            config=config, recorder=self.recorder)
        return self._degrade

    @property
    def degrade(self) -> Optional[DegradedModeManager]:
        return self._degrade

    def recent_queries(self, n: int) -> List[List[dict]]:
        """The last ``n`` answered pod lists, oldest first — shadow-eval
        replay traffic."""
        items = list(self._replay)
        return [list(q) for q in items[-max(0, int(n)):]]

    def preload_replay(self, queries: Sequence[Sequence[dict]]) -> int:
        """Refill the replay buffer from a persisted serve state (the
        drain/resume path) so shadow evals have traffic from minute one."""
        for q in queries:
            self._replay.append([dict(p) for p in q])
        return len(self._replay)

    @property
    def requests_served(self) -> int:
        return len(self._latencies_ms)

    def latencies_since(self, mark: int) -> List[float]:
        """Per-request latencies recorded after request index ``mark`` —
        the probation window the rollback gate prices."""
        return list(self._latencies_ms[max(0, int(mark)):])

    # ----- query resolution

    def resolve_query(self, query: Dict[str, Any]) -> Tuple[str, List[dict]]:
        """A request JSON -> (request_id, pod list).

        ``{"pods": [...]}`` places an explicit pod list; ``{"trace": path,
        "limit": N}`` replays a what-if trace — its first N pods (default:
        whatever fits the envelope) against the PINNED cluster, which is
        the serving question ("what would the champion do with this
        arrival stream here"), not a re-evaluation on the trace's own
        cluster."""
        if not isinstance(query, dict):
            raise ValueError("query must be a JSON object")
        rid = str(query.get("id", ""))
        if not rid:
            self._seq += 1
            rid = f"r{self._seq:06d}"
        if "pods" in query:
            pods = query["pods"]
        elif "trace" in query:
            from fks_tpu_torch.data.traces import TraceParser

            wl = TraceParser().parse_workload(pod_file=query["trace"])
            limit = int(query.get("limit", self.engine.envelope.max_pods))
            pods = pods_to_dicts(wl.pods, limit=limit)
        else:
            raise ValueError("query needs 'pods' (pod list) or 'trace' "
                             "(what-if trace to replay)")
        return rid, pods

    def submit(self, query: Dict[str, Any]):
        """Resolve + enqueue; returns a Future resolving to the answer
        dict (with ``id`` and ``latency_ms`` attached). Raises
        ``ShedError`` when admission control refuses the request (queue
        full / deadline unmeetable / draining)."""
        rid, pods = self.resolve_query(query)
        tenant = tenant_of(query)
        deadline = Deadline.from_query(query, self.default_deadline_s)
        # every admitted request starts ONE causal trace; the context
        # object rides the queue to the batcher thread (null path: no
        # recorder -> no context is ever allocated)
        ctx = (trace_ctx.new_trace()
               if getattr(self.recorder, "enabled", False) else None)
        try:
            return self._batcher.submit(
                self._make_item(rid, pods, tenant, query),
                deadline=deadline, ctx=ctx)
        except ResilienceError:
            if self.accountant is not None:
                self.accountant.note_shed(tenant)
            raise

    def _make_item(self, rid: str, pods: List[dict], tenant: str,
                   query: Dict[str, Any]) -> tuple:
        """The queue item for one admitted request. Position 0 is the
        request id, 1 the pod list, 2 the tenant (the batcher's admission
        and expiry hooks read index 2); subclasses may append routing
        fields (the portfolio service appends the slot index)."""
        return (rid, pods, tenant)

    def _note_expired(self, item) -> None:
        """Batcher callback: a request's deadline expired while queued —
        charge the tenant (the batcher knows futures, not tenants)."""
        if self.accountant is not None:
            self.accountant.note_expired(item[2])

    def close(self) -> None:
        self._batcher.close()

    def drain(self, grace_s: float = 5.0) -> Dict[str, Any]:
        """Preemption path: stop admitting, complete or shed every
        in-flight Future within the grace budget. Returns the batcher's
        completion accounting."""
        return self._batcher.drain(grace_s)

    def healthz(self) -> Dict[str, Any]:
        """The liveness/readiness view the HTTP front serves at
        ``/healthz`` and the exporter publishes as gauges."""
        adm = self._batcher.admission
        degrade = self._degrade.healthz() if self._degrade is not None \
            else {"state": "normal", "flips": 0, "recoveries": 0,
                  "last_fault": ""}
        return {
            "ok": degrade["state"] != "dead",
            "engine": self.engine.engine_name,
            "engine_state": degrade["state"],
            "queue_depth": adm.depth,
            "shed_total": adm.shed_total + self._batcher.shed_draining,
            "shed_rate": round(adm.shed_rate, 4),
            "expired": self._batcher.expired,
            "requests_served": self.requests_served,
            "degrade": degrade,
        }

    # ----- batch handling (batcher thread)

    def _answer(self, engine, items: List[tuple]) -> List[dict]:
        """One batch through one engine — the routing seam. The base
        service serves every request on the pinned engine; the portfolio
        service threads per-request slot indices and splits off
        coverage-fallback requests here."""
        return engine.answer_batch([it[1] for it in items])

    def _handle_batch(self, items: List[tuple],
                      enq_times: List[float]) -> List[dict]:
        # pin the engine once per batch: the promotion controller may
        # swap ``self.engine`` concurrently, and a batch must be answered
        # (and audited) by ONE engine end to end
        engine = self.engine
        t_start = time.perf_counter()
        fault: Optional[Tuple[BaseException, float]] = None
        try:
            answers = self._answer(engine, items)
        except Exception as e:  # noqa: BLE001 — maybe a device fault
            t_fail = time.perf_counter()
            if self._degrade is None or not self._degrade.on_fault(e):
                raise
            # the manager flipped us to the fallback engine: retry the
            # batch there (re-pin — swap_engine already landed); the
            # failed primary attempt stays on each request's trace
            fault = (e, t_fail - t_start)
            engine = self.engine
            answers = self._answer(engine, items)
        done = time.perf_counter()
        inflight = self._batcher.inflight()
        self._trace_batch(engine, inflight, t_start, done, fault)
        if self._t_first is None:
            self._t_first = min(enq_times)
        self._t_last = done
        occupancy = len(items) / self._batcher.max_batch
        for i, (item, enq, ans) in enumerate(
                zip(items, enq_times, answers)):
            rid, pods, tenant = item[0], item[1], item[2]
            latency_ms = (done - enq) * 1e3
            ans["id"] = rid
            ans["latency_ms"] = round(latency_ms, 3)
            tid = inflight[i].trace_id if i < len(inflight) else None
            if tid:
                ans["trace_id"] = tid
            self._replay.append(pods)
            self._latencies_ms.append(latency_ms)
            wl_class = ""
            if self.fingerprinter is not None:
                wl_class = self.fingerprinter.observe(pods)
            if self.accountant is not None:
                self.accountant.note_request(tenant, latency_ms,
                                             degraded=fault is not None)
            self.recorder.metric(
                "serve_request", request_id=rid, tenant=tenant,
                latency_ms=round(latency_ms, 3), batch_size=len(items),
                batch_occupancy=round(occupancy, 4),
                bucket_pods=ans["bucket_pods"],
                bucket_lanes=ans["bucket_lanes"],
                **({"trace_id": tid} if tid else {}),
                **({"workload_class": wl_class} if wl_class else {}))
            if self.audit_every > 0 and \
                    len(self._latencies_ms) % self.audit_every == 0:
                self._audit(engine, rid, pods, ans)
        if (self.slo.enabled
                and len(self._latencies_ms) // self.slo_every
                > self._slo_marks):
            self._slo_marks = len(self._latencies_ms) // self.slo_every
            record_slo_burn(self.slo, self._latencies_ms,
                            self._elapsed(), recorder=self.recorder)
        if (self.accountant is not None
                and len(self._latencies_ms) // self.workload_every
                > self._wl_marks):
            self._wl_marks = len(self._latencies_ms) // self.workload_every
            self.accountant.record(self.recorder)
            if self.fingerprinter is not None:
                self.fingerprinter.record_mix(self.recorder)
        if self._degrade is not None:
            self._degrade.after_batch(len(items))
        return answers

    def _trace_batch(self, engine: ServeEngine, inflight, t_start: float,
                     done: float, fault) -> None:
        """Per-request latency waterfalls: one ``serve/request`` root plus
        queue_wait / batch_wait / pack_h2d / dispatch / scatter_back
        children for every traced request of the batch just answered.

        All spans are written after the fact with EXPLICIT end
        timestamps (``ts`` override), so reconstruction places each bar
        where the work actually happened. The engine-stage split reuses
        the host-wall decomposition the engine already measures
        (``last_batch_timing``); the batch-level pack/dispatch costs are
        shared by every lane, so each request reports the same split —
        the truthful statement for a coalesced batch. A degraded-mode
        retry adds a ``primary_attempt`` child carrying the fault class,
        linking primary-fail -> fallback-retry on ONE trace."""
        if not getattr(self.recorder, "enabled", False):
            return
        timing = getattr(engine, "last_batch_timing", None) or {}
        pack_s = float(timing.get("pack_h2d_s", 0.0))
        disp_s = float(timing.get("dispatch_s", 0.0))
        retry_s = fault[1] if fault is not None else 0.0
        scatter_s = max((done - t_start) - retry_s - pack_s - disp_s, 0.0)
        wall_done = time.time()

        def _ts(perf_t: float) -> float:
            # perf_counter point -> wall-clock event timestamp
            return wall_done - (done - perf_t)

        rec = self.recorder
        t_run = t_start + retry_s  # successful attempt began here
        for r in inflight:
            ctx = r.ctx
            if ctx is None:
                continue
            t_deq = min(max(r.t_deq, r.t_enq), t_start)
            # tenant identity rides the root span as an attribute, so a
            # waterfall (and any span query) can slice by tenant
            tenant = r.query[2] if len(r.query) > 2 else ""
            trace_ctx.emit(rec, trace_ctx.SERVE_ROOT, done - r.t_enq,
                           ctx=ctx, root=True, ts=_ts(done),
                           **({"tenant": tenant} if tenant else {}))
            trace_ctx.emit(rec, "serve/request/queue_wait",
                           t_deq - r.t_enq, ctx=ctx, ts=_ts(t_deq))
            trace_ctx.emit(rec, "serve/request/batch_wait",
                           t_start - t_deq, ctx=ctx, ts=_ts(t_start))
            if fault is not None:
                trace_ctx.emit(rec, "serve/request/primary_attempt",
                               retry_s, ctx=ctx, ts=_ts(t_run),
                               fault=type(fault[0]).__name__)
            trace_ctx.emit(rec, "serve/request/pack_h2d", pack_s,
                           ctx=ctx, ts=_ts(t_run + pack_s))
            trace_ctx.emit(rec, "serve/request/dispatch", disp_s,
                           ctx=ctx, ts=_ts(t_run + pack_s + disp_s))
            trace_ctx.emit(rec, "serve/request/scatter_back", scatter_s,
                           ctx=ctx, ts=_ts(done))

    def _audit(self, engine: ServeEngine, rid: str, pods: List[dict],
               ans: dict) -> None:
        ref = engine.reference_answer(pods)
        ok = self.sentinel.audit_served(
            rid, ans["score"], ref["score"],
            placements_match=ans["placements"] == ref["placements"])
        self.audits += 1
        if not ok:
            self.audit_failures += 1

    # ----- stats

    def _elapsed(self) -> float:
        return (self._t_last - self._t_first) \
            if self._t_first is not None else 0.0

    def summary(self, record: bool = True) -> dict:
        lat = np.asarray(self._latencies_ms, np.float64)
        elapsed = self._elapsed()
        out = {
            "requests": len(lat),
            "batches": self._batcher.batches,
            "mean_occupancy": round(self._batcher.mean_occupancy, 4),
            "p50_ms": round(float(np.percentile(lat, 50)), 3) if len(lat)
            else 0.0,
            "p99_ms": round(float(np.percentile(lat, 99)), 3) if len(lat)
            else 0.0,
            "qps": round(len(lat) / elapsed, 2) if elapsed > 0 else 0.0,
            "cold_compiles": self.engine.cold_compiles,
            "engine_kind": getattr(self.engine, "engine_kind", "aot"),
            "policy_tier": getattr(self.engine, "policy_tier", ""),
            "audits": self.audits,
            "audit_failures": self.audit_failures,
            "swaps": self.swaps,
            "queue_depth": self._batcher.admission.depth,
            "shed_total": (self._batcher.admission.shed_total
                           + self._batcher.shed_draining),
            "shed_rate": round(self._batcher.admission.shed_rate, 4),
            "expired": self._batcher.expired,
            "engine_state": (self._degrade.state
                             if self._degrade is not None else "normal"),
        }
        # VM-native engine extras: the capacity bucket its executables
        # are keyed on and the zero-rebuild swap accounting
        cap = getattr(self.engine, "program_capacity", None)
        if cap:
            out["program_capacity"] = int(cap)
            out["vm_swaps"] = int(getattr(self.engine, "vm_swaps", 0))
            out["vm_swap_h2d_bytes"] = int(
                getattr(self.engine, "vm_swap_h2d_bytes", 0))
        # device-resident snapshot cache + H2D accounting (engines
        # predating the cache — or test doubles — simply omit the block)
        cache_stats = getattr(self.engine, "snapshot_cache_stats", None)
        if callable(cache_stats):
            out["snapshot_cache"] = cache_stats()
        if self.slo.enabled:
            out["slo"] = record_slo_burn(
                self.slo, self._latencies_ms, elapsed,
                recorder=self.recorder if record else obs.NULL)
        if self.accountant is not None:
            out["fairness_index"] = round(
                self.accountant.fairness_index(), 4)
            out["tenants"] = self.accountant.record(
                self.recorder if record else None)
            if self.fingerprinter is not None:
                mix = self.fingerprinter.record_mix(
                    self.recorder if record else None, reset=False)
                if mix:
                    out["workload_mix"] = mix
        if record:
            self.recorder.metric("serve", **{k: v for k, v in out.items()
                                             if k not in ("slo",
                                                          "snapshot_cache",
                                                          "tenants",
                                                          "workload_mix")})
            if callable(cache_stats):
                self.recorder.metric("snapshot_cache",
                                     **out["snapshot_cache"])
        return out


# ------------------------------------------------------------------ fronts


def run_jsonl(service: ServeService, stream_in=None, stream_out=None) -> int:
    """JSONL front: one request object per input line, one answer object
    per output line, INPUT ORDER preserved (answers are scattered back to
    their line even when batching reorders completion). A malformed line
    answers ``{"id", "error"}`` instead of killing the stream. Returns
    the number of failed requests."""
    stream_in = stream_in if stream_in is not None else sys.stdin
    stream_out = stream_out if stream_out is not None else sys.stdout
    results: List[Tuple[str, Any]] = []  # (rid, Future | error dict)
    errors = 0
    for lineno, line in enumerate(stream_in, 1):
        line = line.strip()
        if not line:
            continue
        try:
            query = json.loads(line)
            results.append(("", service.submit(query)))
        except ResilienceError as e:  # shed at admission: typed 503 body
            errors += 1
            results.append(("", {"id": f"line{lineno}", **e.to_json()}))
        except Exception as e:  # noqa: BLE001 — per-line 4xx semantics
            errors += 1
            results.append(("", {"id": f"line{lineno}", "error": str(e)}))
    service.close()  # flush the tail batch before draining futures
    for _, res in results:
        if isinstance(res, dict):
            ans = res
        else:
            try:
                ans = res.result()
            except ResilienceError as e:
                errors += 1
                ans = e.to_json()
            except Exception as e:  # noqa: BLE001
                errors += 1
                ans = {"error": str(e)}
        print(json.dumps(ans), file=stream_out)
    return errors


def make_http_server(service: ServeService, port: int = 0, *,
                     host: str = "127.0.0.1",
                     max_requests: Optional[int] = None,
                     deadline_s: float = 60.0):
    """Build (but do not run) the concurrent HTTP front: POST /query
    (request JSON -> answer JSON), GET /stats (service summary), GET
    /healthz (resilience view). The server is a ``ThreadingHTTPServer``
    with DAEMON threads — each request is handled on its own thread, so
    N clients genuinely overlap (two POSTs can sit in the SAME coalesced
    batch; a single-threaded front would serialize them and every
    measured qps number would be an artifact of the listener, not the
    service) and a wedged keep-alive socket cannot block shutdown.
    ``deadline_s`` bounds how long a POST waits on its Future;
    shed/expired/timed-out requests answer a STRUCTURED 503 with a
    Retry-After hint instead of a hung socket. ``port=0`` binds an
    ephemeral port — read it back from ``server.server_address``.
    ``max_requests`` stops the listener after N queries (test/loadgen
    hook)."""
    import concurrent.futures as cf
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    served = {"n": 0}

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, doc: dict,
                  retry_after_s: Optional[float] = None) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after_s is not None:
                self.send_header("Retry-After",
                                 f"{max(0.0, retry_after_s):.3f}")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                hz = service.healthz()
                self._send(200 if hz["ok"] else 503, hz)
            elif self.path == "/stats":
                self._send(200, service.summary(record=False))
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path != "/query":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                query = json.loads(self.rfile.read(n))
                ans = service.submit(query).result(
                    timeout=deadline_s if deadline_s > 0 else None)
                self._send(200, ans)
            except ResilienceError as e:
                self._send(e.http_status, e.to_json(),
                           retry_after_s=e.retry_after_s)
            except cf.TimeoutError:
                self._send(503, {"error": f"no answer within {deadline_s}s",
                                 "kind": "deadline"})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                self._send(500, {"error": str(e)})
            served["n"] += 1
            if max_requests is not None and served["n"] >= max_requests:
                import threading
                threading.Thread(target=server.shutdown, daemon=True).start()

        def log_message(self, *a):  # quiet: the recorder is the log
            pass

    class Server(ThreadingHTTPServer):
        # per-request threads must not outlive the process: a client
        # holding a socket open would otherwise block interpreter exit
        daemon_threads = True
        # loadgen opens one connection per request from many concurrent
        # workers; the default listen backlog of 5 intermittently drops
        # a SYN under bursts, stalling that connect into kernel
        # retransmit backoff (seconds to ~30 s) and poisoning the
        # measured elapsed window with one phantom-slow request
        request_queue_size = 128

    server = Server((host, port), Handler)
    return server


def run_http(service: ServeService, port: int, *, host: str = "127.0.0.1",
             max_requests: Optional[int] = None,
             deadline_s: float = 60.0,
             drain_coordinator=None) -> None:
    """Run the concurrent HTTP front (``make_http_server``) until
    interrupted. A ``DrainCoordinator`` (optional) gets the
    server-shutdown callback so SIGTERM drains the batcher, persists
    state, then closes the listener."""
    server = make_http_server(service, port, host=host,
                              max_requests=max_requests,
                              deadline_s=deadline_s)
    if drain_coordinator is not None:
        drain_coordinator.add_callback(
            lambda: __import__("threading").Thread(
                target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


# ----------------------------------------------------------------- selftest


def selftest(engine: ServeEngine, count: int = 8, pods_per_query: int = 4,
             tol: float = 1e-5) -> dict:
    """Batched-vs-unbatched parity sweep: ``count`` queries sliced from
    the pinned workload's real pods (sliding windows, so queries differ),
    answered through the batched warm path and re-answered one-by-one by
    the unbatched exact engine. The serve gate's contract: every score
    within ``tol``, every placement list identical.

    The batched pass runs through a real ``ServeService`` (submit ->
    coalescer -> handler), not a bare ``answer_batch`` call, so every
    selftest request exercises — and, under a flight recorder, TRACES —
    the same path production requests take (the run_full_suite trace
    gate reconstructs a complete waterfall per request from this)."""
    base = engine.base_pods
    if not base:  # artifact pinned with an empty trace — synthesize
        base = [{"cpu_milli": 1 + i, "memory_mib": 1, "creation_time": i,
                 "duration_time": 100} for i in range(pods_per_query * 2)]
    queries = []
    for i in range(count):
        start = i % max(1, len(base) - pods_per_query + 1)
        q = base[start:start + pods_per_query]
        queries.append(q if q else base[:1])
    service = ServeService(engine, max_wait_s=0.002)
    futures = [service.submit({"id": f"selftest-{i:03d}", "pods": q})
               for i, q in enumerate(queries)]
    service.close()  # flush the tail batch; every Future resolves
    batched = [f.result() for f in futures]
    max_drift = 0.0
    placements_ok = True
    failures = []
    for i, (q, ans) in enumerate(zip(queries, batched)):
        ref = engine.reference_answer(q)
        drift = abs(ans["score"] - ref["score"])
        max_drift = max(max_drift, drift)
        same = ans["placements"] == ref["placements"]
        placements_ok = placements_ok and same
        if drift > tol or not same:
            failures.append({"query": i, "drift": round(drift, 8),
                             "placements_match": same})
    out = {
        "ok": not failures,
        "checked": len(queries),
        "max_drift": round(max_drift, 10),
        "placements_match": placements_ok,
        "tol": tol,
        "engine": engine.engine_name,
        "engine_kind": getattr(engine, "engine_kind", "aot"),
        "policy_tier": getattr(engine, "policy_tier", ""),
        "failures": failures[:5],
    }
    cap = getattr(engine, "program_capacity", None)
    if cap:
        out["program_capacity"] = int(cap)
    cache_stats = getattr(engine, "snapshot_cache_stats", None)
    if callable(cache_stats):
        out["snapshot_cache"] = cache_stats()
    if getattr(engine, "mesh", None) is not None:
        out["mesh_devices"] = int(getattr(engine, "_shards", 1))
    return out
