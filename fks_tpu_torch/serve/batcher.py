"""Request coalescing onto the lane axis.

Port of fks_tpu.serve.batcher. A what-if query is a one-trace lane: N
concurrent queries cost one batched run. Each query becomes a padded
workload at its pod bucket's fixed shape, the queries are stacked leaf by
leaf (``parallel.traces.stack_traces``'s recipe at a FIXED bucket shape, so
every same-bucket batch fits the same captured CUDA graph), the lane axis
is padded to the graph's lane bucket by repeating the last query
(``parallel.population.pad_population``'s rule), and each lane's answer is
scattered back to its request.

Three layers here, none of which import the artifact layer (so the
dependency points artifact -> batcher):

- query -> padded ``Workload`` construction (``build_query_workload``)
  + leaf-wise stacking with sentinel-padded snapshot tables
  (``stack_queries``, ``stack_query_tables``), and the 16-bit upload
  packing of query and program tables (``query_pack_plan``);
- ``RequestBatcher``: the flush-policy coalescer (max batch / max wait)
  mapping concurrent ``submit()`` futures onto synchronous batch calls;
- pod-array <-> dict conversion helpers shared by the CLI/service layer.

Host-staged tables are numpy (so the engine can hash and count bytes
before any transfer, as fks_tpu does); ``unpack_*`` widen them on the
device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fks_tpu_torch.data.entities import PodArrays, Workload
from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.parallel.traces import strip_ids
from fks_tpu_torch.resilience.admission import (
    AdmissionConfig, AdmissionController,
)
from fks_tpu_torch.resilience.deadline import (
    Deadline, DeadlineExceeded, ResilienceError, ShedError,
)
from fks_tpu_torch.sim.engine import stack_states, zip_tensors
from fks_tpu_torch.sim.evaluator import (
    max_snapshot_count, snapshot_trigger_table,
)

#: query pod schema — the reference entity field names (simulator/
#: entities.py:29-43), matching the LLM-facing template docstring
POD_FIELDS = ("cpu_milli", "memory_mib", "num_gpu", "gpu_milli",
              "creation_time", "duration_time")

#: default lifetime for query pods that omit duration_time: effectively
#: "never deleted inside the what-if horizon"
DEFAULT_DURATION = 1_000_000

#: the PodArrays tensor fields, in declaration order
PODARRAY_FIELDS = ("cpu", "mem", "num_gpu", "gpu_milli", "creation_time",
                   "duration", "tie_rank", "pod_mask")


def validate_query_pods(pods: Sequence[Dict[str, Any]], *, max_pods: int,
                        max_gpu_milli: int) -> None:
    """Reject malformed queries before any device work (the error message
    is the service's 4xx body)."""
    if not pods:
        raise ValueError("query has no pods")
    if len(pods) > max_pods:
        raise ValueError(
            f"query has {len(pods)} pods > envelope max_pods {max_pods}")
    for i, p in enumerate(pods):
        if not isinstance(p, dict):
            raise ValueError(f"pod {i} is not an object")
        gm = int(p.get("gpu_milli", 0))
        if gm > max_gpu_milli:
            raise ValueError(
                f"pod {i} gpu_milli {gm} > envelope max_gpu_milli "
                f"{max_gpu_milli}")
        for field in ("cpu_milli", "memory_mib", "num_gpu", "gpu_milli"):
            if int(p.get(field, 0)) < 0:
                raise ValueError(f"pod {i} {field} is negative")


def _pod_columns(pods: Sequence[Dict[str, Any]], bucket: int) -> dict:
    """One query's PodArrays columns as numpy, padded to ``bucket``.
    Pod ids are zero-padded ordinals, so the reference's lexicographic
    tie order equals index order and ``tie_rank = arange`` reproduces it
    exactly. Padding rows are zeros under a False pod_mask."""
    p_real = len(pods)
    if p_real > bucket:
        raise ValueError(f"{p_real} pods exceed pod bucket {bucket}")

    def col(field: str, default: int = 0) -> np.ndarray:
        a = np.zeros(bucket, np.int32)
        for i, p in enumerate(pods):
            a[i] = int(p.get(field, default))
        return a

    return dict(
        cpu=col("cpu_milli"), mem=col("memory_mib"),
        num_gpu=col("num_gpu"), gpu_milli=col("gpu_milli"),
        creation_time=col("creation_time"),
        duration=col("duration_time", DEFAULT_DURATION),
        tie_rank=np.arange(bucket, dtype=np.int32),
        pod_mask=np.arange(bucket) < p_real)


def build_query_workload(cluster, pods: Sequence[Dict[str, Any]],
                         bucket: int) -> Workload:
    """One query -> a ``Workload`` padded to the pod bucket, on the
    cluster's device (fks_tpu's ``build_query_workload``)."""
    cols = _pod_columns(pods, bucket)
    dev = cluster.cpu_total.device
    pa = PodArrays(**{k: torch.from_numpy(v).to(dev)
                      for k, v in cols.items()},
                   pod_ids=tuple(f"q-{i:05d}" for i in range(len(pods))))
    return Workload(cluster=cluster, pods=pa, faults=None)


def _query_ktable(wls: Sequence[Workload], cfg, klen: int) -> np.ndarray:
    """Per-query snapshot trigger tables at the bucket's fixed width:
    each table is sized from the query's REAL pod count (the reference's
    ``initialize(total_events)`` semantics) and padded with the INT32_MAX
    sentinel, which never fires."""
    kt = np.full((len(wls), klen), KT_SENTINEL, np.int32)
    for i, w in enumerate(wls):
        tbl = snapshot_trigger_table(
            w.num_pods,
            max_snapshot_count(cfg.max_steps, w.num_pods,
                               cfg.snapshot_interval),
            cfg.snapshot_interval)
        if len(tbl) > klen:
            raise ValueError(
                f"query with {w.num_pods} pods needs {len(tbl)} snapshot "
                f"slots > bucket table width {klen}; route it to a smaller "
                "bucket")
        kt[i, : len(tbl)] = tbl
    return kt


def stack_queries(mod, cluster, pod_lists: Sequence[Sequence[dict]],
                  bucket: int, cfg, klen: int):
    """Stack Q query workloads into (workload[Q,...], ktable i32[Q,K],
    state0[Q,...]) at the bucket's fixed shapes, on the cluster's device.
    ``cfg.max_steps`` must be the bucket's resolved step budget."""
    max_steps = cfg.max_steps
    assert max_steps is not None, "bucket SimConfig must pin max_steps"
    wls = [build_query_workload(cluster, p, bucket) for p in pod_lists]
    kt = _query_ktable(wls, cfg, klen)
    states = [mod.initial_state(w, cfg) for w in wls]
    stacked_wl = zip_tensors(torch.stack, [strip_ids(w) for w in wls])
    return (stacked_wl, torch.from_numpy(kt).to(cluster.cpu_total.device),
            stack_states(states))


def stack_query_tables(mod, cluster, pod_lists: Sequence[Sequence[dict]],
                       bucket: int, cfg, klen: int):
    """``stack_queries`` split for the serve hot path: returns
    ``(pods[Q,...], ktable[Q,K], state0[Q,...])`` with the pod tables and
    the snapshot table as host numpy (a PodArrays of numpy columns) and
    the initial states as host tensors (``cluster`` should be the host
    copy: the exact engine builds its initial heap with CPython heapq).

    The constant cluster arrays are not stacked or returned — the serve
    engine keeps them in its captured graphs — so a batch ships only the
    query delta (pod tables), the snapshot trigger table (content-hash
    cached on the device by the engine) and the initial state."""
    max_steps = cfg.max_steps
    assert max_steps is not None, "bucket SimConfig must pin max_steps"
    cols = [_pod_columns(p, bucket) for p in pod_lists]
    wls = [build_query_workload(cluster, p, bucket) for p in pod_lists]
    kt = _query_ktable(wls, cfg, klen)
    stacked_pods = PodArrays(**{f: np.stack([c[f] for c in cols])
                                for f in PODARRAY_FIELDS})
    states = [mod.initial_state(w, cfg) for w in wls]
    return stacked_pods, kt, stack_states(states)


# ------------------------------------------------- packed query uploads
#
# SimConfig.state_pack narrows the FLAT engine's carry columns to 16-bit
# where ranges provably fit (sim/flat.py). The serve upload path reuses
# the same idea on the REQUEST tables: the wire/H2D format is 16-bit, the
# engine widens back to int32 on the device, and every packing decision is
# static per bucket — never per batch — so the buffers a graph reads keep
# their shapes.

#: int32 sentinel in snapshot trigger tables ("never fires")
KT_SENTINEL = np.iinfo(np.int32).max
#: its image on the packed (uint16) upload path
KT_SENTINEL_PACKED = np.iinfo(np.uint16).max


def query_pack_plan(cfg, bucket: int, max_gpu_milli: int) -> dict:
    """The static per-bucket packing plan for query upload tables (empty
    unless ``cfg.state_pack``). Packable columns and their proofs:

    - ``ktable`` -> uint16: trigger steps are bounded by the bucket's
      ``max_steps`` plus the last fractional-progress rung (< max_steps
      + bucket for the reference 0.05 interval), so they fit below the
      remapped sentinel whenever ``max_steps + bucket + 4 < 65535``;
    - ``gpu_milli`` -> int16: admission validates every pod against the
      envelope's ``max_gpu_milli``;
    - ``tie_rank`` -> int16: always ``arange(bucket)``.

    All casts are integer->integer with proven ranges, so the round trip
    through ``pack_query_tables``/``unpack_query_tables`` is
    bit-identical."""
    if not getattr(cfg, "state_pack", False):
        return {}
    plan: Dict[str, Any] = {}
    if (cfg.max_steps is not None
            and cfg.max_steps + bucket + 4 < KT_SENTINEL_PACKED):
        plan["ktable"] = np.uint16
    if 0 <= int(max_gpu_milli) <= np.iinfo(np.int16).max:
        plan["gpu_milli"] = np.int16
    if bucket <= np.iinfo(np.int16).max:
        plan["tie_rank"] = np.int16
    return plan


def pack_query_tables(pods: PodArrays, kt: np.ndarray, plan: dict):
    """Apply a ``query_pack_plan`` to host-staged tables (numpy, before
    upload). Identity when the plan is empty."""
    if not plan:
        return pods, kt
    if "ktable" in plan:
        kt = np.where(kt == KT_SENTINEL,
                      KT_SENTINEL_PACKED, kt).astype(plan["ktable"])
    repl = {f: np.asarray(getattr(pods, f)).astype(plan[f])
            for f in ("gpu_milli", "tie_rank") if f in plan}
    if repl:
        pods = dataclasses.replace(pods, **repl)
    return pods, kt


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A host numpy table as a tensor of the same bytes: uint16 rides as
    its int16 bit pattern (``unpack_query_tables`` widens it back)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def unpack_query_tables(pods: PodArrays, kt: torch.Tensor, plan: dict):
    """Invert ``pack_query_tables`` on the tables' device (uploaded
    through ``to_tensor``): widen back to the engine's int32, remapping the
    ktable sentinel. The H2D transfer stays packed."""
    if not plan:
        return pods, kt
    if "ktable" in plan:
        k = kt.to(torch.int32) & 0xFFFF  # the uint16 value of its bits
        kt = torch.where(k == int(KT_SENTINEL_PACKED),
                         torch.full_like(k, int(KT_SENTINEL)), k)
    repl = {f: getattr(pods, f).to(torch.int32)
            for f in ("gpu_milli", "tie_rank") if f in plan}
    if repl:
        pods = dataclasses.replace(pods, **repl)
    return pods, kt


def pack_program_tables(prog) -> tuple:
    """A ``VMProgram`` -> the packed host-side wire tuple the VM serve
    engine uploads on a hot-swap: the four i32[O] op-index tables ride
    ONE contiguous ``i32[4, O]`` buffer and the two i32 scalars one
    ``i32[2]`` buffer, so a champion swap ships 4 H2D transfers
    (tables/imm/consts/meta) instead of 8. Host numpy throughout, so the
    engine can size and account the transfer before it happens."""
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    tables = np.stack([host(prog.opcode), host(prog.a), host(prog.b),
                       host(prog.c)]).astype(np.int32)
    meta = np.asarray([int(prog.n_ops), int(prog.out_reg)], np.int32)
    return (tables, host(prog.imm), host(prog.consts), meta)


def unpack_program_tables(packed):
    """Invert ``pack_program_tables`` on the tables' device: views of the
    contiguous table block as the ``VMProgram`` the VM executor consumes
    (views, so a graph that reads them reads whatever is copied into the
    block later)."""
    from fks_tpu_torch.funsearch.vm import VMProgram

    tables, imm, consts, meta = packed
    return VMProgram(opcode=tables[0], a=tables[1], b=tables[2],
                     c=tables[3], imm=imm, consts=consts,
                     n_ops=meta[0], out_reg=meta[1])


def pack_portfolio_tables(progs) -> tuple:
    """N ``VMProgram``s -> ONE stacked packed wire tuple: the per-slot
    ``pack_program_tables`` tuples gain a leading slot axis, so a whole
    portfolio ships as the same 4 H2D transfers a single champion does
    (i32[S,4,O] tables / f[S,O] imm / f[S,32] consts / i32[S,2] meta)."""
    packed = [pack_program_tables(p) for p in progs]
    return tuple(np.stack([pk[i] for pk in packed]) for i in range(4))


def unpack_portfolio_tables(packed):
    """Invert ``pack_portfolio_tables`` on the device: the stacked block
    back into ONE slot-stacked ``VMProgram`` (leading slot axis on every
    field) that ``vm.select_slot`` gathers per lane."""
    from fks_tpu_torch.funsearch.vm import VMProgram

    tables, imm, consts, meta = packed
    return VMProgram(opcode=tables[:, 0], a=tables[:, 1], b=tables[:, 2],
                     c=tables[:, 3], imm=imm, consts=consts,
                     n_ops=meta[:, 0], out_reg=meta[:, 1])


def tree_h2d_bytes(*trees) -> int:
    """Total bytes a host->device upload of these objects ships (numpy
    arrays and tensors, in tuples, lists or dataclasses) — the engine's
    ``serve_h2d_bytes_per_query`` accounting."""
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, np.ndarray):
            total += x.nbytes
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    for t in trees:
        walk(t)
    return int(total)


def pods_to_dicts(pods: PodArrays, limit: Optional[int] = None) -> List[dict]:
    """Real pod rows back to query-schema dicts — sources selftest and
    trace-replay queries from a parsed workload."""
    host = lambda x: np.asarray(x.cpu() if hasattr(x, "cpu") else x)  # noqa: E731
    mask = host(pods.pod_mask)
    idx = np.nonzero(mask)[0]
    if limit is not None:
        idx = idx[:limit]
    cols = {
        "cpu_milli": host(pods.cpu),
        "memory_mib": host(pods.mem),
        "num_gpu": host(pods.num_gpu),
        "gpu_milli": host(pods.gpu_milli),
        "creation_time": host(pods.creation_time),
        "duration_time": host(pods.duration),
    }
    return [{k: int(v[i]) for k, v in cols.items()} for i in idx]


class QueuedRequest:
    """One queued submit: the query, its Future, its timestamps, and —
    when tracing is on — the caller's ``TraceContext``, carried OBJECT-
    in-hand across the submit-thread -> worker-thread boundary (the hop
    where thread-local span nesting loses causality)."""

    __slots__ = ("query", "fut", "t_enq", "deadline", "ctx", "t_deq")

    def __init__(self, query, fut, t_enq, deadline, ctx):
        self.query = query
        self.fut = fut
        self.t_enq = t_enq
        self.deadline = deadline
        self.ctx = ctx
        self.t_deq = t_enq  # stamped by the worker at dequeue

    @property
    def trace_id(self):
        return self.ctx.trace_id if self.ctx is not None else None


class RequestBatcher:
    """Flush-policy request coalescer over a synchronous batch handler.

    ``submit(query)`` returns a Future; a daemon thread accumulates
    pending requests and flushes a batch when it reaches ``max_batch``
    OR the oldest pending request has waited ``max_wait_s`` — the
    classic latency/occupancy trade. The handler receives
    ``(queries, enqueue_times)`` and returns one answer per query in
    order (scatter-back is positional); a handler exception fails every
    future in the batch. ``close()`` flushes the remainder and joins.

    Resilience hooks (``resilience``):

    - every submit passes ADMISSION CONTROL: a bounded queue
      (``max_queue``) plus a projected-wait check against the request's
      ``Deadline`` — refused work raises ``ShedError`` (an HTTP 503 with
      Retry-After upstream) instead of queueing to miss its deadline;
    - a request whose deadline expires while queued is completed with
      ``DeadlineExceeded``, never silently handled late;
    - every dequeued Future is completed EXACTLY ONCE — the batch-failure
      path, a short handler answer list, and drain-time shedding all
      resolve through one ``_complete`` funnel;
    - ``drain()`` is the SIGTERM path: stop admitting, give the worker a
      grace budget to finish real work, then shed whatever remains with
      a typed error so no client ever hangs on a dying server.

    Tracing hooks (``obs.trace_ctx``): ``submit(..., ctx=)`` (or the
    submitting thread's active context) rides the ``QueuedRequest`` to
    the worker; every typed error raised or completed for a traced
    request carries its ``trace_id`` (so 503 bodies correlate to the
    flight-recorder trail), and the handler can read the in-flight
    requests' contexts/timestamps via ``inflight()`` to emit per-request
    waterfall spans."""

    def __init__(self, handle_batch: Callable[[list, list], list],
                 max_batch: int = 8, max_wait_s: float = 0.005,
                 max_queue: int = 0,
                 admission_cfg: Optional[AdmissionConfig] = None,
                 recorder: Any = None,
                 expired_cb: Optional[Callable[[Any], None]] = None):
        from fks_tpu_torch.obs.recorder import get_recorder

        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._handle = handle_batch
        # accounting hook: called with the QUERY of every request whose
        # deadline expired while queued (the service charges the tenant;
        # the batcher knows futures, not tenants). Must not raise.
        self._expired_cb = expired_cb
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        cfg = admission_cfg or AdmissionConfig()
        if max_queue:
            cfg = dataclasses.replace(cfg, max_queue=int(max_queue))
        self.admission = AdmissionController(cfg)
        self.recorder = recorder if recorder is not None else get_recorder()
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.batches = 0
        self.submitted = 0
        self.completed = 0
        self.expired = 0
        self.shed_inflight = 0  # dequeued futures shed at drain time
        self.shed_draining = 0  # submits refused because drain started
        self._occupancy_sum = 0.0
        self._closed = False
        self._draining = False
        self._shed_mode = False  # grace exhausted: flush = shed, not run
        self._inflight: Sequence[QueuedRequest] = ()
        self._thread = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True)
        self._thread.start()

    def submit(self, query, deadline: Optional[Deadline] = None,
               ctx: Optional[trace_ctx.TraceContext] = None) -> Future:
        if ctx is None:  # inherit the submitting thread's trace, if any
            ctx = trace_ctx.current()
        tid = ctx.trace_id if ctx is not None else None
        if self._draining:  # before the closed check: drain() sets both,
            # and a drained server sheds with a TYPED error
            self.shed_draining += 1
            self.recorder.event("shed", reason="draining",
                                queue_depth=self.admission.depth,
                                **({"trace_id": tid} if tid else {}))
            raise ShedError("server is draining", reason="draining",
                            trace_id=tid)
        if self._closed:
            raise RuntimeError("batcher is closed")
        try:
            # the service's query tuple carries the tenant at index 2
            # (the _note_expired convention): admission uses it to price
            # the Retry-After hint at the SHEDDING tenant's service time
            tenant = (query[2] if isinstance(query, tuple)
                      and len(query) > 2 else None)
            self.admission.admit(deadline, tenant=tenant)
        except ShedError as e:
            e.trace_id = tid
            self.recorder.event("shed", reason=e.reason,
                                queue_depth=self.admission.depth,
                                retry_after_s=e.retry_after_s,
                                **({"trace_id": tid} if tid else {}))
            raise
        self.submitted += 1
        fut: Future = Future()
        self._q.put(QueuedRequest(query, fut, time.perf_counter(),
                                  deadline, ctx))
        return fut

    def inflight(self) -> Sequence[QueuedRequest]:
        """The requests of the batch currently inside the handler (their
        contexts + enqueue/dequeue stamps) — read by the handler itself
        to emit per-request waterfall spans. Empty outside a handler
        call; only meaningful ON the worker thread."""
        return self._inflight

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()

    def drain(self, grace_s: float = 5.0) -> Dict[str, Any]:
        """SIGTERM path: shed new submits, let the worker finish queued
        work within ``grace_s``, then shed the remainder with a typed
        error. Returns completion accounting; never leaves a Future
        pending."""
        if self._closed:
            return {"pending": 0, "completed": 0, "expired": 0,
                    "shed": 0, "stuck": False}
        pending_at = self.admission.depth
        c0, e0, s0 = self.completed, self.expired, self.shed_inflight
        self._draining = True
        self._q.put(None)
        self._thread.join(max(0.0, float(grace_s)))
        if self._thread.is_alive():
            # grace exhausted — remaining flushes shed instead of running
            self._shed_mode = True
            self._thread.join(max(0.1, float(grace_s)))
        self._closed = True
        return {"pending": pending_at,
                "completed": self.completed - c0,
                "expired": self.expired - e0,
                "shed": self.shed_inflight - s0,
                "stuck": self._thread.is_alive()}

    @property
    def mean_occupancy(self) -> float:
        """Mean fraction of max_batch filled per flushed batch."""
        return self._occupancy_sum / self.batches if self.batches else 0.0

    # ----- internals

    @staticmethod
    def _complete(fut: Future, *, result=None, exc=None) -> bool:
        """The single completion funnel: every dequeued Future resolves
        through here exactly once (a cancelled or already-completed
        Future is left alone, never raised over)."""
        if not fut.set_running_or_notify_cancel():
            return False  # client cancelled while queued
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except InvalidStateError:  # pragma: no cover — funnel invariant
            return False
        return True

    def _loop(self) -> None:
        pending: List[QueuedRequest] = []
        while True:
            timeout = None
            if pending:
                waited = time.perf_counter() - pending[0].t_enq
                timeout = max(0.0, self.max_wait_s - waited)
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:  # oldest request hit max_wait
                self._flush(pending)
                pending = []
                continue
            if item is None:  # close/drain sentinel
                self._flush(pending)
                return
            item.t_deq = time.perf_counter()
            pending.append(item)
            if len(pending) >= self.max_batch:
                self._flush(pending)
                pending = []

    def _flush(self, pending: List[QueuedRequest]) -> None:
        if not pending:
            return
        self.admission.release(len(pending))
        if self._shed_mode:  # drain grace exhausted: typed shed, no work
            for r in pending:
                if self._complete(r.fut, exc=ShedError(
                        "server shut down before this request ran",
                        trace_id=r.trace_id)):
                    self.shed_inflight += 1
            return
        live: List[QueuedRequest] = []
        for r in pending:
            if r.deadline is not None and r.deadline.expired():
                if self._complete(r.fut, exc=DeadlineExceeded(
                        "deadline expired while queued",
                        trace_id=r.trace_id)):
                    self.expired += 1
                    self.admission.note_expired()
                    if self._expired_cb is not None:
                        try:
                            self._expired_cb(r.query)
                        except Exception:  # noqa: BLE001 — accounting
                            pass  # must never fail the drain/flush path
            else:
                live.append(r)
        if not live:
            return
        self.batches += 1
        self._occupancy_sum += len(live) / self.max_batch
        queries = [r.query for r in live]
        enq = [r.t_enq for r in live]
        t0 = time.perf_counter()
        self._inflight = live
        try:
            answers = self._handle(queries, enq)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
            for r in live:
                self._complete(r.fut, exc=e)
            return
        finally:
            self._inflight = ()
        self.admission.note_batch(len(live), time.perf_counter() - t0)
        answers = list(answers)
        for i, r in enumerate(live):
            if i < len(answers):
                if self._complete(r.fut, result=answers[i]):
                    self.completed += 1
            else:
                # a short answer list must FAIL the unmatched futures,
                # never leave them hanging (the old zip() bug)
                self._complete(r.fut, exc=ResilienceError(
                    f"batch handler returned {len(answers)} answers for "
                    f"{len(live)} queries", reason="short_answer",
                    trace_id=r.trace_id))
