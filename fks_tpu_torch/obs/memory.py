"""Memory observability: footprint ledger, watermark sampler, leak sentinel.

Port of fks_tpu.obs.memory. Three pillars, all host-side:

- **Executable-footprint ledger.** fks_tpu prices a compiled XLA program
  from its ``memory_analysis()``. The port's counterpart of a compiled
  program is a captured CUDA graph, priced by ``capture_footprint``: the
  caching allocator's peak across the capture
  (``torch.cuda.max_memory_allocated``, reset around it) above what was
  allocated before it, plus the bytes of the graph's static inputs, in
  fks_tpu's record fields. On the CPU there is no allocator to read, and
  the record is None, as fks_tpu's is on a backend that cannot price a
  program. ``rollup`` aggregates the ledger per (component,
  mesh_layout).
- **Watermark sampler.** ``WatermarkSampler`` records per-card
  watermarks (``torch.cuda.memory_stats`` in fks_tpu's canonical keys,
  ``obs.telemetry.normalize_memory_stats``, with deltas against the
  start fence), host RSS via ``resource.getrusage``, and optional
  ``tracemalloc`` top-N host attribution, as ``memory_watermark``
  metrics: from a background thread on an interval, or per
  ``StageProfiler`` stage through the profiler's ``sampler=`` hook. On
  the CPU a device row carries its identity only, as fks_tpu's CPU rows
  do.
- **Leak sentinel.** ``LeakSentinel`` fences the live-tensor count and
  bytes around N iterations of a hot loop and records a ``leak_check``
  verdict against a drift tolerance. fks_tpu reads ``jax.live_arrays()``;
  the port reads, with a card, the caching allocator's live blocks and
  bytes (``allocation.all.current`` and ``allocated_bytes.all.current``
  summed over the cards), and without one the distinct storages of every
  live ``torch.Tensor`` (a walk of the collector's objects). A CUDA
  graph's pool is allocated when it is captured, not when it is
  replayed, so a warm swap or batch loop shows zero drift. Two drills,
  ``vm_swap_leak`` and ``snapshot_cache_bound``, hold that contract.

Read back by ``cli mem`` (the footprint ladder and the watermark table,
``obs.report._memory_section``).
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from fks_tpu_torch.obs.recorder import get_recorder
from fks_tpu_torch.obs.telemetry import cuda_memory_stats

#: closed vocabulary for memory_footprint.component — which tier built
#: the executable (fks_tpu's)
MEMORY_COMPONENTS = ("serve_aot", "serve_vm", "evolve", "bench")

#: closed vocabulary for leak_check.loop — which hot loop was fenced
LEAK_LOOPS = ("serve_batch", "vm_swap", "promotion", "evolve_generation",
              "drill")

#: canonical footprint byte keys, in ladder-rendering order
FOOTPRINT_KEYS = ("temp_bytes", "argument_bytes", "output_bytes",
                  "generated_code_bytes")


@contextlib.contextmanager
def capture_footprint(device, argument_bytes: int = 0
                      ) -> Iterator[Dict[str, int]]:
    """Price the CUDA graph captured inside the block: yields a dict that
    holds, after the block, the footprint in fks_tpu's keys — temp bytes
    (the allocator's peak during the block above its level before),
    ``argument_bytes`` (the caller's count of the graph's static inputs),
    no output or code bytes (results are read from the inputs' buffers),
    and their ``total_bytes`` sum. Empty on the CPU."""
    import torch

    out: Dict[str, int] = {}
    dev = torch.device(device)
    if dev.type != "cuda":
        yield out
        return
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    yield out
    torch.cuda.synchronize(dev)
    out.update(temp_bytes=max(0, torch.cuda.max_memory_allocated(dev)
                              - base),
               argument_bytes=int(argument_bytes), output_bytes=0,
               generated_code_bytes=0)
    out["total_bytes"] = sum(out[k] for k in FOOTPRINT_KEYS)


def mesh_layout_label(mesh: Any) -> str:
    """A mesh's layout as a stable comparison key, ``"pop=4,scn=2"`` from
    its axis shape (``parallel.mesh.Mesh.shape``); empty without a mesh
    (fks_tpu/obs/memory.py:102-112)."""
    if mesh is None:
        return ""
    return ",".join(f"{k}={int(v)}" for k, v in mesh.shape.items())


class FootprintLedger:
    """Bounded in-process ledger of recorded executable footprints.
    Thread-safe appends (serve captures happen under batcher threads)."""

    def __init__(self, cap: int = 512):
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []

    def add(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._records.append(dict(record))
            if len(self._records) > self.cap:
                del self._records[: len(self._records) - self.cap]

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


#: the process-wide ledger every ``record_footprint`` lands in (alongside
#: the active flight recorder, when one is enabled)
LEDGER = FootprintLedger()


def record_footprint(component: str, exe_key: Any, *,
                     footprint: Optional[Dict[str, int]] = None,
                     mesh: Any = None, recorder=None,
                     **fields) -> Optional[Dict[str, Any]]:
    """One ``memory_footprint`` record for a captured graph: the
    ``footprint`` bytes (``capture_footprint``) tagged with ``component``
    (closed vocabulary), a stable ``exe_key`` (e.g. ``"lanes=2,pods=8"``)
    and the mesh layout. Lands in the in-process ``LEDGER`` and on the
    recorder. Returns the record, or None when there is no footprint (the
    CPU) — callers never branch on it."""
    if component not in MEMORY_COMPONENTS:
        raise ValueError(f"unknown memory component {component!r} "
                         f"(expect one of {sorted(MEMORY_COMPONENTS)})")
    if not footprint:
        return None
    rec: Dict[str, Any] = {
        "component": component,
        "exe_key": str(exe_key),
        "mesh_layout": mesh_layout_label(mesh),
        **footprint,
        **fields,
    }
    LEDGER.add(rec)
    r = recorder if recorder is not None else get_recorder()
    r.metric("memory_footprint", dict(rec))
    return rec


def rollup(records: Optional[List[Dict[str, Any]]] = None
           ) -> List[Dict[str, Any]]:
    """Per-(component, mesh_layout) aggregate over footprint records
    (default: the process ledger): executable count, per-key byte sums,
    the ``predicted_hbm_bytes`` total and the single largest
    executable's temp claim, sorted largest-first
    (fks_tpu/obs/memory.py:173)."""
    recs = LEDGER.records() if records is None else records
    by: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for r in recs:
        key = (str(r.get("component", "")), str(r.get("mesh_layout", "")))
        a = by.setdefault(key, {
            "component": key[0], "mesh_layout": key[1], "executables": 0,
            "predicted_hbm_bytes": 0, "peak_temp_bytes": 0,
            **{k: 0 for k in FOOTPRINT_KEYS}})
        a["executables"] += 1
        for k in FOOTPRINT_KEYS:
            a[k] += int(r.get(k, 0))
        total = int(r.get("total_bytes",
                          sum(int(r.get(k, 0)) for k in FOOTPRINT_KEYS)))
        a["predicted_hbm_bytes"] += total
        a["peak_temp_bytes"] = max(a["peak_temp_bytes"],
                                   int(r.get("temp_bytes", 0)))
    return sorted(by.values(), key=lambda a: -a["predicted_hbm_bytes"])


# ----------------------------------------------------- watermark sampler


def host_rss_kb() -> int:
    """Peak resident set size of this process in KB (``ru_maxrss`` is KB
    on Linux, bytes on macOS — normalized to KB). 0 where the resource
    module is unavailable."""
    try:
        import resource
        import sys
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss // 1024) if sys.platform == "darwin" else int(rss)
    except (ImportError, OSError):  # pragma: no cover - no getrusage
        return 0


def _device_rows() -> List[Tuple[Dict[str, Any], Optional[Dict[str, int]]]]:
    """(identity, canonical stats) per card; one CPU row with no stats
    without a card."""
    import torch

    if not torch.cuda.is_available():
        return [({"id": 0, "platform": "cpu"}, None)]
    return [({"id": i, "platform": "gpu"}, cuda_memory_stats(i))
            for i in range(torch.cuda.device_count())]


def _device_watermarks(base: Dict[int, Dict[str, int]]
                       ) -> List[Dict[str, Any]]:
    """Per-device canonical memory stats plus the delta against the
    sampler's start fence. The CPU contributes an identity-only row —
    present, so the table says "this backend does not report"."""
    out: List[Dict[str, Any]] = []
    for ident, stats in _device_rows():
        row = dict(ident)
        if stats:
            row.update(stats)
            b = base.get(ident["id"], {})
            if "bytes_in_use" in stats and "bytes_in_use" in b:
                row["delta_bytes"] = (stats["bytes_in_use"]
                                      - b["bytes_in_use"])
        out.append(row)
    return out


class WatermarkSampler:
    """Low-overhead memory watermark recorder (module docstring).

    ``enabled=False`` is the off path: ``start``/``stop``/``sample`` are
    no-ops, no thread exists, nothing is recorded. Enabled, each
    ``sample(stage=...)`` lands one ``memory_watermark`` metric: host
    RSS, per-device canonical watermarks with deltas against the start
    fence, and — when ``tracemalloc`` is tracing or ``trace_host=True``
    started it — the top-N allocation sites.

    ``interval_s > 0`` + ``start()`` runs a daemon thread sampling on
    that cadence (``stage="interval"``); ``sample`` stays callable
    inline (the StageProfiler ``sampler=`` hook calls it per stage).
    """

    def __init__(self, enabled: bool = True, interval_s: float = 0.0,
                 top_n: int = 5, trace_host: bool = False, recorder=None,
                 cap: int = 1024):
        self.enabled = bool(enabled)
        self.interval_s = float(interval_s)
        self.top_n = int(top_n)
        self.trace_host = bool(trace_host)
        self.recorder = recorder if recorder is not None else get_recorder()
        self.cap = int(cap)
        self.samples: List[Dict[str, Any]] = []
        self._base_rss_kb = 0
        self._base_dev: Dict[int, Dict[str, int]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._own_tracemalloc = False

    # ----- lifecycle

    def start(self) -> "WatermarkSampler":
        """Fence the baselines (RSS + per-device bytes_in_use) and, with
        an interval, launch the daemon sampling thread."""
        if not self.enabled:
            return self
        self._base_rss_kb = host_rss_kb()
        self._base_dev = {ident["id"]: stats
                          for ident, stats in _device_rows() if stats}
        if self.trace_host:
            import tracemalloc
            if not tracemalloc.is_tracing():
                tracemalloc.start()
                self._own_tracemalloc = True
        if self.interval_s > 0 and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="fks-mem-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=max(1.0, 2 * self.interval_s))
            self._thread = None
        if self._own_tracemalloc:
            import tracemalloc
            tracemalloc.stop()
            self._own_tracemalloc = False

    def __enter__(self) -> "WatermarkSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample(stage="interval")

    # ----- sampling

    def _top_allocs(self) -> List[Dict[str, Any]]:
        import tracemalloc

        if not tracemalloc.is_tracing() or self.top_n <= 0:
            return []
        try:
            stats = tracemalloc.take_snapshot().statistics("lineno")
        except RuntimeError:  # pragma: no cover - snapshot raced a stop()
            return []
        return [{"site": f"{s.traceback[0].filename}:"
                         f"{s.traceback[0].lineno}",
                 "kb": round(s.size / 1024.0, 1), "count": int(s.count)}
                for s in stats[: self.top_n]]

    def sample(self, stage: str = "") -> Dict[str, Any]:
        """One ``memory_watermark`` record for the current instant (empty
        dict when disabled)."""
        if not self.enabled:
            return {}
        rss = host_rss_kb()
        rec: Dict[str, Any] = {
            "stage": stage or "manual",
            "host_rss_kb": rss,
            "host_rss_delta_kb": rss - self._base_rss_kb,
            "devices": _device_watermarks(self._base_dev),
        }
        top = self._top_allocs()
        if top:
            rec["top_allocs"] = top
        self.samples.append(rec)
        if len(self.samples) > self.cap:
            del self.samples[: len(self.samples) - self.cap]
        self.recorder.metric("memory_watermark", dict(rec))
        return rec


#: shared disabled sampler — instrumented paths default to this, so
#: watermark sampling never needs an ``if sampler:`` guard
NULL_SAMPLER = WatermarkSampler(enabled=False)


# -------------------------------------------------------- leak sentinel


def live_array_stats() -> Dict[str, int]:
    """Count and total bytes of the live tensors in the process — the
    leak sentinel's fence reading (fks_tpu reads ``jax.live_arrays()``).
    With a card: the caching allocator's live blocks and allocated bytes,
    summed over the cards. Without one: the distinct storages of every
    live ``torch.Tensor`` the collector tracks (views share a storage
    and count once)."""
    import torch

    if torch.cuda.is_available():
        count = total = 0
        for i in range(torch.cuda.device_count()):
            raw = torch.cuda.memory_stats(i)
            count += int(raw.get("allocation.all.current", 0))
            total += int(raw.get("allocated_bytes.all.current", 0))
        return {"count": count, "bytes": total}
    storages: Dict[int, int] = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): isinstance reads ``__class__``, which
        # some module proxies the collector tracks answer with a warning
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):
            continue  # sparse, meta or otherwise storage-less
        storages[st.data_ptr()] = st.nbytes()
    return {"count": len(storages), "bytes": sum(storages.values())}


class LeakSentinel:
    """Fence the live tensors around N iterations of a hot loop and
    record the drift verdict.

    ``fence()`` before the loop (after warm-up: caches, constants and
    graph pools allocated on first use are residency, not leaks), run
    the loop, then ``check(iterations)``: one ``leak_check`` metric with
    the count/byte drift and ``ok`` judged against the tolerances
    (default: zero net growth). Both fences ``gc.collect()`` first, so
    Python-side garbage holding tensors is not counted as a leak."""

    def __init__(self, loop: str, tolerance_count: int = 0,
                 tolerance_bytes: int = 0, recorder=None):
        if loop not in LEAK_LOOPS:
            raise ValueError(f"unknown leak loop {loop!r} "
                             f"(expect one of {sorted(LEAK_LOOPS)})")
        self.loop = loop
        self.tolerance_count = int(tolerance_count)
        self.tolerance_bytes = int(tolerance_bytes)
        self.recorder = recorder if recorder is not None else get_recorder()
        self.baseline: Optional[Dict[str, int]] = None
        self.result: Optional[Dict[str, Any]] = None

    def fence(self) -> Dict[str, int]:
        _settle()
        self.baseline = live_array_stats()
        return self.baseline

    def check(self, iterations: int) -> Dict[str, Any]:
        if self.baseline is None:
            raise RuntimeError("fence() before check()")
        _settle()
        now = live_array_stats()
        drift_count = now["count"] - self.baseline["count"]
        drift_bytes = now["bytes"] - self.baseline["bytes"]
        rec = {
            "loop": self.loop,
            "iterations": int(iterations),
            "drift_count": int(drift_count),
            "drift_bytes": int(drift_bytes),
            "baseline_count": self.baseline["count"],
            "baseline_bytes": self.baseline["bytes"],
            "ok": (drift_count <= self.tolerance_count
                   and drift_bytes <= self.tolerance_bytes),
        }
        self.result = rec
        self.recorder.metric("leak_check", dict(rec))
        return rec


def _settle() -> None:
    """Collect Python garbage and, with a card, let the queued work end,
    so a fence reads what is live, not what is about to be freed."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def leak_fence(loop: str, iterations: int, tolerance_count: int = 0,
               tolerance_bytes: int = 0,
               recorder=None) -> Iterator[LeakSentinel]:
    """``with leak_fence("vm_swap", 50) as s: ...`` — fence on entry,
    check on exit; the verdict is ``s.result`` (never raises on drift:
    gating is the caller's call)."""
    s = LeakSentinel(loop, tolerance_count=tolerance_count,
                     tolerance_bytes=tolerance_bytes, recorder=recorder)
    s.fence()
    try:
        yield s
    finally:
        s.check(iterations)


# --------------------------------------------------------------- drills


def _drill_workload():
    """fks_tpu's drill workload: 8 nodes x 16 pods, deterministic."""
    from fks_tpu_torch.data.synthetic import synthetic_workload

    return synthetic_workload(8, 16, seed=0)


def _drill_envelope():
    from fks_tpu_torch.serve.artifact import ShapeEnvelope

    return ShapeEnvelope(max_pods=8, min_pod_bucket=8, max_batch=2,
                         max_gpu_milli=1000)


def _drill_queries(n: int, pods: int = 3) -> List[List[dict]]:
    return [[{"cpu_milli": 10 + 7 * i + j, "memory_mib": 50 + 11 * j,
              "creation_time": j, "duration_time": 40}
             for j in range(pods)] for i in range(n)]


def drill_vm_swap_leak(swaps: int = 50, batches: int = 200,
                       recorder=None, device=None) -> Dict[str, Any]:
    """``swaps`` consecutive ``swap_program`` promotions alternating two
    champions, interleaved with ``batches`` served batches, must show
    zero net growth of the live tensors: every swap copies the program
    into the graph's own tables, every batch into its staging buffers.
    Warm-up (one full swap cycle + a served batch per champion, which
    captures the bucket's graph) happens before the fence."""
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.serve.artifact import ChampionSpec
    from fks_tpu_torch.serve.vm_engine import VMServeEngine

    champs = [
        ChampionSpec(code=template.fill_template("score = 1000"),
                     score=0.4, source="<drill-a>"),
        ChampionSpec(code=template.fill_template(
            "score = 1000 + (node.cpu_milli_left - pod.cpu_milli) "
            "/ max(1, node.cpu_milli_total)"), score=0.9,
            source="<drill-b>"),
    ]
    eng = VMServeEngine(champs[0], _drill_workload(),
                        envelope=_drill_envelope(), engine="flat",
                        device=device)
    queries = _drill_queries(2)
    for c in (champs[1], champs[0]):
        eng.swap_program(c)
        eng.answer_batch(queries)
    sent = LeakSentinel("vm_swap", recorder=recorder)
    sent.fence()
    b = 0
    for i in range(int(swaps)):
        eng.swap_program(champs[(i + 1) % 2])
        while b * swaps < (i + 1) * batches:  # interleave evenly
            eng.answer_batch(queries)
            b += 1
    while b < int(batches):
        eng.answer_batch(queries)
        b += 1
    rec = sent.check(int(swaps) + b)
    return {"ok": bool(rec["ok"]), "drill": "vm_swap_leak",
            "swaps": int(swaps), "batches": b, **rec}


def drill_snapshot_cache_bound(max_bytes: int = 0, recorder=None,
                               device=None) -> Dict[str, Any]:
    """The serve engine's snapshot-table cache must respect a byte
    ceiling, not just an entry count: stream distinct-content queries
    (each a cache miss) through an engine whose cache is capped at about
    two tables' bytes and verify the resident total never exceeds the
    cap, eviction happened, and a re-sent recent query still hits."""
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.serve.artifact import ChampionSpec, ServeEngine

    champ = ChampionSpec(code=template.fill_template("score = 1000"),
                         score=0.4, source="<drill>")
    probe = ServeEngine(champ, _drill_workload(),
                        envelope=_drill_envelope(), engine="flat",
                        device=device)
    # distinct real pod counts -> distinct snapshot-trigger tables (counts
    # 1..8 inside the one pod bucket give 8 distinct cache entries)
    distinct = [[{"cpu_milli": 10 + j, "memory_mib": 50 + j,
                  "creation_time": j, "duration_time": 40}
                 for j in range(n)] for n in range(1, 9)]
    probe.answer_batch(distinct[:1])
    one_table = max(probe.snapshot_cache_bytes, 1)
    cap = int(max_bytes) or 2 * one_table
    eng = ServeEngine(champ, _drill_workload(), envelope=_drill_envelope(),
                      engine="flat", snapshot_cache_max_bytes=cap,
                      device=device)
    over = 0
    for q in distinct:
        eng.answer_batch([q])
        if eng.snapshot_cache_bytes > cap:
            over += 1
    stats = eng.snapshot_cache_stats()
    hits0 = stats["hits"]
    eng.answer_batch([distinct[-1]])  # most recent survivor must hit
    stats = eng.snapshot_cache_stats()
    evicted = stats["misses"] > stats["entries"]
    rehit = stats["hits"] > hits0
    ok = over == 0 and evicted and rehit
    rec = {"ok": ok, "drill": "snapshot_cache_bound",
           "cap_bytes": cap, "over_cap_observations": over,
           "evicted": evicted, "recent_rehit": rehit, **stats}
    r = recorder if recorder is not None else get_recorder()
    r.metric("leak_check", loop="drill",
             iterations=len(distinct), drift_count=over,
             drift_bytes=max(0, stats["bytes"] - cap), ok=ok)
    return rec


#: drill name -> callable returning {"ok": bool, ...} — the ``cli mem
#: --drill`` dispatch table
DRILLS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "vm_swap_leak": drill_vm_swap_leak,
    "snapshot_cache_bound": drill_snapshot_cache_bound,
}


def run_drill(name: str, **kw) -> Dict[str, Any]:
    """Run one named memory drill (``device=`` as the serve engines',
    default ``cuda``); raises ``KeyError`` on unknown names."""
    if name not in DRILLS:
        raise KeyError(f"unknown memory drill {name!r} "
                       f"(expect one of {sorted(DRILLS)})")
    t0 = time.perf_counter()
    out = DRILLS[name](**kw)
    out["seconds"] = round(time.perf_counter() - t0, 3)
    return out
