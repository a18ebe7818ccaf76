"""Device-time attribution: per-stage wall / compile / compute split.

Port of fks_tpu.obs.profiler. The flight recorder's spans say how long a
scope took; this module says where the time went. A ``StageProfiler``
owns a ``CompileWatcher`` (``obs.telemetry``) and carves a run into named
stages — codegen / sandbox+preflight / transpile / device-eval / rank /
ledger for the evolution loop, per-bucket compile and warmup for serving
— each fenced with ``utils.profiling.block_until_ready`` (a
``torch.cuda.synchronize`` on the cards of the value a stage syncs), so
a stage's wall clock includes the device work it queued, not just the
Python that queued it. Per stage it reports:

- ``wall_seconds``: fenced wall time of the scope;
- ``compile_seconds`` / ``compile_count``: the CUDA graph captures made
  inside the stage and their seconds, read as a before/after delta off
  the compile watcher. A capture is the port's counterpart of an XLA
  compile (``obs.telemetry``), so this split counts captures where
  fks_tpu's counts XLA backend compiles;
- ``compute_seconds``: the remainder;
- occupancy, when the caller annotates the launch shape: pad-lane waste
  from ``parallel.population.occupancy_stats`` folds into
  ``utilization_pct``, the share of launched lane-time spent on real
  candidates computing. fks_tpu also prices an attached XLA
  ``cost_analysis`` FLOP count into ``est_flops_per_sec``; PyTorch has no
  such count, so the port records neither field.

Each stage lands as one ``device_profile`` metric on the recorder;
``summary()`` aggregates by stage name and reports the attributed share
of a measured wall interval (fks_tpu's 95% bar) with the rest called
idle.

A disabled profiler (``NULL_PROFILER``, or ``StageProfiler(enabled=
False)``) yields a shared handle that drops its annotations and returns
values unsynced: the instrumented call sites need no branch and the
unprofiled path adds no device fence.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Optional

from fks_tpu_torch.obs.recorder import get_recorder
from fks_tpu_torch.obs.telemetry import CompileWatcher
from fks_tpu_torch.utils.profiling import block_until_ready


class StageHandle:
    """What an enabled ``stage(...)`` scope yields: annotate launch-shape
    fields onto the stage record, fence device values into its clock."""

    __slots__ = ("fields", "record")

    def __init__(self, **fields) -> None:
        self.fields: Dict[str, Any] = dict(fields)
        self.record: Optional[Dict[str, Any]] = None  # set at stage exit

    def annotate(self, **fields) -> None:
        """Attach occupancy fields (e.g. ``occupancy_stats`` output) to
        the stage's device_profile record."""
        self.fields.update(fields)

    def sync(self, value: Any) -> Any:
        """Wait until the device work behind ``value`` is done, so it
        lands inside this stage's wall clock. Returns ``value``."""
        return block_until_ready(value)


class _NullHandle:
    """The disabled handle: annotate drops fields, sync is identity."""

    __slots__ = ()
    record = None

    def annotate(self, **fields) -> None:
        pass

    def sync(self, value: Any) -> Any:
        return value


_NULL_HANDLE = _NullHandle()


class StageProfiler:
    """Attribute wall time to named pipeline stages (module docstring).

    ``enabled=False`` is the off path: ``stage()`` yields a shared no-op
    handle and records nothing. The ``recorder`` (default: the
    process-wide active flight recorder) receives one ``device_profile``
    metric per completed stage; ``records`` keeps them in memory too.
    ``sampler`` (an ``obs.memory.WatermarkSampler``) takes one watermark
    sample per completed stage.
    """

    def __init__(self, enabled: bool = True, scope: str = "evolve",
                 recorder=None, watcher: Optional[CompileWatcher] = None,
                 sampler=None):
        self.enabled = bool(enabled)
        self.scope = scope
        self.recorder = recorder if recorder is not None else get_recorder()
        self.sampler = sampler
        self.records: List[Dict[str, Any]] = []
        self._depth = 0
        self._segments = 0
        self._t_start = time.perf_counter()
        self.watcher: Optional[CompileWatcher] = None
        self._own_watcher = False
        if self.enabled:
            if watcher is None:
                watcher = CompileWatcher(recorder=self.recorder).install()
                self._own_watcher = True
            self.watcher = watcher

    def close(self) -> None:
        """Uninstall the owned capture watcher (a borrowed one is the
        caller's to manage)."""
        if self._own_watcher and self.watcher is not None:
            self.watcher.uninstall()

    def __enter__(self) -> "StageProfiler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----- stages

    @contextlib.contextmanager
    def stage(self, name: str, **fields) -> Iterator[Any]:
        """A named attribution scope. Nested stages record with their
        ``depth``; only depth-0 stages count toward the summary totals
        (an inner stage's wall is already inside its parent's)."""
        if not self.enabled:
            yield _NULL_HANDLE
            return
        handle = StageHandle(**fields)
        depth = self._depth
        self._depth += 1
        seg0 = self._segments
        c_s0 = self.watcher.backend_compile_seconds
        c_n0 = self.watcher.backend_compile_count
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            wall = time.perf_counter() - t0
            self._depth -= 1
            compile_s = self.watcher.backend_compile_seconds - c_s0
            compile_n = self.watcher.backend_compile_count - c_n0
            segs = self._segments - seg0
            rec: Dict[str, Any] = {
                "scope": self.scope, "stage": name, "depth": depth,
                "wall_seconds": round(wall, 6),
                "compile_seconds": round(min(compile_s, wall), 6),
                "compile_count": int(compile_n),
                "compute_seconds": round(max(0.0, wall - compile_s), 6),
            }
            if segs:
                rec["segments"] = int(segs)
            rec.update(handle.fields)
            _finish_utilization(rec)
            handle.record = rec
            self.records.append(rec)
            self.recorder.metric("device_profile", dict(rec))
            if self.sampler is not None:
                self.sampler.sample(stage=name)

    def segment_tick(self, n: int = 1) -> None:
        """Count a dispatched trace segment against the open stage (the
        segmented runner's ``on_segment`` callback)."""
        self._segments += int(n)

    # ----- summaries

    def summary(self, measured_wall: Optional[float] = None,
                emit: bool = False) -> Dict[str, Any]:
        """Aggregate depth-0 stages by name (wall/compile/compute sums,
        occurrence counts, per-stage share of the attributed total) and
        judge coverage against ``measured_wall`` (default: time since
        construction): ``attributed_fraction`` is the 95% acceptance
        number, the remainder ``idle_fraction``. ``emit=True`` also lands
        the aggregate as a ``stage="__total__"`` device_profile metric."""
        top = [r for r in self.records if r.get("depth", 0) == 0]
        by: Dict[str, Dict[str, Any]] = {}
        for r in top:
            a = by.setdefault(r["stage"], {
                "stage": r["stage"], "count": 0, "wall_seconds": 0.0,
                "compile_seconds": 0.0, "compute_seconds": 0.0,
                "compile_count": 0, "segments": 0})
            a["count"] += 1
            a["wall_seconds"] += float(r["wall_seconds"])
            a["compile_seconds"] += float(r["compile_seconds"])
            a["compute_seconds"] += float(r["compute_seconds"])
            a["compile_count"] += int(r["compile_count"])
            a["segments"] += int(r.get("segments", 0))
            if "utilization_pct" in r:
                a["_uw"] = a.get("_uw", 0.0) + float(r["wall_seconds"])
                a["_us"] = a.get("_us", 0.0) + (
                    float(r["utilization_pct"]) * float(r["wall_seconds"]))
        total = sum(a["wall_seconds"] for a in by.values())
        stages = sorted(by.values(), key=lambda a: -a["wall_seconds"])
        for a in stages:
            a["pct_of_attributed"] = round(
                100.0 * a["wall_seconds"] / total, 2) if total else 0.0
            for k in ("wall_seconds", "compile_seconds", "compute_seconds"):
                a[k] = round(a[k], 6)
            uw, us = a.pop("_uw", 0.0), a.pop("_us", 0.0)
            if uw:  # wall-weighted mean of the annotated occurrences
                a["utilization_pct"] = round(us / uw, 2)
        if measured_wall is None:
            measured_wall = time.perf_counter() - self._t_start
        frac = total / measured_wall if measured_wall > 0 else 0.0
        out = {
            "scope": self.scope,
            "stages": stages,
            "wall_seconds": round(total, 6),
            "measured_wall_seconds": round(measured_wall, 6),
            "attributed_fraction": round(min(frac, 1.0), 4),
            "idle_fraction": round(max(0.0, 1.0 - frac), 4),
            "compile_seconds": round(
                sum(a["compile_seconds"] for a in stages), 6),
            "segments": int(self._segments),
        }
        if emit and self.enabled:
            self.recorder.metric(
                "device_profile", stage="__total__", scope=self.scope,
                wall_seconds=out["wall_seconds"],
                measured_wall_seconds=out["measured_wall_seconds"],
                attributed_fraction=out["attributed_fraction"],
                idle_fraction=out["idle_fraction"],
                compile_seconds=out["compile_seconds"],
                segments=out["segments"])
        return out


def _finish_utilization(rec: Dict[str, Any]) -> None:
    """Fold annotated pad-lane waste (the scenario and segment axes are
    already multiplicative in the lane count) into the stage's
    ``occupancy`` and ``utilization_pct``. fks_tpu also turns an attached
    ``cost_flops`` into ``est_flops_per_sec`` here; no PyTorch call gives
    a program's FLOP count, so the port leaves both out."""
    wall = float(rec.get("wall_seconds", 0.0))
    waste = rec.get("pad_waste_fraction")
    if waste is not None and wall > 0:
        occ = max(0.0, 1.0 - float(waste))
        rec["occupancy"] = round(occ, 4)
        rec["utilization_pct"] = round(
            100.0 * occ * float(rec["compute_seconds"]) / wall, 2)


#: shared disabled profiler — instrumented paths default to this, so
#: profiling never needs an ``if profiler:`` guard
NULL_PROFILER = StageProfiler(enabled=False, scope="null")


def profile_launch(fn, *args, name: str = "launch",
                   profiler: Optional[StageProfiler] = None,
                   reps: int = 1, **fields):
    """Warm-up-then-measure attribution for one launch. The first call
    runs in a ``{name}:compile`` stage (its capture split read off the
    watcher), then ``reps`` fenced calls in a ``{name}:steady`` stage.
    Returns ``(result, record)``: the best steady seconds, and with an
    enabled profiler the first-call, capture and steady-total seconds."""
    prof = profiler if profiler is not None else NULL_PROFILER
    with prof.stage(f"{name}:compile", **fields) as hc:
        out = block_until_ready(fn(*args))
    best = None
    with prof.stage(f"{name}:steady", reps=int(reps), **fields) as hs:
        for _ in range(max(1, int(reps))):
            t0 = time.perf_counter()
            out = block_until_ready(fn(*args))
            dt = time.perf_counter() - t0
            best = dt if best is None or dt < best else best
    record = {
        "name": name,
        "reps": int(reps),
        "best_seconds": best,
    }
    if hc.record is not None:  # enabled profiler: fold in the capture split
        record.update(
            first_call_seconds=hc.record["wall_seconds"],
            compile_seconds=hc.record["compile_seconds"],
            compile_count=hc.record["compile_count"],
            steady_total_seconds=hs.record["wall_seconds"])
    return out, record
