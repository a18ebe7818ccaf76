"""Spans: nested wall-clock scopes, kept in memory and lined up with
profiler traces.

Port of fks_tpu.obs.spans. ``span(label)`` generalizes
``utils.profiling.timed`` (it yields the same ``Timing``, with the same
``t.sync(...)`` contract: the clock stops after the registered tensors'
device work) and adds:

- **nesting**: a thread-local stack of open spans gives every span a
  ``path`` (``"evolve/gen/evaluate"``) and a ``depth``;
- **the ring**: every span closes into a bounded in-memory ring
  (``ring()``, the last ``RING_SIZE``) as a ``SpanRecord``: path, depth,
  the parent's path, start and end stamps on the clock of the profiler's
  host events (``time.time_ns()``, taken inside the profiler scope),
  host seconds, the caller's fields, and the counters (``add``) taken
  while it was open;
- **the profiler scope**: while a ``torch.profiler`` records, each span
  enters ``torch.profiler.record_function(label)``, so the trace shows
  the host spans over the device timeline under the same labels (where
  fks_tpu enters ``jax.profiler.TraceAnnotation`` and
  ``jax.named_scope``); with no profiler recording it enters nothing;
- **flight-recorder events**: on exit the active recorder gets one
  ``kind="span"`` event with label/path/depth/seconds plus the caller's
  fields;
- **causal linkage**: under an active ``trace_ctx`` context the event is
  a ``kind="trace_span"`` carrying trace_id / span_id / parent_id, and a
  child context is active for the span body.

Device time is taken with CUDA events (``device_event``, ``elapsed_s``)
by callers that read them once a synchronisation they make anyway has
completed them: ``sim.engine.drain`` reads each round's replays after
the next round's flag reads, and ``parallel.mesh.ShardedPopulation``
the fused launches after the generation's read-back. Nothing here
synchronises.

With no profiler and the null recorder a span costs four clock reads,
one record and one ring append.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List

import torch
import torch.autograd.profiler as _profiler

from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.obs.recorder import NullRecorder, get_recorder
from fks_tpu_torch.utils.profiling import Timing, block_until_ready

#: closed spans the ring holds: a 45 s window of pop-256 fused generations
#: (about 1,180 of 6 spans each) fits nine times over
RING_SIZE = 1 << 16


class _Nesting(threading.local):
    """Per thread: the open spans, innermost last."""

    def __init__(self):
        self.stack: List[SpanRecord] = []


_nesting = _Nesting()


class SpanRecord:
    """One span: what the ring keeps. ``counters`` sums what ``add`` took
    while the span was open (its children's included)."""

    __slots__ = ("label", "path", "parent", "depth", "fields", "start_ns",
                 "end_ns", "seconds", "counters")

    def __init__(self, label: str, path: str, parent: str, depth: int,
                 fields: Dict[str, Any]):
        self.label = label
        self.path = path
        self.parent = parent
        self.depth = depth
        self.fields = fields
        self.start_ns = self.end_ns = 0
        self.seconds = 0.0
        self.counters: Dict[str, float] = {}


_RING: collections.deque = collections.deque(maxlen=RING_SIZE)


def ring() -> collections.deque:
    """The process's closed spans, oldest first: the last ``RING_SIZE``
    (take ``list(ring())`` before filtering; other threads append)."""
    return _RING


def span_path() -> str:
    """The current thread's open-span path ("" outside any span)."""
    stack = _nesting.stack
    return stack[-1].path if stack else ""


def is_open() -> bool:
    """Whether the current thread has a span open."""
    return bool(_nesting.stack)


def add(**counters: float) -> None:
    """Add to the counters of every span open on this thread (dropped when
    none is)."""
    for rec in _nesting.stack:
        c = rec.counters
        for k, v in counters.items():
            c[k] = c.get(k, 0) + v


class span:
    """A nested, recorded, profiler-mirrored timing scope (see module
    docstring). ``with span(label) as t`` yields the ``Timing``; register
    device values with ``t.sync(...)`` as with ``profiling.timed``. Extra
    keyword fields ride along on the recorded span event and the ring's
    record."""

    __slots__ = ("label", "recorder", "timing", "fields", "rec", "scope",
                 "activation", "parent_ctx", "child", "t0")

    def __init__(self, label: str, sync: Any = None, recorder=None,
                 **fields):
        self.label = label
        self.recorder = recorder
        self.timing = Timing(label=label, _sync=sync)
        self.fields = fields

    def __enter__(self) -> Timing:
        rec = self.recorder if self.recorder is not None else get_recorder()
        self.recorder = rec
        stack = _nesting.stack
        parent = stack[-1] if stack else None
        path = self.label if parent is None else \
            parent.path + "/" + self.label
        self.rec = SpanRecord(self.label, path,
                              "" if parent is None else parent.path,
                              len(stack), self.fields)
        stack.append(self.rec)
        self.parent_ctx = ctx = trace_ctx.current() if rec.enabled else None
        self.child = trace_ctx.child_of(ctx) if ctx is not None else None
        self.activation = None
        if self.child is not None:
            self.activation = trace_ctx.activate(self.child)
            self.activation.__enter__()
        self.scope = None
        if _profiler._is_profiler_enabled:
            self.scope = _profiler.record_function(self.label)
            self.scope.__enter__()
        self.rec.start_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self.timing

    def __exit__(self, *exc) -> bool:
        t, rec = self.timing, self.rec
        try:
            if t._sync is not None:
                block_until_ready(t._sync)
            t.seconds = rec.seconds = time.perf_counter() - self.t0
            rec.end_ns = time.time_ns()
            self._emit(t.seconds)
        finally:
            if self.scope is not None:
                self.scope.__exit__(None, None, None)
            if self.activation is not None:
                self.activation.__exit__(None, None, None)
            _nesting.stack.pop()
            _RING.append(rec)
        return False

    def _emit(self, seconds: float) -> None:
        r = self.rec
        if type(self.recorder) is NullRecorder:  # its event() does nothing
            return
        if self.child is not None:
            self.recorder.event(
                "trace_span", label=self.label, path=r.path, depth=r.depth,
                seconds=round(seconds, 6), trace_id=self.child.trace_id,
                span_id=self.child.span_id,
                parent_id=self.parent_ctx.span_id, **self.fields)
        else:
            self.recorder.event("span", label=self.label, path=r.path,
                                depth=r.depth, seconds=round(seconds, 6),
                                **self.fields)


# ------------------------------------------------------------ device time

def device_event(stream) -> "torch.cuda.Event":
    """A timing event recorded on ``stream`` (a ``torch.cuda.Stream``)."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def elapsed_s(start, end) -> float:
    """Seconds from ``start`` to ``end``, two events that have completed
    (torch raises otherwise; it never waits)."""
    return start.elapsed_time(end) / 1e3
