"""Spans: nested wall-clock scopes that line up with profiler traces.

Port of fks_tpu.obs.spans. ``span(label)`` generalizes
``utils.profiling.timed`` (it yields the same ``Timing``, with the same
``t.sync(...)`` contract: the clock stops after the registered tensors'
device work) and adds:

- **nesting**: a thread-local label stack gives every span a ``path``
  (``"evolve/gen/evaluate"``) and a ``depth``;
- **profiler mirroring**: each span enters
  ``torch.profiler.record_function(label)`` and, with a card present,
  ``torch.cuda.nvtx.range(label)``, so a ``torch.profiler`` trace shows
  the host spans over the device timeline under the same labels (where
  fks_tpu enters ``jax.profiler.TraceAnnotation`` and
  ``jax.named_scope``);
- **flight-recorder events**: on exit the active recorder gets one
  ``kind="span"`` event with label/path/depth/seconds plus the caller's
  fields;
- **causal linkage**: under an active ``trace_ctx`` context the event is
  a ``kind="trace_span"`` carrying trace_id / span_id / parent_id, and a
  child context is active for the span body.

With the null recorder a span costs two clock reads, the profiler
context entries and one no-op method call.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Optional

import torch

from fks_tpu_torch.obs import trace_ctx
from fks_tpu_torch.obs.recorder import get_recorder
from fks_tpu_torch.utils import profiling

_nesting = threading.local()


def span_path() -> str:
    """The current thread's open-span path ("" outside any span)."""
    return "/".join(getattr(_nesting, "stack", []))


@contextlib.contextmanager
def span(label: str, sync: Any = None, recorder=None,
         **fields) -> Iterator[profiling.Timing]:
    """A nested, recorded, profiler-mirrored timing scope (see module
    docstring). Yields the ``Timing``; register device values with
    ``t.sync(...)`` as with ``profiling.timed``. Extra keyword fields ride
    along on the recorded span event."""
    rec = recorder if recorder is not None else get_recorder()
    stack = getattr(_nesting, "stack", None)
    if stack is None:
        stack = _nesting.stack = []
    path = "/".join(stack + [label])
    depth = len(stack)
    stack.append(label)
    timing: Optional[profiling.Timing] = None
    parent = trace_ctx.current() if rec.enabled else None
    child = trace_ctx.child_of(parent) if parent is not None else None

    def _emit(t: profiling.Timing) -> None:
        if child is not None:
            rec.event("trace_span", label=label, path=path, depth=depth,
                      seconds=round(t.seconds, 6),
                      trace_id=child.trace_id, span_id=child.span_id,
                      parent_id=parent.span_id, **fields)
        else:
            rec.event("span", label=label, path=path, depth=depth,
                      seconds=round(t.seconds, 6), **fields)

    try:
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(torch.profiler.record_function(label))
            if torch.cuda.is_available():
                ctx.enter_context(torch.cuda.nvtx.range(label))
            if child is not None:
                ctx.enter_context(trace_ctx.activate(child))
            with profiling.timed(label, sync=sync, on_exit=_emit) as timing:
                yield timing
    finally:
        stack.pop()
