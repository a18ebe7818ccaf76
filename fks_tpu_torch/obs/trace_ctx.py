"""Causal trace contexts: Dapper-style trace/span ids across threads.

Port of fks_tpu.obs.trace_ctx (pure stdlib), unchanged.

``obs.span`` records *thread-local nested* timings — the moment work
crosses a Future, the batcher's worker thread, or the promotion ledger,
causality is lost. This module adds the missing identity layer:

- ``TraceContext`` — an immutable (trace_id, span_id) pair. The span_id
  is the id of the context's OWN span (the parent of anything started
  under it). ``new_trace`` preallocates the root span id, so the root's
  id is stable from submit time even though the root ``trace_span``
  event is only written when the request finishes (children can be
  emitted before their parent's event exists; reconstruction sorts it
  out).
- explicit propagation: ``activate(ctx)`` binds the context to the
  current thread; producers (the serve batcher, the promotion
  controller, the evolve loop) attach the context OBJECT to queued
  items/Futures and re-activate it on the consuming thread — there is
  no ambient cross-thread magic to get wrong.
- ``emit`` — one ``trace_span`` event (trace_id/span_id/parent_id/path/
  seconds) into a recorder. ``obs.span`` calls it automatically when a
  context is active; code with better timing information (the batcher's
  queue-wait split) calls it directly.

The null path stays allocation-light: with no recorder, no context is
ever created, and ``current()`` is a single thread-local read.

Reconstruction (the ``cli spans`` viewer and the run_full_suite trace
gate) lives here too: group ``trace_span`` events by trace id, build
the parent/child tree, render per-request latency waterfalls, and
compute the critical path of an evolve generation (device-idle vs
LLM-idle seconds — the numbers the async-island ROADMAP item needs).
"""
from __future__ import annotations

import threading
import uuid
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = [
    "TraceContext", "new_trace", "new_span_id", "current", "activate",
    "child_of", "emit", "trace_spans", "traces_by_id", "build_tree",
    "render_waterfall", "critical_path", "waterfall_complete",
    "SERVE_ROOT", "SERVE_COMPONENTS", "activate_trace", "current_trace",
    "emit_span",
]

#: canonical serve-request span paths (the waterfall vocabulary)
SERVE_ROOT = "serve/request"
SERVE_COMPONENTS = ("queue_wait", "batch_wait", "pack_h2d", "dispatch",
                    "scatter_back")


class TraceContext:
    """One (trace_id, span_id) hop of a causal chain. Immutable by
    convention; cheap enough to attach to every queued request."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def new_trace(prefix: str = "req") -> TraceContext:
    """Fresh trace with the ROOT span id preallocated — children created
    before the root event is written still get a resolvable parent_id."""
    return TraceContext(f"{prefix}-{uuid.uuid4().hex[:16]}", new_span_id())


def child_of(ctx: TraceContext) -> TraceContext:
    return TraceContext(ctx.trace_id, new_span_id())


_local = threading.local()


def current() -> Optional[TraceContext]:
    """The thread's active context, or None. One attribute read — safe
    on the recorder-off hot path."""
    return getattr(_local, "ctx", None)


@contextmanager
def activate(ctx: Optional[TraceContext]):
    """Bind ``ctx`` as the thread's active context for the block
    (no-op when ctx is None, so call sites need no branch)."""
    if ctx is None:
        yield None
        return
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def emit(recorder, path: str, seconds: float, *,
         ctx: Optional[TraceContext] = None,
         span_id: Optional[str] = None,
         parent_id: Optional[str] = None,
         root: bool = False, **fields) -> Optional[str]:
    """Write one ``trace_span`` event. ``ctx`` defaults to the thread's
    active context; with neither, this is a no-op (returns None).

    ``root=True`` reuses the context's preallocated span id as this
    span's OWN id with a null parent — the request/generation root.
    Otherwise a fresh span id is minted with ``parent_id`` defaulting to
    the context's span id."""
    ctx = ctx if ctx is not None else current()
    if ctx is None or not getattr(recorder, "enabled", False):
        return None
    if root:
        sid, pid = ctx.span_id, None
    else:
        sid = span_id or new_span_id()
        pid = parent_id if parent_id is not None else ctx.span_id
    recorder.event("trace_span", trace_id=ctx.trace_id, span_id=sid,
                   parent_id=pid, path=path,
                   seconds=round(float(seconds), 6), **fields)
    return sid


# --------------------------------------------------------- reconstruction

def trace_spans(events) -> List[dict]:
    """The ``trace_span`` rows of an event stream (list of dicts, e.g.
    from ``obs.report.load_run``)."""
    return [e for e in events if e.get("kind") == "trace_span"]


def traces_by_id(spans) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for s in spans:
        out.setdefault(s.get("trace_id", "?"), []).append(s)
    return out


def build_tree(spans) -> List[dict]:
    """Parent/child tree of one trace's spans: returns the roots, each a
    ``{"span": row, "children": [...]}`` node. Spans whose parent_id
    does not resolve (torn trail) surface as extra roots rather than
    vanishing."""
    by_id = {s["span_id"]: {"span": s, "children": []} for s in spans}
    roots = []
    for s in spans:
        node = by_id[s["span_id"]]
        pid = s.get("parent_id")
        if pid and pid in by_id and pid != s["span_id"]:
            by_id[pid]["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=_start)
    roots.sort(key=_start)
    return roots


def _start(node) -> float:
    s = node["span"]
    return float(s.get("ts", 0.0)) - float(s.get("seconds", 0.0))


def render_waterfall(spans, width: int = 36) -> str:
    """Text waterfall of one trace: indent shows causality, the bar
    shows when inside the trace's wall the span ran (event ``ts`` is the
    span END; start = ts - seconds)."""
    if not spans:
        return "(no spans)"
    roots = build_tree(spans)
    t0 = min(_start(n) for n in _walk(roots))
    t1 = max(float(n["span"].get("ts", 0.0)) for n in _walk(roots))
    wall = max(t1 - t0, 1e-9)
    lines = [f"trace {spans[0].get('trace_id', '?')}  "
             f"wall {wall * 1e3:.2f} ms  ({len(spans)} spans)"]
    name_w = max(len(_label(n, d)) for n, d in _walk_depth(roots))
    for node, depth in _walk_depth(roots):
        s = node["span"]
        sec = float(s.get("seconds", 0.0))
        lo = int(round((_start(node) - t0) / wall * width))
        hi = int(round((_start(node) - t0 + sec) / wall * width))
        lo = min(max(lo, 0), width - 1)
        hi = min(max(hi, lo + 1), width)
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        lines.append(f"  {_label(node, depth):<{name_w}}  "
                     f"{sec * 1e3:9.3f} ms  |{bar}|")
    return "\n".join(lines)


def _label(node, depth) -> str:
    return "  " * depth + str(node["span"].get("path", "?"))


def _walk(roots):
    for node in roots:
        yield node
        yield from _walk(node["children"])


def _walk_depth(roots, depth: int = 0):
    for node in roots:
        yield node, depth
        yield from _walk_depth(node["children"], depth + 1)


def critical_path(spans) -> dict:
    """Critical-path summary of one trace (an evolve generation or a
    serve request): root wall, per-child attribution, the bounding
    stage, and the attributed fraction. For generation traces the
    device/LLM idle split is read off the stage vocabulary: the device
    idles while the LLM drafts (``llm``), the LLM idles during
    everything else."""
    roots = [n for n in build_tree(spans) if not n["span"].get("parent_id")]
    if not roots:
        return {"ok": False, "reason": "no root span"}
    root = max(roots, key=lambda n: float(n["span"].get("seconds", 0.0)))
    wall = float(root["span"].get("seconds", 0.0))
    stages = {}
    for child in root["children"]:
        p = str(child["span"].get("path", "?")).rpartition("/")[2]
        stages[p] = stages.get(p, 0.0) + float(
            child["span"].get("seconds", 0.0))
    attributed = sum(stages.values())
    bounding = max(stages, key=stages.get) if stages else ""
    llm_s = stages.get("llm", 0.0)
    return {
        "ok": True,
        "trace_id": root["span"].get("trace_id"),
        "path": root["span"].get("path"),
        "wall_seconds": round(wall, 6),
        "stages": {k: round(v, 6) for k, v in sorted(stages.items())},
        "attributed_seconds": round(attributed, 6),
        "attributed_fraction": round(attributed / wall, 4) if wall else 0.0,
        "bounding_stage": bounding,
        "device_idle_seconds": round(llm_s, 6),
        "llm_idle_seconds": round(max(attributed - llm_s, 0.0), 6),
    }


def waterfall_complete(spans, require=SERVE_COMPONENTS) -> bool:
    """True when one trace's spans form a complete serve waterfall:
    exactly one resolvable root, every parent link resolves, and every
    required component path appears under it."""
    if not spans:
        return False
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if not s.get("parent_id")]
    if len(roots) != 1:
        return False
    for s in spans:
        pid = s.get("parent_id")
        if pid and pid not in ids:
            return False
    leaves = {str(s.get("path", "")).rpartition("/")[2] for s in spans}
    return all(c in leaves for c in require)


# unambiguous names for the ``fks_tpu_torch.obs`` namespace re-export
activate_trace = activate
current_trace = current
emit_span = emit
