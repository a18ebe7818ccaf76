"""Layout observability: declared layouts and the layout ledger rows.

Port of the spec and ledger part of fks_tpu.obs.layout
(fks_tpu/obs/layout.py:69-165, :237-277):

- ``LayoutSpec``: which of the batchable axes (candidates, scenarios,
  segments) shard over the mesh, which stay batched inside a shard, and
  the host-loop segment size; ``default_spec`` is the layout every entry
  point runs unless told otherwise, ``parse_layout_key`` inverts
  ``LayoutSpec.key``, ``tag_layout`` marks a callable with its key;
- ``record_layout``: one ``layout_ledger`` row per wiring or launch,
  deduplicated against the last identical row; with a mesh and a real
  count it folds the mesh's pad and occupancy accounting in
  (``parallel.mesh.occupancy_stats``).

fks_tpu's ``cost_stats_of`` prices a compiled XLA program; a captured
CUDA graph publishes no such analysis, so the rows carry no cost bytes.
The rollup and the layout explorer wait for ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from fks_tpu_torch.obs.recorder import get_recorder

#: the three batchable axes a layout maps (closed vocabulary, fks_tpu's)
LAYOUT_AXES = ("candidates", "scenarios", "segments")

#: components that may file layout rows (closed vocabulary, fks_tpu's)
LAYOUT_COMPONENTS = ("eval", "code_eval", "gen_step", "suite_eval",
                     "serve", "vm_serve", "portfolio_serve", "probe",
                     "bench")

_KEY_RE = re.compile(
    r"^shard\[(?P<shard>[a-z_,]*)\]\|vmap\[(?P<vmap>[a-z_,]*)\]"
    r"\|seg=(?P<seg>\d+)$")


@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    """Declarative layout: which axes shard over the mesh, which stay
    batched (fks_tpu's "vmap") inside each shard, and the host-loop
    segment size. Validated at construction, by fks_tpu's rules: axes
    come from ``LAYOUT_AXES``; ``candidates`` always shards; a sharded
    axis stays batched inside its shard; ``segments`` is the segmented
    runner's host loop, carried only as ``seg_steps``."""

    shard: Tuple[str, ...] = ("candidates",)
    vmap: Tuple[str, ...] = ("candidates",)
    seg_steps: int = 0

    def __post_init__(self):
        for field, axes in (("shard", self.shard), ("vmap", self.vmap)):
            if not isinstance(axes, tuple):
                object.__setattr__(self, field, tuple(axes))
                axes = getattr(self, field)
            for a in axes:
                if a not in LAYOUT_AXES:
                    raise ValueError(
                        f"unknown layout axis {a!r} in {field}; choose "
                        f"from {LAYOUT_AXES}")
            if len(set(axes)) != len(axes):
                raise ValueError(f"duplicate axes in {field}: {axes}")
            if "segments" in axes:
                raise ValueError(
                    "'segments' is the segmented runner's host loop — it "
                    f"cannot {field}; express it via seg_steps")
        if "candidates" not in self.shard:
            raise ValueError("'candidates' must shard (it is the only "
                             "always-parallel axis)")
        missing = set(self.shard) - set(self.vmap)
        if missing:
            raise ValueError(
                f"sharded axes must stay locally vmapped inside their "
                f"shard; {sorted(missing)} missing from vmap")
        if self.seg_steps < 0:
            raise ValueError(f"seg_steps {self.seg_steps} < 0")

    @property
    def key(self) -> str:
        """Canonical key (round-trips through ``parse_layout_key``); axis
        order is canonicalized to ``LAYOUT_AXES`` order."""
        shard = ",".join(a for a in LAYOUT_AXES if a in self.shard)
        vmap = ",".join(a for a in LAYOUT_AXES if a in self.vmap)
        return f"shard[{shard}]|vmap[{vmap}]|seg={self.seg_steps}"

    def describe(self) -> dict:
        return {"layout_key": self.key, "shard": list(self.shard),
                "vmap": list(self.vmap), "seg_steps": self.seg_steps}


def default_spec(*, scenarios: bool = False, seg_steps: int = 0
                 ) -> LayoutSpec:
    """The layout the entry points run by default: candidates shard over
    the mesh's population axes, everything batchable stays batched inside
    the shard, segments stay a host loop. ``scenarios=True`` is the suite
    entry point's default (candidates x scenarios lanes)."""
    vmap = ("candidates", "scenarios") if scenarios else ("candidates",)
    return LayoutSpec(shard=("candidates",), vmap=vmap,
                      seg_steps=int(seg_steps))


#: the layout every serve batch runs: candidates (the coalesced queries)
#: on the lane axis, no segments
DEFAULT_LAYOUT_KEY = default_spec().key


def parse_layout_key(key: str) -> LayoutSpec:
    """Inverse of ``LayoutSpec.key``; raises ValueError on malformed or
    out-of-vocabulary keys."""
    m = _KEY_RE.match(key)
    if not m:
        raise ValueError(f"malformed layout key {key!r}")
    split = lambda s: tuple(a for a in s.split(",") if a)  # noqa: E731
    return LayoutSpec(shard=split(m.group("shard")),
                      vmap=split(m.group("vmap")),
                      seg_steps=int(m.group("seg")))


def tag_layout(fn, layout_key: str):
    """Tag a callable with its layout key (``_fks_layout_key``, fks_tpu's
    attribute); callables that refuse attributes stay untagged."""
    try:
        fn._fks_layout_key = layout_key
    except (AttributeError, TypeError):
        pass
    return fn


class LayoutLedger:
    """Bounded, thread-safe, process-wide ledger of layout cost rows.
    ``add`` drops a row identical to the LAST row filed under the same
    (component, layout_key, mesh_layout, workload_key)."""

    def __init__(self, cap: int = 512):
        self.cap = int(cap)
        self._rows: List[Dict[str, Any]] = []
        self._last: Dict[Tuple, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def add(self, rec: Dict[str, Any]) -> bool:
        key = (rec.get("component"), rec.get("layout_key"),
               rec.get("mesh_layout"), rec.get("workload_key"))
        with self._lock:
            if self._last.get(key) == rec:
                return False
            self._last[key] = dict(rec)
            self._rows.append(dict(rec))
            if len(self._rows) > self.cap:
                del self._rows[: len(self._rows) - self.cap]
        return True

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._rows]

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._last.clear()


#: the process-wide layout ledger
LEDGER = LayoutLedger()


def record_layout(component: str, spec, *, mesh=None,
                  workload_key: str = "", real_count: Optional[int] = None,
                  scenarios: int = 1, segments: int = 1, recorder=None,
                  **fields) -> Optional[dict]:
    """File one ``layout_ledger`` row in the process ledger and on the
    recorder (fks_tpu's fields: component, canonical layout key, mesh
    layout, workload key, sharded axes, segment steps, the real count,
    plus the caller's occupancy fields). ``spec`` is a ``LayoutSpec`` or
    a canonical key. With ``real_count`` and a mesh the pad and occupancy
    stats over the mesh's candidate shards are folded in (the eval-time
    path: call it per launch, identical repeats dedupe). Returns the row,
    or None when it deduped away."""
    if component not in LAYOUT_COMPONENTS:
        raise ValueError(f"unknown layout component {component!r}; "
                         f"choose from {LAYOUT_COMPONENTS}")
    if isinstance(spec, str):
        spec = parse_layout_key(spec)
    from fks_tpu_torch.obs.memory import mesh_layout_label

    rec: Dict[str, Any] = {
        "component": component,
        "layout_key": spec.key,
        "mesh_layout": mesh_layout_label(mesh),
        "workload_key": workload_key,
        "axes": [a for a in LAYOUT_AXES if a in spec.shard],
        "seg_steps": spec.seg_steps,
    }
    if real_count is not None:
        rec["real_count"] = int(real_count)
        if mesh is not None:
            from fks_tpu_torch.parallel.mesh import (
                num_shards, occupancy_stats,
            )
            rec.update(occupancy_stats(int(real_count), num_shards(mesh),
                                       scenarios=scenarios,
                                       segments=segments))
    rec.update(fields)
    if not LEDGER.add(rec):
        return None
    r = recorder if recorder is not None else get_recorder()
    r.metric("layout_ledger", dict(rec))
    return rec
