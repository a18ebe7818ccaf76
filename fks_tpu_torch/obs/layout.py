"""Layout observability: the eval-time layout ledger rows.

Port of ``record_layout`` from fks_tpu.obs.layout, for the canonical key
strings the serve engines file (fks_tpu/serve/artifact.py:713-719): one
``layout_ledger`` row per served batch, deduplicated against the last
identical row, with the batch's lane occupancy. ``LayoutSpec``, the
rollup and the layout explorer wait for the mesh (ROADMAP queue 1 items
3 and 6).
"""
from __future__ import annotations

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

#: the layout every single-device serve batch runs: candidates (the
#: coalesced queries) on the lane axis, no segments
DEFAULT_LAYOUT_KEY = "shard[candidates]|vmap[candidates]|seg=0"

_KEY_RE = re.compile(
    r"^shard\[(?P<shard>[a-z_,]*)\]\|vmap\[(?P<vmap>[a-z_,]*)\]"
    r"\|seg=(?P<seg>\d+)$")


def parse_layout_key(key: str) -> Tuple[Tuple[str, ...], Tuple[str, ...],
                                        int]:
    """``(shard, vmap, seg_steps)`` of a canonical layout key; raises
    ValueError on malformed or out-of-vocabulary keys."""
    m = _KEY_RE.match(key)
    if not m:
        raise ValueError(f"malformed layout key {key!r}")
    split = lambda s: tuple(a for a in s.split(",") if a)  # noqa: E731
    shard, vmap = split(m.group("shard")), split(m.group("vmap"))
    for a in shard + vmap:
        if a not in LAYOUT_AXES:
            raise ValueError(f"unknown layout axis {a!r} in {key!r}")
    return shard, vmap, int(m.group("seg"))


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


def record_layout(component: str, key: str, *, mesh=None,
                  workload_key: str = "", real_count: Optional[int] = None,
                  scenarios: int = 1, segments: int = 1, recorder=None,
                  **fields) -> Optional[dict]:
    """File one ``layout_ledger`` row in the process ledger and on the
    recorder (fks_tpu's fields: component, canonical layout key, mesh
    layout, workload key, sharded axes, segment steps, the real count,
    plus the caller's occupancy fields). ``scenarios`` and ``segments``
    scale a mesh's occupancy in fks_tpu, so without a mesh they file
    nothing, as there. Returns the row, or None when it deduped away."""
    if component not in LAYOUT_COMPONENTS:
        raise ValueError(f"unknown layout component {component!r}; "
                         f"choose from {LAYOUT_COMPONENTS}")
    from fks_tpu_torch.obs.memory import mesh_layout_label

    shard, vmap, seg = parse_layout_key(key)
    order = lambda axes: ",".join(a for a in LAYOUT_AXES if a in axes)  # noqa: E731
    canon = f"shard[{order(shard)}]|vmap[{order(vmap)}]|seg={seg}"
    rec: Dict[str, Any] = {
        "component": component,
        "layout_key": canon,
        "mesh_layout": mesh_layout_label(mesh),
        "workload_key": workload_key,
        "axes": [a for a in LAYOUT_AXES if a in shard],
        "seg_steps": seg,
    }
    if real_count is not None:
        rec["real_count"] = int(real_count)
    rec.update(fields)
    if not LEDGER.add(rec):
        return None
    r = recorder if recorder is not None else get_recorder()
    r.metric("layout_ledger", dict(rec))
    return rec
