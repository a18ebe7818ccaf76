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

- ``rollup_layouts``: the rows aggregated per (workload_key,
  mesh_layout, layout_key), joined with the predicted device claim of
  the footprint ledger (``obs.memory``) by mesh layout;
- ``valid_layouts`` / ``explore_layouts``: enumerate the valid
  (candidate_shards x scenario_shards) factorizations of a device list
  for a (population x suite) shape, measure each through the sharded
  suite eval (one cold call, then ``reps`` warm calls, each between
  ``torch.cuda.synchronize()`` fences; the cold call includes every
  shard's CUDA graph captures, the port's counterpart of a compile), hold
  each layout's robust scores to the default layout's (``parity_max_abs``),
  emit ``layout_probe`` metrics and persist the best measured layout per
  (workload_key, device count) into a ``RunHistory`` as a prior.

fks_tpu's ``cost_stats_of`` prices a compiled XLA program; a captured
CUDA graph publishes no such analysis, so the rows carry no cost bytes.
The explorer's population is ``parametric.init_population`` drawn from a
``torch.Generator`` seeded 0: the same weights on every run, other
weights than fks_tpu's ``jax.random`` draw (ROADMAP queue 3 item 11).
A device list may repeat one device (``[cuda:0] * 4`` is four logical
shards of one card, each with its own runner and graphs).
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def rollup_layouts(records: Optional[Sequence[dict]] = None,
                   footprints: Optional[Sequence[dict]] = None
                   ) -> List[dict]:
    """Aggregate ledger rows per (workload_key, mesh_layout, layout_key):
    row counts, the latest pad/occupancy accounting, worst pad-waste
    seen, summed lane-step occupancy, cost bytes where a row carries
    them, and the predicted device claim joined from the footprint
    ledger (``obs.memory.LEDGER``) by mesh layout — the largest captured
    graph filed under that layout's mesh shape (fks_tpu's fields)."""
    if records is None:
        records = LEDGER.records()
    if footprints is None:
        from fks_tpu_torch.obs.memory import LEDGER as MEM_LEDGER
        footprints = MEM_LEDGER.records()
    hbm: Dict[str, int] = {}
    for f in footprints:
        ml = f.get("mesh_layout", "")
        hbm[ml] = max(hbm.get(ml, 0), int(f.get("total_bytes", 0)))
    groups: Dict[Tuple[str, str, str], List[dict]] = {}
    for r in records:
        k = (r.get("workload_key", ""), r.get("mesh_layout", ""),
             r.get("layout_key", ""))
        groups.setdefault(k, []).append(r)
    out = []
    for (wk, ml, lk), rows in sorted(groups.items()):
        launched = sum(int(r.get("launched_lane_steps", 0)) for r in rows)
        real = sum(int(r.get("real_lane_steps", 0)) for r in rows)
        padded = [r for r in rows if "pad_waste_fraction" in r]
        agg: Dict[str, Any] = {
            "workload_key": wk, "mesh_layout": ml, "layout_key": lk,
            "rows": len(rows),
            "components": sorted({r.get("component", "") for r in rows}),
            "pad_waste_fraction_max": max(
                (float(r["pad_waste_fraction"]) for r in padded),
                default=0.0),
            "occupancy": (real / launched) if launched else 1.0,
        }
        if padded:
            last = padded[-1]
            agg["real_count"] = int(last.get("real_count", 0))
            agg["padded_count"] = int(last.get("padded_count", 0))
        costs = [r for r in rows if "cost_bytes_accessed" in r]
        if costs:
            agg["cost_bytes_accessed"] = max(
                float(r["cost_bytes_accessed"]) for r in costs)
        colls = [r for r in rows if "collective_bytes" in r]
        if colls:
            agg["collective_bytes"] = max(
                float(r["collective_bytes"]) for r in colls)
        if ml in hbm:
            agg["predicted_hbm_bytes"] = hbm[ml]
        steadies = [float(r["steady_seconds"]) for r in rows
                    if "steady_seconds" in r]
        if steadies:
            agg["steady_seconds"] = min(steadies)
        compiles = [float(r["compile_seconds"]) for r in rows
                    if "compile_seconds" in r]
        if compiles:
            agg["compile_seconds"] = max(compiles)
        out.append(agg)
    return out


# -------------------------------------------------------------- explorer


def valid_layouts(num_devices: int, scenarios: int) -> List[dict]:
    """Enumerate the valid (candidate_shards x scenario_shards)
    factorizations of ``num_devices`` for a suite of ``scenarios``:
    every factor pair c*s == num_devices with s dividing the scenario
    count (the scenario axis shards without padding, which would skew
    the robust aggregate). s=1 is the default layout and always valid;
    ordering is s ascending, so the default comes first."""
    num_devices = int(num_devices)
    scenarios = int(scenarios)
    if num_devices < 1:
        raise ValueError(f"num_devices {num_devices} < 1")
    out = []
    for s in range(1, num_devices + 1):
        if num_devices % s:
            continue
        if s > 1 and (scenarios < s or scenarios % s):
            continue
        spec = (default_spec(scenarios=True) if s == 1 else
                LayoutSpec(shard=("candidates", "scenarios"),
                           vmap=("candidates", "scenarios")))
        out.append({"candidate_shards": num_devices // s,
                    "scenario_shards": s,
                    "mesh_shape": f"{num_devices // s}x{s}",
                    "spec": spec})
    return out


def _sync(devices) -> None:
    """Wait for every card among ``devices`` (nothing on the CPU)."""
    import torch

    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def explore_layouts(suite, *, devices=None, population: int = 64,
                    cfg=None, rc=None, elite_k: int = 8,
                    engine: str = "exact", recorder=None, history=None,
                    workload_key: str = "", reps: int = 2,
                    dominance_margin: float = 0.05) -> dict:
    """Measure every valid layout of (population x suite) over
    ``devices`` (default: every CUDA device; a device may repeat): one
    wiring + one cold call (the graph captures) + ``reps`` warm calls per
    layout, each call between ``torch.cuda.synchronize()`` fences, a
    ``layout_probe`` metric each, parity of the robust scores against the
    default layout, and a summary with the two compare-gated keys
    (``layout_best_over_default``, ``layout_pad_waste_frac``); fks_tpu's
    keys and verdicts. With ``history`` (a ``RunHistory``) the best
    measured layout persists per (workload_key, device count). Logical
    shards of one device queue on it, so their steady seconds rank
    layouts relatively."""
    import torch

    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.parallel.mesh import (
        cuda_devices, layout_mesh, num_shards,
    )
    from fks_tpu_torch.parallel.population import pad_population, pad_stats
    from fks_tpu_torch.scenarios.robust import (
        RobustConfig, make_sharded_suite_eval,
    )
    from fks_tpu_torch.sim.engine import SimConfig

    cfg = cfg if cfg is not None else SimConfig()
    rc = rc if rc is not None else RobustConfig()
    devices = ([torch.device(d) for d in devices] if devices is not None
               else cuda_devices())
    ndev = len(devices)
    scn = len(suite)
    rec = recorder if recorder is not None else get_recorder()
    candidates = valid_layouts(ndev, scn)
    gen = torch.Generator(device=devices[0])
    gen.manual_seed(0)
    params = parametric.init_population(gen, int(population))
    probes: List[dict] = []
    default_probe: Optional[dict] = None
    default_robust = None
    for lay in candidates:
        spec = lay["spec"]
        mesh = layout_mesh(devices, lay["scenario_shards"])
        ev = make_sharded_suite_eval(suite, mesh, cfg=cfg, rc=rc,
                                     elite_k=elite_k, engine=engine,
                                     layout=spec)
        padded, real = pad_population(params, num_shards(mesh))
        _sync(devices)
        t0 = time.perf_counter()
        out = ev(padded, real)
        _sync(devices)
        first = time.perf_counter() - t0
        steady = float("inf")
        for _ in range(max(1, int(reps))):
            t0 = time.perf_counter()
            out = ev(padded, real)
            _sync(devices)
            steady = min(steady, time.perf_counter() - t0)
        robust = out[0][:real].cpu()
        ps = pad_stats(real, num_shards(mesh))
        if default_probe is None:  # s=1 enumerates first
            parity = 0.0
            default_robust = robust
        else:
            parity = float((robust - default_robust).abs().max())
        probe = {
            "layout_key": spec.key,
            "mesh_shape": lay["mesh_shape"],
            "workload_key": workload_key,
            "axes": [a for a in LAYOUT_AXES if a in spec.shard],
            "candidates": int(real),
            "scenarios": scn,
            "candidate_shards": lay["candidate_shards"],
            "scenario_shards": lay["scenario_shards"],
            "first_call_seconds": round(first, 4),
            "steady_seconds": round(steady, 6),
            "pad_waste_fraction": ps["pad_waste_fraction"],
            "parity_max_abs": parity,
        }
        rec.metric("layout_probe", dict(probe))
        record_layout("probe", spec, mesh=mesh, workload_key=workload_key,
                      real_count=real, scenarios=scn, recorder=rec,
                      steady_seconds=probe["steady_seconds"],
                      compile_seconds=round(max(0.0, first - steady), 4))
        probes.append(probe)
        if default_probe is None:
            default_probe = probe
    best = min(probes, key=lambda p: p["steady_seconds"])
    ratio = (default_probe["steady_seconds"] / best["steady_seconds"]
             if best["steady_seconds"] else 1.0)
    summary = {
        "workload_key": workload_key,
        "devices": ndev,
        "candidates": int(default_probe["candidates"]),
        "scenarios": scn,
        "layouts_probed": len(probes),
        "default_layout_key": default_probe["layout_key"],
        "best_layout_key": best["layout_key"],
        "best_mesh_shape": best["mesh_shape"],
        "default_steady_seconds": default_probe["steady_seconds"],
        "best_steady_seconds": best["steady_seconds"],
        "layout_best_over_default": round(ratio, 4),
        "layout_pad_waste_frac": best["pad_waste_fraction"],
        "parity_max_abs": max(p["parity_max_abs"] for p in probes),
        "default_dominated": (best["layout_key"]
                              != default_probe["layout_key"]
                              and ratio > 1.0 + dominance_margin),
        "probes": probes,
    }
    if history is not None:
        history.record_layout_prior(
            workload_key, str(ndev), best["layout_key"],
            {"mesh_shape": best["mesh_shape"],
             "steady_seconds": best["steady_seconds"],
             "layout_best_over_default": summary["layout_best_over_default"],
             "layout_pad_waste_frac": summary["layout_pad_waste_frac"]})
    return summary
