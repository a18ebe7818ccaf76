"""Run-dir report: summary table + fitness sparkline from the JSONL alone.

Port of fks_tpu.obs.report. ``cli report <run-dir>`` renders what a
finished (or still-running, or crashed — the JSONL is append-only and
flushed per record) run did, with no in-process state: meta.json for
identity, metrics.jsonl for the evolution ledger / bench stages,
events.jsonl for spans, capture telemetry, and device/mesh snapshots.
The text is fks_tpu's, byte for byte, for any run directory either
package wrote. Records the port writes without fks_tpu's fields
(``cost_flops``, ``cost_bytes_accessed``: a captured CUDA graph publishes
no cost analysis) render as fks_tpu renders a record that lacks them;
``read_jsonl`` keeps the torn-tail rule (only the LAST line of a file
may be torn, by a killed writer).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

SPARK_BARS = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float]) -> str:
    """Unicode sparkline; constant series render mid-height."""
    if not values:
        return ""
    lo, hi = min(values), max(values)
    if hi <= lo:
        return SPARK_BARS[3] * len(values)
    scale = (len(SPARK_BARS) - 1) / (hi - lo)
    return "".join(SPARK_BARS[int(round((v - lo) * scale))] for v in values)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL file line-by-line; raises ValueError naming the line
    on a corrupt record (a flight recorder flushes whole lines, so a
    partial trailing line means a crashed writer — tolerated only there)."""
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines):  # torn final write from a killed run
                continue
            raise ValueError(f"{path}:{i}: unparseable JSONL line") from None
    return rows


def load_run(run_dir: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]],
                                    List[Dict[str, Any]]]:
    """(meta, events, metrics) for a run directory; missing JSONL files
    read as empty (a run may die before its first event), but a missing
    meta.json means this is not a run directory and raises."""
    with open(os.path.join(run_dir, "meta.json")) as f:
        meta = json.load(f)
    events = metrics = []
    ep = os.path.join(run_dir, "events.jsonl")
    mp = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(ep):
        events = read_jsonl(ep)
    if os.path.exists(mp):
        metrics = read_jsonl(mp)
    return meta, events, metrics


def _fmt_table(rows: List[Dict[str, Any]], cols: List[str]) -> List[str]:
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    head = "  ".join(c.rjust(widths[c]) for c in cols)
    out = [head, "-" * len(head)]
    for r in rows:
        out.append("  ".join(str(r.get(c, "")).rjust(widths[c])
                             for c in cols))
    return out


def _num(v: Any, nd: int = 4) -> Any:
    return round(v, nd) if isinstance(v, float) else v


def _generation_section(metrics: List[Dict[str, Any]]) -> List[str]:
    gens = [m for m in metrics if m.get("kind") == "generation"]
    if not gens:
        return []
    rows = [{
        "gen": g.get("generation"),
        "best": _num(g.get("best_score", 0.0)),
        "median": _num(g.get("median_score", 0.0)),
        "p10": _num(g.get("p10_score", 0.0)),
        "new": g.get("new_candidates", 0),
        "acc": g.get("accepted", 0),
        "dup": g.get("rejected_similar", 0),
        "sbx": g.get("sandbox_failed", 0),
        "tpl": g.get("transpile_failed", 0),
        "rsf": g.get("rescore_fallbacks", 0),
        "llm_s": _num(g.get("llm_seconds", 0.0), 2),
        "eval_s": _num(g.get("eval_seconds", 0.0), 2),
        "ev/s": _num(g.get("evals_per_sec", 0.0), 1),
        "segs": g.get("vm_segments", 0),
    } for g in gens]
    best = [float(g.get("best_score", 0.0)) for g in gens]
    lines = [f"generations: {len(gens)}  "
             "(dup=dup-suppressed sbx=sandbox-fail tpl=transpile-fail "
             "rsf=rescore-fallback segs=vm-segments)"]
    lines += _fmt_table(rows, ["gen", "best", "median", "p10", "new", "acc",
                               "dup", "sbx", "tpl", "rsf", "llm_s", "eval_s",
                               "ev/s", "segs"])
    lines.append(f"fitness best {best[0]:.4f} -> {best[-1]:.4f}  "
                 f"{sparkline(best)}")
    return lines


def _compile_section(events: List[Dict[str, Any]]) -> List[str]:
    compiles = [e for e in events if e.get("kind") == "compile"]
    if not compiles:
        return []
    by_key: Dict[str, List[float]] = {}
    for e in compiles:
        by_key.setdefault(e.get("key", "?"), []).append(
            float(e.get("seconds", 0.0)))
    lines = [f"compile events: {len(compiles)}"]
    for key in sorted(by_key):
        durs = by_key[key]
        lines.append(f"  {key.split('/')[-1]}: {len(durs)}x "
                     f"{sum(durs):.3f}s total")
    return lines


def _span_section(events: List[Dict[str, Any]]) -> List[str]:
    # trace_span rows are spans that additionally carry causal ids
    # (obs.trace_ctx) — aggregate both kinds under one table
    spans = [e for e in events if e.get("kind") in ("span", "trace_span")]
    if not spans:
        return []
    agg: Dict[str, Dict[str, float]] = {}
    traces = set()
    for s in spans:
        a = agg.setdefault(s.get("path", s.get("label", "?")),
                           {"count": 0, "seconds": 0.0})
        a["count"] += 1
        a["seconds"] += float(s.get("seconds", 0.0))
        if s.get("trace_id"):
            traces.add(s["trace_id"])
    head = "spans (by path, total wall):"
    if traces:
        head = (f"spans (by path, total wall; {len(traces)} traces — "
                "'fks_tpu spans DIR' for waterfalls):")
    lines = [head]
    for path, a in sorted(agg.items(), key=lambda kv: -kv[1]["seconds"]):
        lines.append(f"  {path}: {int(a['count'])}x {a['seconds']:.3f}s")
    return lines


def _infra_section(events: List[Dict[str, Any]]) -> List[str]:
    lines = []
    devices = [e for e in events if e.get("kind") == "device"]
    if devices:
        plats: Dict[str, int] = {}
        for d in devices:
            plats[d.get("platform", "?")] = plats.get(
                d.get("platform", "?"), 0) + 1
        desc = ", ".join(f"{n}x {p}" for p, n in sorted(plats.items()))
        mem = [d for d in devices
               if isinstance(d.get("memory_stats"), dict)]
        if mem:
            used = sum(m["memory_stats"].get("bytes_in_use", 0) for m in mem)
            desc += f"; {used / 2**20:.0f} MiB in use across {len(mem)}"
        lines.append(f"devices: {desc}")
    for e in events:
        if e.get("kind") == "mesh":
            waste = e.get("pad_waste_fraction")
            lines.append(
                f"mesh: {e.get('shards')} shards {e.get('shape')}"
                + (f", pad waste {100 * waste:.1f}%"
                   f" ({e.get('pad_lanes')}/{e.get('padded_count')} lanes)"
                   if waste is not None else ""))
    return lines


def _budget_section(metrics: List[Dict[str, Any]]) -> List[str]:
    """Eval-budget rung ladder (funsearch.budget): one row per
    rung per generation — who entered, who survived to the next rung,
    device wall per rung — plus the total pruned-candidate count."""
    rungs = [m for m in metrics if m.get("kind") == "budget_rung"]
    if not rungs:
        return []
    rows = [{
        "gen": r.get("generation"),
        "rung": r.get("rung"),
        "entered": r.get("entered"),
        "survived": r.get("survived"),
        "dev_s": _num(float(r.get("device_seconds", 0.0)), 3),
        "segs": r.get("segments", 0),
        "lanes": r.get("lanes", ""),
    } for r in rungs]
    pruned = sum(int(r.get("entered", 0)) - int(r.get("survived", 0))
                 for r in rungs)
    lines = [f"budget rungs: {len(rungs)} recorded, {pruned} candidates "
             "pruned before the full suite"]
    lines += _fmt_table(rows, ["gen", "rung", "entered", "survived",
                               "dev_s", "segs", "lanes"])
    return lines


def _device_profile_section(metrics: List[Dict[str, Any]]) -> List[str]:
    """Device-time attribution table (obs.profiler): stages
    aggregated by name and ranked by wall share, each split into compile
    vs dispatch+compute, with occupancy-discounted utilization where the
    launch shape was annotated; the ``__total__`` record (when the run
    emitted a summary) heads the section with the attributed-vs-idle
    verdict."""
    profs = [m for m in metrics if m.get("kind") == "device_profile"]
    if not profs:
        return []
    totals = [m for m in profs if m.get("stage") == "__total__"]
    stages = [m for m in profs
              if m.get("stage") != "__total__" and not m.get("depth", 0)]
    agg: Dict[str, Dict[str, float]] = {}
    for m in stages:
        a = agg.setdefault(m.get("stage", "?"), {
            "count": 0, "wall": 0.0, "compile": 0.0, "compute": 0.0,
            "compiles": 0, "util": None})
        a["count"] += 1
        a["wall"] += float(m.get("wall_seconds", 0.0))
        a["compile"] += float(m.get("compile_seconds", 0.0))
        a["compute"] += float(m.get("compute_seconds", 0.0))
        a["compiles"] += int(m.get("compile_count", 0))
        if m.get("utilization_pct") is not None:
            a["util"] = max(a["util"] or 0.0, float(m["utilization_pct"]))
    total_wall = sum(a["wall"] for a in agg.values())
    lines = ["device-time attribution (obs.profiler):"]
    for t in totals[-1:]:
        lines.append(
            f"  attributed {100 * float(t.get('attributed_fraction', 0)):.1f}%"
            f" of {_num(float(t.get('measured_wall_seconds', 0.0)), 3)}s wall"
            f" ({100 * float(t.get('idle_fraction', 0)):.1f}% idle, "
            f"compile {_num(float(t.get('compile_seconds', 0.0)), 3)}s)")
    rows = [{
        "stage": name,
        "n": int(a["count"]),
        "wall_s": _num(a["wall"], 3),
        "%wall": _num(100 * a["wall"] / total_wall, 1) if total_wall else 0,
        "compile_s": _num(a["compile"], 3),
        "compute_s": _num(a["compute"], 3),
        "compiles": int(a["compiles"]),
        "util%": "" if a["util"] is None else _num(a["util"], 1),
    } for name, a in sorted(agg.items(), key=lambda kv: -kv[1]["wall"])]
    if rows:
        lines += _fmt_table(rows, ["stage", "n", "wall_s", "%wall",
                                   "compile_s", "compute_s", "compiles",
                                   "util%"])
    return lines


def _slo_section(metrics: List[Dict[str, Any]]) -> List[str]:
    """Latest burn rate per SLO (obs.history.slo_burn): burn > 1
    means the error budget is being consumed faster than allowed."""
    burns = [m for m in metrics if m.get("kind") == "slo_burn"]
    if not burns:
        return []
    latest: Dict[str, Dict[str, Any]] = {}
    for b in burns:
        latest[str(b.get("slo", "?"))] = b
    lines = ["SLO burn rates:"]
    for name in sorted(latest):
        b = latest[name]
        rate = float(b.get("burn_rate", 0.0))
        verdict = "VIOLATING" if rate > 1.0 else "ok"
        lines.append(
            f"  {name}: burn {rate:.2f}x (observed "
            f"{_num(float(b.get('observed', 0.0)), 3)} vs target "
            f"{_num(float(b.get('target', 0.0)), 3)}) {verdict}")
    return lines


def _memory_section(metrics: List[Dict[str, Any]]) -> List[str]:
    """Memory observability (``obs.memory``): the footprint ladder —
    every captured graph's predicted device claim, latest record per
    (component, exe), ranked largest-first — plus the per-mesh-layout
    roll-up, the watermark sampler's latest host/device high-water view,
    and the leak sentinel's verdict per fenced hot loop."""
    fps = [m for m in metrics if m.get("kind") == "memory_footprint"]
    wms = [m for m in metrics if m.get("kind") == "memory_watermark"]
    leaks = [m for m in metrics if m.get("kind") == "leak_check"]
    if not (fps or wms or leaks):
        return []
    lines = ["memory (obs.memory):"]
    if fps:
        latest: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for m in fps:
            latest[(str(m.get("component", "?")),
                    str(m.get("exe_key", "?")))] = m
        def total(m: Dict[str, Any]) -> int:
            return int(m.get("total_bytes",
                             sum(int(m.get(k, 0)) for k in
                                 ("temp_bytes", "argument_bytes",
                                  "output_bytes",
                                  "generated_code_bytes"))))
        ranked = sorted(latest.items(), key=lambda kv: -total(kv[1]))
        rows = [{
            "component": c,
            "exe": e,
            "temp_KiB": _num(int(m.get("temp_bytes", 0)) / 2**10, 1),
            "args_KiB": _num(int(m.get("argument_bytes", 0)) / 2**10, 1),
            "out_KiB": _num(int(m.get("output_bytes", 0)) / 2**10, 1),
            "code_KiB": _num(
                int(m.get("generated_code_bytes", 0)) / 2**10, 1),
            "total_KiB": _num(total(m) / 2**10, 1),
        } for (c, e), m in ranked]
        lines.append(f"  footprint ladder ({len(rows)} executables, "
                     "largest first):")
        lines += ["  " + ln for ln in _fmt_table(
            rows, ["component", "exe", "temp_KiB", "args_KiB", "out_KiB",
                   "code_KiB", "total_KiB"])]
        from fks_tpu_torch.obs.memory import rollup  # deferred, like exporter
        for a in rollup([m for _, m in ranked]):
            layout = a["mesh_layout"] or "unsharded"
            lines.append(
                f"  {a['component']} [{layout}]: {a['executables']} "
                f"executables, predicted "
                f"{a['predicted_hbm_bytes'] / 2**20:.2f} MiB HBM, "
                f"peak temp {a['peak_temp_bytes'] / 2**10:.1f} KiB")
    if wms:
        rss = [int(m.get("host_rss_kb", 0)) for m in wms]
        lines.append(f"  watermarks: {len(wms)} samples, host RSS peak "
                     f"{max(rss) / 1024:.0f} MiB")
        last = wms[-1]
        dev_rows = [{
            "dev": d.get("id", "?"),
            "platform": d.get("platform", "?"),
            "in_use_MiB": ("" if "bytes_in_use" not in d else
                           _num(int(d["bytes_in_use"]) / 2**20, 2)),
            "peak_MiB": ("" if "peak_bytes_in_use" not in d else
                         _num(int(d["peak_bytes_in_use"]) / 2**20, 2)),
            "limit_MiB": ("" if "bytes_limit" not in d else
                          _num(int(d["bytes_limit"]) / 2**20, 0)),
            "delta_KiB": ("" if "delta_bytes" not in d else
                          _num(int(d["delta_bytes"]) / 2**10, 1)),
        } for d in (last.get("devices") or []) if isinstance(d, dict)]
        if dev_rows:
            lines += ["  " + ln for ln in _fmt_table(
                dev_rows, ["dev", "platform", "in_use_MiB", "peak_MiB",
                           "limit_MiB", "delta_KiB"])]
    if leaks:
        latest_leak: Dict[str, Dict[str, Any]] = {}
        for m in leaks:
            latest_leak[str(m.get("loop", "?"))] = m
        for loop in sorted(latest_leak):
            m = latest_leak[loop]
            verdict = "ok" if m.get("ok") else "LEAK"
            lines.append(
                f"  leak sentinel {loop}: {verdict} — drift "
                f"{m.get('drift_count', 0)} arrays / "
                f"{m.get('drift_bytes', 0)} bytes over "
                f"{m.get('iterations', 0)} iterations")
    return lines


def _layout_section(metrics: List[Dict[str, Any]]) -> List[str]:
    """Layout observability (obs.layout): the per-layout cost
    roll-up — one row per (workload_key, mesh_layout, layout_key) with
    pad waste, lane-step occupancy, cost-analysis bytes and the
    predicted HBM claim joined from the run's footprint records — plus
    the explorer's probe table and best-vs-default verdict when the run
    swept layouts."""
    rows = [m for m in metrics if m.get("kind") == "layout_ledger"]
    probes = [m for m in metrics if m.get("kind") == "layout_probe"]
    if not (rows or probes):
        return []
    lines = ["layouts (obs.layout):"]
    if rows:
        from fks_tpu_torch.obs.layout import rollup_layouts  # deferred
        fps = [m for m in metrics if m.get("kind") == "memory_footprint"]
        aggs = rollup_layouts(rows, footprints=fps)
        tab = [{
            "workload": a["workload_key"] or "-",
            "mesh": a["mesh_layout"] or "unsharded",
            "layout": a["layout_key"],
            "rows": a["rows"],
            "pad_waste": _num(a["pad_waste_fraction_max"], 4),
            "occupancy": _num(a["occupancy"], 4),
            "hbm_MiB": ("" if "predicted_hbm_bytes" not in a else
                        _num(a["predicted_hbm_bytes"] / 2**20, 2)),
            "steady_s": ("" if "steady_seconds" not in a else
                         _num(a["steady_seconds"], 4)),
        } for a in aggs]
        lines.append(f"  ledger roll-up ({len(aggs)} layouts):")
        lines += ["  " + ln for ln in _fmt_table(
            tab, ["workload", "mesh", "layout", "rows", "pad_waste",
                  "occupancy", "hbm_MiB", "steady_s"])]
    if probes:
        tab = [{
            "mesh": p.get("mesh_shape", "?"),
            "layout": p.get("layout_key", "?"),
            "steady_s": _num(float(p.get("steady_seconds", 0.0)), 6),
            "compile_s": _num(float(p.get("first_call_seconds", 0.0)), 2),
            "pad_waste": _num(float(p.get("pad_waste_fraction", 0.0)), 4),
            "parity": _num(float(p.get("parity_max_abs", 0.0)), 8),
        } for p in probes]
        lines.append(f"  explorer probes ({len(probes)}):")
        lines += ["  " + ln for ln in _fmt_table(
            tab, ["mesh", "layout", "steady_s", "compile_s", "pad_waste",
                  "parity"])]
        best = min(probes,
                   key=lambda p: float(p.get("steady_seconds", 0.0)))
        lines.append(f"  best measured: {best.get('mesh_shape')} "
                     f"{best.get('layout_key')} at "
                     f"{float(best.get('steady_seconds', 0.0)):.6f}s "
                     "steady (single-process CPU meshes time-slice one "
                     "host; ranks are relative)")
    return lines


def _tenant_section(metrics: List[Dict[str, Any]]) -> List[str]:
    """Per-tenant accounting (obs.workload): latest tenant_stats
    row per tenant — request/shed/expired/degraded counters, EWMA and
    tail latency, goodput, SLO burn — plus the Jain fairness index over
    per-tenant goodput, the latest workload-mix window, and the last
    loadgen summary when the run drove synthetic load."""
    stats = [m for m in metrics if m.get("kind") == "tenant_stats"]
    mixes = [m for m in metrics if m.get("kind") == "workload_mix"]
    lgs = [m for m in metrics if m.get("kind") == "loadgen_summary"]
    if not (stats or mixes or lgs):
        return []
    lines = ["tenants (obs.workload):"]
    if stats:
        latest: Dict[str, Dict[str, Any]] = {}
        for m in stats:
            latest[str(m.get("tenant", "?"))] = m
        rows = [{
            "tenant": t,
            "req": m.get("requests", 0),
            "shed": m.get("shed", 0),
            "exp": m.get("expired", 0),
            "deg": m.get("degraded", 0),
            "ewma_ms": _num(float(m.get("ewma_ms", 0.0)), 2),
            "p99_ms": _num(float(m.get("p99_ms", 0.0)), 2),
            "qps": _num(float(m.get("goodput_qps", 0.0)), 2),
            "burn": _num(float(m.get("burn_rate", 0.0)), 2),
        } for t, m in sorted(latest.items())]
        lines += _fmt_table(rows, ["tenant", "req", "shed", "exp", "deg",
                                   "ewma_ms", "p99_ms", "qps", "burn"])
        fair = float(next(iter(sorted(latest.items())))[1]
                     .get("fairness_index", 1.0))
        verdict = "ok" if fair >= 0.8 else "UNFAIR"
        lines.append(f"  fairness index (Jain, goodput): "
                     f"{fair:.4f} {verdict}")
        violators = [t for t, m in sorted(latest.items())
                     if float(m.get("burn_rate", 0.0)) > 1.0]
        if violators:
            lines.append("  SLO burn > 1x: " + ", ".join(violators))
    if mixes:
        m = mixes[-1]
        classes = m.get("classes") or {}
        top = sorted(classes.items(), key=lambda kv: -kv[1])[:5]
        lines.append(
            f"  workload mix: {m.get('distinct', 0)} classes over last "
            f"{m.get('window', 0)} requests — "
            + ", ".join(f"{c}={n}" for c, n in top))
    for lg in lgs[-1:]:
        lines.append(
            f"  loadgen [{lg.get('mode', '?')}]: "
            f"{lg.get('requests', 0)} requests, "
            f"{_num(float(lg.get('loadgen_qps', 0.0)), 2)} qps, "
            f"p99 {_num(float(lg.get('loadgen_p99_ms', 0.0)), 2)}ms, "
            f"shed {100 * float(lg.get('loadgen_shed_rate', 0.0)):.1f}%, "
            f"fairness "
            f"{_num(float(lg.get('loadgen_fairness_index', 1.0)), 4)}")
    return lines


def _portfolio_section(metrics: List[Dict[str, Any]],
                       events: List[Dict[str, Any]]) -> List[str]:
    """Portfolio serving (portfolio): routed-request counts per
    slot and per rule over the whole run, plus every slot promotion —
    which slot, what it cost, and whether the transpile overlapped the
    shadow window."""
    routes = [m for m in metrics if m.get("kind") == "portfolio_route"]
    swaps = [e for e in events if e.get("kind") == "slot_swap"]
    if not (routes or swaps):
        return []
    lines = ["portfolio (fks_tpu.portfolio):"]
    if routes:
        by_slot: Dict[str, int] = {}
        by_reason: Dict[str, int] = {}
        for m in routes:
            by_slot[str(m.get("slot", "?"))] = \
                by_slot.get(str(m.get("slot", "?")), 0) + 1
            by_reason[str(m.get("reason", "?"))] = \
                by_reason.get(str(m.get("reason", "?")), 0) + 1
        mix = ", ".join(f"slot {s}={n}" for s, n in sorted(
            by_slot.items(), key=lambda kv: kv[0]))
        rules = ", ".join(f"{r}={n}" for r, n in sorted(
            by_reason.items(), key=lambda kv: -kv[1]))
        lines.append(f"  {len(routes)} routed requests — {mix}")
        lines.append(f"  routing rules: {rules}")
    if swaps:
        lines.append(f"  slot promotions: {len(swaps)}")
        for e in swaps[-5:]:
            overlap = (" (transpile overlapped)"
                       if e.get("transpile_overlapped") else "")
            lines.append(
                f"    slot {e.get('slot', '?')} <- "
                f"{e.get('champion', '?')}: "
                f"swap {_num(float(e.get('swap_ms', 0.0)), 2)}ms, "
                f"h2d {e.get('h2d_bytes', 0)}B{overlap}")
    return lines


def _bench_section(metrics: List[Dict[str, Any]]) -> List[str]:
    stages = [m for m in metrics if m.get("kind") == "bench_stage"]
    lines = []
    for s in stages:
        parts = [f"bench stage {s.get('stage', '?')}:"]
        for k in ("evals_per_sec", "code_evals_per_sec", "compile_seconds",
                  "first_call_seconds", "steady_state_seconds",
                  "cost_flops", "cost_bytes_accessed", "budget_speedup",
                  "budget_champion_match", "device_seconds_full",
                  "device_seconds_pruned"):
            if k in s:
                parts.append(f"{k}={_num(float(s[k]), 3)}")
        lines.append(" ".join(parts))
    return lines


def _trace_diff_lines(events: List[Dict[str, Any]]) -> List[str]:
    """Header summary of recorded engine trace-diffs: total count, how
    many diverged, and the earliest divergent step per engine pair."""
    diffs = [e for e in events if e.get("kind") == "trace_diff"]
    if not diffs:
        return []
    divergent = [d for d in diffs if d.get("divergent")]
    lines = [f"trace diffs: {len(diffs)} recorded, "
             f"{len(divergent)} divergent"]
    earliest: Dict[str, int] = {}
    for d in divergent:
        pair = " vs ".join(d.get("engines", ["?", "?"]))
        step = (d.get("first_divergence") or {}).get("step")
        if step is None:
            continue
        if pair not in earliest or step < earliest[pair]:
            earliest[pair] = step
    for pair in sorted(earliest):
        lines.append(f"  {pair}: first divergent step {earliest[pair]}")
    return lines


def render_report(run_dir: str) -> str:
    """The full run summary (see module docstring)."""
    meta, events, metrics = load_run(run_dir)
    head = (f"run {meta.get('run_id', '?')}"
            f" [{meta.get('command', meta.get('metric', '?'))}]"
            f" — status {meta.get('status', '?')}")
    if "wall_seconds" in meta:
        head += f", {meta['wall_seconds']}s"
    # liveness verdict from the heartbeat: a run that claims to be
    # running but whose heartbeat is older than 2x its own cadence is
    # STALE, 10x (or heartbeat-less) is DEAD (obs.exporter)
    from fks_tpu_torch.obs.exporter import run_health  # deferred: exporter
    health = run_health(run_dir, meta=meta, metrics=metrics)  # imports us
    if health["state"] not in ("FINISHED",):
        age = ("no heartbeat" if health["age"] is None
               else f"heartbeat {health['age']:.0f}s old")
        head += (f" — {health['state']} ({age}, "
                 f"cadence ~{health['cadence']:.0f}s)")
    lines = [head, f"started {meta.get('started', '?')}  dir {run_dir}"]
    for key in ("argv", "best_score", "workload"):
        if key in meta:
            lines.append(f"{key}: {meta[key]}")
    lines.extend(_trace_diff_lines(events))
    for section in (_infra_section(events), _generation_section(metrics),
                    _budget_section(metrics), _bench_section(metrics),
                    _device_profile_section(metrics), _slo_section(metrics),
                    _tenant_section(metrics),
                    _portfolio_section(metrics, events),
                    _memory_section(metrics), _layout_section(metrics),
                    _compile_section(events),
                    _span_section(events)):
        if section:
            lines.append("")
            lines.extend(section)
    if not events and not metrics:
        lines += ["", "(no events or metrics recorded)"]
    return "\n".join(lines)
