"""Run-directory reading, and the memory section ``cli mem`` renders.

Port of ``read_jsonl``, ``load_run``, ``_fmt_table`` and
``_memory_section`` from fks_tpu.obs.report. ``read_jsonl`` keeps its
torn-tail rule: a flight recorder flushes whole lines, so only the LAST
line of a file may be torn (a killed writer); a bad line anywhere else
is corruption. The rest of the rendered report (``cli report``) is
fks_tpu's alone so far.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL file line by line; raises ValueError naming the line
    on a corrupt record other than a torn final line, which is skipped."""
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


def _memory_section(metrics: List[Dict[str, Any]]) -> List[str]:
    """Memory observability (``obs.memory``): the footprint ladder —
    every captured graph's predicted device claim, latest record per
    (component, exe), ranked largest-first — plus the per-mesh-layout
    roll-up, the watermark sampler's latest host/device high-water view,
    and the leak sentinel's verdict per fenced hot loop. fks_tpu's text,
    line for line."""
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
        from fks_tpu_torch.obs.memory import rollup
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
