"""Cross-run history: index runs, render trends, flag regressions, burn SLOs.

Port of fks_tpu.obs.history, pure stdlib. ``RunHistory`` indexes any
root directory holding flight-recorder run dirs and/or bench JSONL
evidence files into a flat ``history.jsonl`` (one entry per run:
timestamp, health, the comparator metric vocabulary from
``obs.compare.extract_metrics``), and builds on that index:

- ``timelines()``: per-metric (ts, value, run) series across the root;
- ``trends()``: regression flagging with a robust z-score over a sliding
  window of prior runs — deviation in MAD units (floored at 2% of the
  window median), direction from ``obs.compare.DEFAULT_THRESHOLDS``, and
  consecutive flagged points collapse into ONE alert at the change point;
- ``best_healthy()``: the best healthy historical run for a metric —
  what ``cli compare --baseline auto`` resolves;
- ``last_healthy_headline()``: the newest healthy nonzero bench headline;
- ``record_layout_prior``/``layout_prior``: the best measured layout per
  (workload, device count) in ``layouts.json`` under the root, what
  ``obs.layout.explore_layouts`` writes.

Only ``write_index`` and ``record_layout_prior`` write, and only under
the root the caller names. Serve-tier SLOs ride along: ``SLOConfig``
declares p99/qps targets and ``slo_burn`` prices observed latencies
against them as burn rates (>1 means the SLO is being violated).

Health: a run dir is healthy when its meta status is ``ok`` and it
recorded no alert or watchdog events; a bench file is healthy when it
carries a measured (nonzero, non-stale) headline.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from fks_tpu_torch.obs.compare import DEFAULT_THRESHOLDS, extract_metrics
from fks_tpu_torch.obs.recorder import get_recorder

#: default index filename inside a history root
INDEX_NAME = "history.jsonl"

#: metrics the trend pass watches by default (ordered: headline first)
TREND_METRICS = (
    "evals_per_sec", "code_evals_per_sec", "compile_seconds",
    "best_score", "serve_p99_ms", "serve_qps", "scale1k_events_per_sec",
    "budget_speedup", "peak_device_bytes", "exe_temp_bytes",
    "loadgen_qps", "loadgen_p99_ms", "loadgen_shed_rate",
    "loadgen_fairness_index",
    "layout_best_over_default", "layout_pad_waste_frac",
)

#: filename of the measured-layout prior store inside a history root
LAYOUTS_NAME = "layouts.json"


# ------------------------------------------------------------------ index


def _file_has_key(path: str, key: str) -> bool:
    """Whether any JSON line in ``path`` carries ``key`` (cheap substring
    pre-filter, then a real parse of candidate lines)."""
    try:
        with open(path) as f:
            for line in f:
                if key not in line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and key in rec:
                    return True
    except OSError:
        pass
    return False


class RunHistory:
    """An indexed view over a root of run dirs and bench JSONL files."""

    def __init__(self, root: str):
        self.root = os.fspath(root)
        self.entries: List[Dict[str, Any]] = []

    # ----- scanning

    def scan(self) -> List[Dict[str, Any]]:
        """Walk the root: every immediate subdirectory with a ``meta.json``
        is indexed as a flight-recorder run dir; every ``*.json`` /
        ``*.jsonl`` file (the index itself excluded) as bench evidence.
        Entries are sorted by timestamp — meta ``started_ts`` for run
        dirs, file mtime for bench files."""
        if not os.path.isdir(self.root):
            raise FileNotFoundError(f"history root {self.root!r} is not a "
                                    "directory")
        entries: List[Dict[str, Any]] = []
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if os.path.isdir(path):
                if os.path.exists(os.path.join(path, "meta.json")):
                    e = self._index_run_dir(path)
                    if e:
                        entries.append(e)
            elif name != INDEX_NAME and name.endswith((".json", ".jsonl")):
                e = self._index_bench_file(path)
                if e:
                    entries.append(e)
        entries.sort(key=lambda e: e["ts"])
        self.entries = entries
        return entries

    def _index_run_dir(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            metrics = extract_metrics(path)
        except (OSError, ValueError, json.JSONDecodeError):
            return None  # a corrupt run dir must not kill the index
        ts = meta.get("started_ts")
        if ts is None:
            ts = os.path.getmtime(os.path.join(path, "meta.json"))
        healthy = (meta.get("status") == "ok"
                   and not metrics.get("alerts", 0.0)
                   and not metrics.get("watchdog_violations", 0.0))
        return {
            "run": os.path.basename(path.rstrip(os.sep)),
            "path": path,
            "source": "run_dir",
            "ts": float(ts),
            "run_id": meta.get("run_id", ""),
            "command": meta.get("command", ""),
            "status": meta.get("status", "?"),
            "healthy": bool(healthy),
            "stale": False,
            "metrics": {k: round(v, 6) for k, v in metrics.items()},
        }

    def _index_bench_file(self, path: str) -> Optional[Dict[str, Any]]:
        stale = _file_has_key(path, "stale_from_run")
        try:
            # stale carry-forwards are indexed (visible in the listing)
            # but marked: never healthy, never in timelines
            metrics = extract_metrics(path, allow_stale=stale)
        except (OSError, ValueError, TypeError):
            return None
        if not metrics:
            return None
        healthy = bool(metrics.get("evals_per_sec")
                       or metrics.get("code_evals_per_sec")) and not stale
        return {
            "run": os.path.basename(path),
            "path": path,
            "source": "bench",
            "ts": float(os.path.getmtime(path)),
            "status": "ok" if healthy else "unmeasured",
            "healthy": healthy,
            "stale": stale,
            "metrics": {k: round(v, 6) for k, v in metrics.items()},
        }

    def write_index(self, path: str = "") -> str:
        """Persist the scanned entries as one-entry-per-line JSONL (the
        durable trajectory other tools can tail); atomic replace."""
        if not self.entries:
            self.scan()
        path = path or os.path.join(self.root, INDEX_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for e in self.entries:
                f.write(json.dumps(e) + "\n")
        os.replace(tmp, path)
        return path

    # ----- measured layout priors (obs.layout.explore_layouts)

    def _layouts_path(self) -> str:
        return os.path.join(self.root, LAYOUTS_NAME)

    def _load_layouts(self) -> Dict[str, Any]:
        try:
            with open(self._layouts_path()) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}
        return doc if isinstance(doc, dict) else {}

    def record_layout_prior(self, workload_key: str, mesh_shape: str,
                            layout_key: str,
                            metrics: Optional[Dict[str, Any]] = None
                            ) -> str:
        """Persist the best MEASURED layout for (workload_key,
        mesh_shape) — what ``obs.layout.explore_layouts`` found — into
        ``layouts.json`` under the root; atomic replace, newest
        measurement wins. Returns the store path. The future layout
        autotuner reads this back (``layout_prior``) to seed its search
        instead of re-probing from scratch."""
        doc = self._load_layouts()
        doc[f"{workload_key}@{mesh_shape}"] = {
            "workload_key": workload_key,
            "mesh_shape": str(mesh_shape),
            "layout_key": layout_key,
            **(metrics or {}),
        }
        path = self._layouts_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def layout_prior(self, workload_key: str, mesh_shape: str
                     ) -> Optional[Dict[str, Any]]:
        """The stored best-layout record for (workload_key, mesh_shape),
        or None when never measured."""
        return self._load_layouts().get(f"{workload_key}@{mesh_shape}")

    # ----- timelines & trends

    def timelines(self) -> Dict[str, List[Tuple[float, float, str]]]:
        """Per-metric (ts, value, run-label) series over every entry that
        carries the metric, in timestamp order. Stale carry-forwards are
        excluded: a repeated old headline in the series would flatten the
        very level shift the trend pass exists to catch."""
        if not self.entries:
            self.scan()
        out: Dict[str, List[Tuple[float, float, str]]] = {}
        for e in self.entries:
            if e.get("stale"):
                continue
            for k, v in e["metrics"].items():
                out.setdefault(k, []).append((e["ts"], float(v), e["run"]))
        return out

    def trends(self, metrics: Optional[Iterable[str]] = None,
               window: int = 5, z: float = 3.5,
               min_history: int = 3) -> List[Dict[str, Any]]:
        """One ``trend_report`` record per watched metric: the series plus
        regression alerts from the robust z-score pass (module
        docstring). A point is flagged when its deviation from the
        median of up to ``window`` PRIOR points exceeds ``z`` MAD-units
        in the metric's bad direction; runs of consecutive flagged
        points collapse to one alert at the first (the change point)."""
        lines = self.timelines()
        watch = [m for m in (metrics or TREND_METRICS) if m in lines]
        reports: List[Dict[str, Any]] = []
        for name in watch:
            series = lines[name]
            th = DEFAULT_THRESHOLDS.get(name)
            higher_is_better = th.higher_is_better if th else True
            alerts: List[Dict[str, Any]] = []
            in_shift = False
            for i, (ts, val, run) in enumerate(series):
                prior = [v for _, v, _ in series[max(0, i - window):i]]
                if len(prior) < min_history:
                    in_shift = False
                    continue
                med = _median(prior)
                mad = _median([abs(v - med) for v in prior])
                # floor: deterministic series have MAD 0; 2% of the median
                # (plus an absolute epsilon) is the repo's noise scale
                mad = max(mad, 0.02 * abs(med), 1e-9)
                score = 0.6745 * (val - med) / mad
                bad = score < -z if higher_is_better else score > z
                if bad and not in_shift:
                    alerts.append({
                        "run": run, "ts": ts, "index": i,
                        "value": round(val, 6), "median": round(med, 6),
                        "z": round(score, 2),
                        "direction": "drop" if higher_is_better else "rise",
                    })
                in_shift = bad
            reports.append({
                "metric": name,
                "runs": len(series),
                "alerts": alerts,
                "higher_is_better": higher_is_better,
                "window": int(window),
                "z": float(z),
                "values": [round(v, 6) for _, v, _ in series],
                "labels": [r for _, _, r in series],
            })
        return reports

    # ----- baseline selection

    def best_healthy(self, metric: str = "evals_per_sec"
                     ) -> Optional[Dict[str, Any]]:
        """The healthy entry with the best value of ``metric`` (direction
        from the compare thresholds; ties break to the newest). None when
        no healthy entry carries it."""
        if not self.entries:
            self.scan()
        th = DEFAULT_THRESHOLDS.get(metric)
        higher = th.higher_is_better if th else True
        best: Optional[Dict[str, Any]] = None
        for e in self.entries:  # ts order: later entries win ties
            if not e["healthy"] or metric not in e["metrics"]:
                continue
            v = e["metrics"][metric]
            if best is None:
                best = e
                continue
            bv = best["metrics"][metric]
            if (v >= bv) if higher else (v <= bv):
                best = e
        return best

    def last_healthy_headline(self) -> Optional[Dict[str, Any]]:
        """The NEWEST healthy entry with a measured ``evals_per_sec``
        headline — the stale-fallback donor for a failed bench probe.
        Returns ``{"value", "run", "path", "ts"}``, plus the donor's
        memory budgets (``peak_device_bytes``/``exe_temp_bytes``) when it
        recorded them — a failed probe's fallback line can then keep the
        budget trend populated (explicitly stale: compare's candidate
        side ignores them), or None."""
        if not self.entries:
            self.scan()
        for e in reversed(self.entries):
            if e["healthy"] and e["metrics"].get("evals_per_sec"):
                out = {"value": e["metrics"]["evals_per_sec"],
                       "run": e["run"], "path": e["path"], "ts": e["ts"]}
                for key in ("peak_device_bytes", "exe_temp_bytes"):
                    if key in e["metrics"]:
                        out[key] = e["metrics"][key]
                return out
        return None


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def resolve_auto_baseline(root: str, metric: str = "evals_per_sec"
                          ) -> Optional[str]:
    """``cli compare --baseline auto``: the path of the best healthy
    historical run under ``root`` (best_healthy on the headline metric,
    falling back to the newest healthy entry of any shape). A missing
    root resolves to None — same answer as an empty one."""
    hist = RunHistory(root)
    try:
        hist.scan()
    except FileNotFoundError:
        return None
    best = hist.best_healthy(metric)
    if best is None:
        healthy = [e for e in hist.entries if e["healthy"]]
        best = healthy[-1] if healthy else None
    return best["path"] if best else None


# -------------------------------------------------------------------- SLOs


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Serve-tier service-level objectives. ``p99_ms``: target warm tail
    latency (the SLI is the fraction of requests slower than it;
    ``error_budget`` of them are allowed). ``qps``: target sustained
    throughput (the SLI is the relative shortfall against it). 0 leaves
    an objective unset."""

    p99_ms: float = 0.0
    qps: float = 0.0
    error_budget: float = 0.01

    @property
    def enabled(self) -> bool:
        return bool(self.p99_ms or self.qps)


def slo_burn(slo: SLOConfig, latencies_ms: List[float],
             elapsed_s: float) -> List[Dict[str, Any]]:
    """Price an observation window against the SLOs: one record per set
    objective — ``{"slo", "target", "observed", "burn_rate", ...}`` —
    where burn_rate is the multiple of the error budget the window is
    consuming (>1 = violating; the alerting threshold everywhere)."""
    records: List[Dict[str, Any]] = []
    n = len(latencies_ms)
    if slo.p99_ms and n:
        over = sum(1 for v in latencies_ms if v > slo.p99_ms) / n
        srt = sorted(latencies_ms)
        p99 = srt[min(n - 1, int(0.99 * n))]
        records.append({
            "slo": "p99_ms", "target": float(slo.p99_ms),
            "observed": round(float(p99), 3),
            "over_fraction": round(over, 4),
            "burn_rate": round(over / slo.error_budget, 3),
            "requests": n,
        })
    if slo.qps and elapsed_s > 0 and n:
        observed = n / elapsed_s
        shortfall = max(0.0, 1.0 - observed / slo.qps)
        records.append({
            "slo": "qps", "target": float(slo.qps),
            "observed": round(observed, 3),
            "over_fraction": round(shortfall, 4),
            "burn_rate": round(shortfall / slo.error_budget, 3),
            "requests": n,
        })
    return records


def record_slo_burn(slo: SLOConfig, latencies_ms: List[float],
                    elapsed_s: float, recorder=None) -> List[Dict[str, Any]]:
    """``slo_burn`` metrics onto ``recorder`` for each set objective;
    returns the records."""
    rec = recorder if recorder is not None else get_recorder()
    records = slo_burn(slo, latencies_ms, elapsed_s)
    for r in records:
        rec.metric("slo_burn", dict(r))
    return records
