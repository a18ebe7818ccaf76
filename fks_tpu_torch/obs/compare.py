"""Cross-run regression gating: diff two runs, exit nonzero on regression.

Port of fks_tpu.obs.compare, pure stdlib. ``cli compare BASELINE
CANDIDATE`` accepts either flight-recorder run DIRECTORIES or bench
JSONL FILES (the one-line headline contract or a session log), pulls a
common metric vocabulary out of each, and judges the candidate against
the baseline with per-metric thresholds:

- throughput (``evals_per_sec``/``code_evals_per_sec``): a RELATIVE drop
  beyond the tolerance (default 10%) is a regression;
- ``compile_seconds``: relative growth beyond 25% (in the port's own
  records these are CUDA graph capture seconds, the port's counterpart
  of an XLA compile);
- fitness (``best_score``/``median_score``) and ``parity_max_drift``:
  ABSOLUTE drift beyond 1e-5 — the engines are deterministic, so any
  real movement is a code change, not noise;
- ``watchdog_violations``/``alerts``: ANY increase is a regression.

A metric present in only one run is reported but never fails the gate.
The vocabulary, thresholds, verdicts and table are fks_tpu's, so either
package's runs compare against the other's.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Threshold:
    """How one metric is judged. ``higher_is_better`` sets the regression
    direction; ``rel`` is a relative tolerance on the bad-direction move,
    ``abs_tol`` an absolute one (either alone, or both — the move must
    exceed BOTH to regress, so abs_tol doubles as a noise floor)."""

    higher_is_better: bool = True
    rel: Optional[float] = None
    abs_tol: Optional[float] = None


#: the default gate (see module docstring for rationale)
DEFAULT_THRESHOLDS: Dict[str, Threshold] = {
    "evals_per_sec": Threshold(higher_is_better=True, rel=0.10),
    "code_evals_per_sec": Threshold(higher_is_better=True, rel=0.10),
    "compile_seconds": Threshold(higher_is_better=False, rel=0.25,
                                 abs_tol=0.5),
    "best_score": Threshold(higher_is_better=True, abs_tol=1e-5),
    "median_score": Threshold(higher_is_better=True, abs_tol=1e-5),
    "parity_max_drift": Threshold(higher_is_better=False, abs_tol=1e-5),
    "watchdog_violations": Threshold(higher_is_better=False, abs_tol=0.0),
    "alerts": Threshold(higher_is_better=False, abs_tol=0.0),
    # eval-budget allocation (bench stage_budget): pruned-vs-full device
    # seconds per generation must not regress by more than 10%, and the
    # pruned run's champion must keep matching the full run's (0/1 flag)
    "budget_speedup": Threshold(higher_is_better=True, rel=0.10),
    "budget_champion_match": Threshold(higher_is_better=True, abs_tol=0.0),
    # large-cluster scale tier (bench stage_scale1k): 1k-node x 100k-pod
    # completion throughput on the flat engine must not drop >10%
    "scale1k_events_per_sec": Threshold(higher_is_better=True, rel=0.10),
    # champion serving (bench stage_serve): warm tail latency must not
    # inflate more than 25% (with a 2 ms noise floor — CPU timer jitter
    # at millisecond scale), and batched throughput must not drop >10%
    "serve_p99_ms": Threshold(higher_is_better=False, rel=0.25, abs_tol=2.0),
    "serve_qps": Threshold(higher_is_better=True, rel=0.10),
    # mesh-sharded serving (bench stage_serve --devices): global
    # throughput across the device mesh must not drop >10%, and the
    # per-query upload volume (post-packing, snapshot-cache-discounted)
    # must not regress — growth means packing broke or the cache stopped
    # hitting (64-byte floor absorbs padding jitter at tiny shapes)
    "serve_sharded_qps": Threshold(higher_is_better=True, rel=0.10),
    "serve_h2d_bytes_per_query": Threshold(higher_is_better=False,
                                           rel=0.0, abs_tol=64.0),
    # causal tracing (bench stage_serve): per-request trace emission must
    # stay within noise of the untraced service path — more than a
    # 2-point absolute jump in overhead means the null/hot path grew a
    # real cost (the value is already a percentage, so abs only)
    "trace_overhead_pct": Threshold(higher_is_better=False, abs_tol=2.0),
    # VM-native promotion (bench stage_promote): the zero-rebuild swap
    # must stay a swap — transpile + pack + H2D only. Latency gets the
    # serve_p99_ms treatment (25% rel with a 2 ms CPU-jitter floor);
    # the swap's device traffic must not regress at all beyond a
    # 64-byte padding-jitter floor — growth means program packing broke
    "promotion_swap_ms": Threshold(higher_is_better=False, rel=0.25,
                                   abs_tol=2.0),
    "vm_swap_h2d_bytes": Threshold(higher_is_better=False,
                                   rel=0.0, abs_tol=64.0),
    # memory budgets (obs.memory / bench stages): the run's peak
    # predicted device bytes and the largest executable's XLA scratch
    # claim must not grow — one 4 KiB page of absolute floor absorbs
    # buffer-assignment jitter at tiny CPU shapes, any real growth gates
    "peak_device_bytes": Threshold(higher_is_better=False, rel=0.0,
                                   abs_tol=4096.0),
    "exe_temp_bytes": Threshold(higher_is_better=False, rel=0.0,
                                abs_tol=4096.0),
    # static pre-flight (bench stage_preflight): the fraction of the
    # candidate stream rejected before sandbox/transpile must not drop
    # more than 5 points — a drop means the analyzer stopped catching a
    # junk class it used to catch (absolute: the rate is already a ratio)
    "preflight_reject_rate": Threshold(higher_is_better=True, abs_tol=0.05),
    # sustained multi-tenant load (bench stage_loadgen): throughput and
    # the Jain fairness index over per-tenant goodput must not drop,
    # tail latency and shed rate must not grow. qps/p99 get the serve
    # treatment; shed rate and fairness are already ratios, so absolute
    # tolerances (2 points of shed, 5 points of fairness) absorb
    # scheduling jitter in short deterministic runs
    "loadgen_qps": Threshold(higher_is_better=True, rel=0.10),
    "loadgen_p99_ms": Threshold(higher_is_better=False, rel=0.25,
                                abs_tol=2.0),
    "loadgen_shed_rate": Threshold(higher_is_better=False, abs_tol=0.02),
    "loadgen_fairness_index": Threshold(higher_is_better=True,
                                        abs_tol=0.05),
    # portfolio serving (bench stage_portfolio): routed multi-champion
    # throughput through the shared slot-vmapped executable must not
    # drop >10%, and the mid-traffic slot promotion must stay a table
    # upload — same latency treatment as the single-slot swap (25% rel
    # with a 2 ms CPU-jitter floor)
    "portfolio_qps": Threshold(higher_is_better=True, rel=0.10),
    "portfolio_slot_swap_ms": Threshold(higher_is_better=False, rel=0.25,
                                        abs_tol=2.0),
    # layout explorer (bench stage_layout): best-measured-over-default
    # steady ratio must not drop more than 10 points (a drop means the
    # default layout got relatively worse, or the explorer stopped
    # finding the better layout it used to find), and the best layout's
    # padded-lane waste must not grow more than 5 points — both are
    # already ratios, so absolute tolerances absorb single-host
    # time-slicing jitter on the dryrun mesh
    "layout_best_over_default": Threshold(higher_is_better=True,
                                          abs_tol=0.10),
    "layout_pad_waste_frac": Threshold(higher_is_better=False,
                                       abs_tol=0.05),
}


def _num(v: Any) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _from_run_dir(run_dir: str) -> Dict[str, float]:
    from fks_tpu_torch.obs.report import load_run

    _meta, events, metrics = load_run(run_dir)
    out: Dict[str, float] = {}
    gens = [m for m in metrics if m.get("kind") == "generation"]
    if gens:
        bests = [v for v in (_num(g.get("best_score")) for g in gens)
                 if v is not None]
        if bests:
            out["best_score"] = max(bests)
        med = _num(gens[-1].get("median_score"))
        if med is not None:
            out["median_score"] = med
        eps = [v for v in (_num(g.get("evals_per_sec")) for g in gens)
               if v is not None]
        if eps:
            out["evals_per_sec"] = max(eps)
    for m in metrics:
        if m.get("kind") != "bench_stage":
            continue
        for key in ("evals_per_sec", "code_evals_per_sec",
                    "budget_speedup", "budget_champion_match",
                    "scale1k_events_per_sec", "serve_qps",
                    "serve_sharded_qps", "preflight_reject_rate",
                    "loadgen_qps", "loadgen_fairness_index",
                    "portfolio_qps", "layout_best_over_default"):
            v = _num(m.get(key))
            if v is not None:
                out[key] = max(out.get(key, 0.0), v)
        # latency/upload volume/trace cost: best (lowest) observation,
        # mirroring serve_qps's max
        for key in ("serve_p99_ms", "serve_h2d_bytes_per_query",
                    "trace_overhead_pct", "promotion_swap_ms",
                    "vm_swap_h2d_bytes", "loadgen_p99_ms",
                    "loadgen_shed_rate", "portfolio_slot_swap_ms",
                    "layout_pad_waste_frac"):
            v = _num(m.get(key))
            if v is not None:
                out[key] = min(out.get(key, v), v)
        # memory budgets: WORST (highest) observation — a peak metric's
        # whole point is the high-water mark, so the gate judges the
        # largest claim any stage recorded
        for key in ("peak_device_bytes", "exe_temp_bytes"):
            v = _num(m.get(key))
            if v is not None:
                out[key] = max(out.get(key, 0.0), v)
        v = _num(m.get("compile_seconds"))
        if v is not None:
            out["compile_seconds"] = out.get("compile_seconds", 0.0) + v
    drifts = [v for v in (_num(m.get("max_drift")) for m in metrics
                          if m.get("kind") == "parity") if v is not None]
    if drifts:
        out["parity_max_drift"] = max(drifts)
    if "compile_seconds" not in out:
        compile_s = sum(float(e.get("seconds", 0.0)) for e in events
                        if e.get("kind") == "compile")
        if compile_s:
            out["compile_seconds"] = compile_s
    out["watchdog_violations"] = float(sum(
        1 for e in events if e.get("kind") == "watchdog"))
    out["alerts"] = float(sum(1 for e in events if e.get("kind") == "alert"))
    return out


def _from_jsonl(path: str, allow_stale: bool = False) -> Dict[str, float]:
    """Best metrics out of a bench JSONL: the headline contract line maps
    ``value`` (unit evals/s) onto ``evals_per_sec``; session-log rows
    (``{"ok", "stage", "result": {...}}``) contribute their result dict;
    a 0.0-with-``banked_from`` fallback line contributes NOTHING to the
    headline throughput (nothing was measured that run). A STALE headline
    (``stale_from_run`` marker: a failed probe carrying the last healthy
    historical value, obs.history) counts only when
    ``allow_stale`` — as a BASELINE denominator it is real evidence, as a
    candidate it would mask the very failure it records."""
    out: Dict[str, float] = {}

    def take(rec: Dict[str, Any], stale: bool = False) -> None:
        for key in ("evals_per_sec", "code_evals_per_sec",
                    "compile_seconds", "best_score", "median_score",
                    "parity_max_drift", "budget_speedup",
                    "budget_champion_match", "scale1k_events_per_sec",
                    "serve_p99_ms", "serve_qps", "serve_sharded_qps",
                    "serve_h2d_bytes_per_query", "preflight_reject_rate",
                    "trace_overhead_pct", "promotion_swap_ms",
                    "vm_swap_h2d_bytes", "peak_device_bytes",
                    "exe_temp_bytes", "loadgen_qps", "loadgen_p99_ms",
                    "loadgen_shed_rate", "loadgen_fairness_index",
                    "portfolio_qps", "portfolio_slot_swap_ms",
                    "layout_best_over_default", "layout_pad_waste_frac"):
            v = _num(rec.get(key))
            if v is None:
                continue
            # memory budgets on a STALE fallback line are carried-forward
            # donor evidence, not a live measurement — the same baseline-
            # only asymmetry as the stale headline (take() runs on every
            # record, so the guard must live here, not at the call site)
            if (stale and not allow_stale
                    and key in ("peak_device_bytes", "exe_temp_bytes")):
                continue
            if key in ("compile_seconds", "serve_p99_ms",
                       "serve_h2d_bytes_per_query", "trace_overhead_pct",
                       "promotion_swap_ms", "vm_swap_h2d_bytes",
                       "loadgen_p99_ms", "loadgen_shed_rate",
                       "portfolio_slot_swap_ms"):
                out[key] = min(out.get(key, v), v)
            elif key in ("peak_device_bytes", "exe_temp_bytes"):
                # peak metrics: the high-water mark across records
                out[key] = max(out.get(key, 0.0), v)
            else:
                out[key] = max(out.get(key, v), v)

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # prose/torn lines ride along in bench logs
            if not isinstance(rec, dict):
                continue
            if rec.get("unit") == "evals/s" and "value" in rec:
                v = _num(rec["value"])
                # the fallback contract: value 0.0 means "not measured";
                # stale (carried-forward) values count for baselines only
                if v and (allow_stale or "stale_from_run" not in rec):
                    out["evals_per_sec"] = max(
                        out.get("evals_per_sec", 0.0), v)
            stale = "stale_from_run" in rec
            take(rec, stale=stale)
            if isinstance(rec.get("result"), dict):
                take(rec["result"], stale=stale)
    return out


def extract_metrics(path: str, allow_stale: bool = False) -> Dict[str, float]:
    """The comparator's metric vocabulary for a run dir or a JSONL file.
    ``allow_stale`` admits carried-forward bench headlines (baseline
    side only — see ``_from_jsonl``)."""
    if os.path.isdir(path):
        return _from_run_dir(path)
    return _from_jsonl(path, allow_stale=allow_stale)


def _judge(name: str, a: float, b: float, th: Threshold) -> str:
    """OK / REGRESSION / IMPROVED for candidate ``b`` vs baseline ``a``."""
    delta = b - a if th.higher_is_better else a - b  # >0 = better
    if delta >= 0:
        return "IMPROVED" if delta > 0 else "OK"
    worse = -delta
    over_abs = th.abs_tol is None or worse > th.abs_tol
    over_rel = th.rel is None or (abs(a) > 0 and worse / abs(a) > th.rel)
    if th.abs_tol is None and th.rel is None:
        return "OK"  # informational metric, never gates
    # when both bounds are set the move must exceed both (abs = noise floor)
    return "REGRESSION" if over_abs and over_rel else "OK"


def compare_runs(baseline: str, candidate: str,
                 thresholds: Optional[Dict[str, Threshold]] = None,
                 ) -> List[Dict[str, Any]]:
    """Verdict rows for candidate vs baseline; a row per metric seen in
    either: ``{"metric", "baseline", "candidate", "status"}`` with status
    OK / IMPROVED / REGRESSION / BASELINE-ONLY / CANDIDATE-ONLY."""
    thresholds = thresholds if thresholds is not None else DEFAULT_THRESHOLDS
    # stale asymmetry: a carried-forward headline is a legitimate
    # DENOMINATOR (the last healthy measurement) but never a legitimate
    # candidate (it would hide the failed probe it stands in for)
    a = extract_metrics(baseline, allow_stale=True)
    b = extract_metrics(candidate)
    rows: List[Dict[str, Any]] = []
    for name in sorted(set(a) | set(b), key=lambda n: (
            n not in thresholds, n)):
        av, bv = a.get(name), b.get(name)
        if av is None or bv is None:
            status = "BASELINE-ONLY" if bv is None else "CANDIDATE-ONLY"
        elif name not in thresholds:
            status = "OK"
        else:
            status = _judge(name, av, bv, thresholds[name])
        rows.append({"metric": name, "baseline": av, "candidate": bv,
                     "status": status})
    return rows


def has_regression(rows: List[Dict[str, Any]]) -> bool:
    return any(r["status"] == "REGRESSION" for r in rows)


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v == int(v) and abs(v) < 1e9:
        return str(int(v))
    return f"{v:.6g}"


def format_comparison(rows: List[Dict[str, Any]], baseline: str,
                      candidate: str) -> str:
    """Human-readable verdict table + one-line summary."""
    lines = [f"baseline:  {baseline}", f"candidate: {candidate}", ""]
    w = max((len(r["metric"]) for r in rows), default=6)
    lines.append(f"{'metric':<{w}}  {'baseline':>12}  {'candidate':>12}  "
                 "verdict")
    for r in rows:
        lines.append(f"{r['metric']:<{w}}  {_fmt(r['baseline']):>12}  "
                     f"{_fmt(r['candidate']):>12}  {r['status']}")
    n_reg = sum(1 for r in rows if r["status"] == "REGRESSION")
    lines.append("")
    lines.append("REGRESSION: "
                 + ", ".join(r["metric"] for r in rows
                             if r["status"] == "REGRESSION")
                 if n_reg else "no regressions")
    return "\n".join(lines)


def parse_threshold_overrides(spec: str) -> Dict[str, Threshold]:
    """``--threshold metric=rel:0.2`` / ``metric=abs:1e-4`` overrides,
    comma-separated, on top of the defaults."""
    out = dict(DEFAULT_THRESHOLDS)
    for item in (s for s in spec.split(",") if s.strip()):
        name, _, bound = item.partition("=")
        kind, _, val = bound.partition(":")
        name = name.strip()
        base = out.get(name, Threshold())
        if kind.strip() == "rel":
            out[name] = dataclasses.replace(base, rel=float(val),
                                            abs_tol=None)
        elif kind.strip() == "abs":
            out[name] = dataclasses.replace(base, abs_tol=float(val),
                                            rel=None)
        else:
            raise ValueError(
                f"bad threshold {item!r} (want metric=rel:X or metric=abs:X)")
    return out
