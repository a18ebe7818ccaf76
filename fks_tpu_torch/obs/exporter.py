"""OpenMetrics export + heartbeat liveness for flight-recorder run dirs.

Port of fks_tpu.obs.exporter, pure stdlib. The recorder's JSONL surfaces
are append-only and flushed per record, so a run directory can be
scraped WHILE the run is alive. Two consumers:

- ``to_openmetrics(run_dir)`` renders the run's metrics and event
  counters as OpenMetrics text exposition (``# TYPE``/``# HELP`` blocks,
  escaped labels, terminal ``# EOF``);
- ``run_health(run_dir)`` classifies liveness from the heartbeat file
  (the one ``obs.FlightRecorder`` writes): a finished run is FINISHED; a
  live run whose heartbeat is younger than 2x its observed cadence is
  HEALTHY, older is STALE, older than 10x (or no heartbeat at all on an
  unfinished run) is DEAD. Cadence is the median inter-record gap of the
  run's own metrics stream.

``cli export-metrics`` and ``cli watch`` are thin shells over these; the
text is fks_tpu's for any run directory either package wrote.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from fks_tpu_torch.obs.report import load_run

#: heartbeat age thresholds, in multiples of the observed cadence
STALE_FACTOR = 2.0
DEAD_FACTOR = 10.0
#: floor for the cadence estimate: sub-second generation gaps would make
#: any scrape interval look stale
MIN_CADENCE_SECONDS = 5.0

PREFIX = "fks"

#: fks_serve_latency_seconds histogram bucket bounds (seconds)
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: (metric suffix, source key, help) for per-generation gauges
GENERATION_GAUGES = (
    ("generation_best_score", "best_score", "best fitness in population"),
    ("generation_median_score", "median_score", "median population fitness"),
    ("generation_p10_score", "p10_score", "10th-percentile fitness"),
    ("generation_new_candidates", "new_candidates",
     "candidates evaluated this generation"),
    ("generation_accepted", "accepted", "candidates admitted"),
    ("generation_eval_seconds", "eval_seconds", "evaluation wall seconds"),
    ("generation_llm_seconds", "llm_seconds", "LLM wall seconds"),
    ("generation_evals_per_sec", "evals_per_sec", "evaluation throughput"),
    ("generation_programs_compiled", "programs_compiled",
     "unique XLA programs built"),
    ("generation_vm_candidates", "vm_candidates",
     "candidates served by the VM tier"),
    ("generation_budget_pruned", "budget_pruned",
     "candidates pruned by the eval-budget probe rung"),
    ("generation_budget_device_seconds", "budget_device_seconds",
     "device wall seconds across all budget rungs"),
    ("generation_vm_coverage", "vm_coverage",
     "fraction of unique candidates lowerable to the VM tier"),
)


def _escape_label(value: Any) -> str:
    """OpenMetrics label-value escaping: backslash, quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(**kv: Any) -> str:
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in kv.items() if v is not None)
    return "{" + inner + "}" if inner else ""


def _num(v: Any) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f


class _Family:
    """One metric family: TYPE/HELP header plus its samples."""

    def __init__(self, name: str, mtype: str, help_: str):
        self.name, self.mtype, self.help = name, mtype, help_
        self.samples: List[str] = []

    def add(self, value: Any, **labels: Any) -> None:
        v = _num(value)
        if v is None:
            return
        body = f"{v:.10g}" if v != int(v) else str(int(v))
        self.samples.append(f"{self.name}{_labels(**labels)} {body}")

    def render(self) -> List[str]:
        if not self.samples:
            return []
        return [f"# TYPE {self.name} {self.mtype}",
                f"# HELP {self.name} {self.help}"] + self.samples


def to_openmetrics(run_dir: str) -> str:
    """Render a run directory as OpenMetrics text exposition."""
    meta, events, metrics = load_run(run_dir)
    run_id = meta.get("run_id", "?")
    fams: Dict[str, _Family] = {}

    def fam(suffix: str, mtype: str, help_: str) -> _Family:
        name = f"{PREFIX}_{suffix}"
        if name not in fams:
            fams[name] = _Family(name, mtype, help_)
        return fams[name]

    info = fam("run_info", "gauge",
               "run identity; value is always 1, identity in labels")
    info.add(1, run_id=run_id, command=meta.get("command"),
             status=meta.get("status", "?"))
    if "wall_seconds" in meta:
        fam("run_wall_seconds", "gauge", "total run wall time").add(
            meta["wall_seconds"], run_id=run_id)

    gens = [m for m in metrics if m.get("kind") == "generation"]
    for g in gens:
        gen = g.get("generation")
        for suffix, key, help_ in GENERATION_GAUGES:
            if key in g:
                fam(suffix, "gauge", help_).add(
                    g[key], run_id=run_id, generation=gen)
    if gens:
        fam("generations_total", "counter",
            "generations committed to the ledger").add(
            len(gens), run_id=run_id)

    for p in (m for m in metrics if m.get("kind") == "parity"):
        gen = p.get("generation")
        fam("parity_max_drift", "gauge",
            "max |fitness drift| vs exact reference this generation").add(
            p.get("max_drift"), run_id=run_id, generation=gen)
        fam("parity_checked", "gauge",
            "candidates parity-checked this generation").add(
            p.get("checked"), run_id=run_id, generation=gen)

    # eval-budget rung ladder (funsearch.budget): per-rung entered/
    # survived/cost gauges, labeled by generation and rung index
    for b in (m for m in metrics if m.get("kind") == "budget_rung"):
        gen, rung = b.get("generation"), b.get("rung")
        fam("budget_rung_entered", "gauge",
            "candidates entering this budget rung").add(
            b.get("entered"), run_id=run_id, generation=gen, rung=rung)
        fam("budget_rung_survived", "gauge",
            "candidates surviving this budget rung").add(
            b.get("survived"), run_id=run_id, generation=gen, rung=rung)
        fam("budget_rung_device_seconds", "gauge",
            "device wall seconds spent in this budget rung").add(
            b.get("device_seconds"), run_id=run_id, generation=gen,
            rung=rung)
        if "segments" in b:
            fam("budget_rung_segments", "gauge",
                "segmented-runner dispatches in this budget rung").add(
                b.get("segments"), run_id=run_id, generation=gen, rung=rung)

    for s in (m for m in metrics if m.get("kind") == "bench_stage"):
        stage = s.get("stage", "?")
        for key in ("evals_per_sec", "code_evals_per_sec", "compile_seconds",
                    "first_call_seconds", "steady_state_seconds", "value",
                    "budget_speedup", "budget_champion_match"):
            if key in s:
                fam(f"bench_{key}", "gauge",
                    f"bench stage {key}").add(
                    s[key], run_id=run_id, stage=stage)

    # device-time attribution (obs.profiler): per-stage split
    for d in (m for m in metrics if m.get("kind") == "device_profile"):
        stage = d.get("stage", "?")
        if stage == "__total__":
            fam("profile_attributed_fraction", "gauge",
                "share of measured wall attributed to profiler stages").add(
                d.get("attributed_fraction"), run_id=run_id,
                scope=d.get("scope"))
            fam("profile_idle_fraction", "gauge",
                "share of measured wall unattributed (idle/gaps)").add(
                d.get("idle_fraction"), run_id=run_id, scope=d.get("scope"))
            continue
        for key in ("wall_seconds", "compile_seconds", "compute_seconds",
                    "utilization_pct"):
            if key in d:
                fam(f"profile_stage_{key}", "gauge",
                    f"device-time attribution: stage {key}").add(
                    d[key], run_id=run_id, stage=stage, scope=d.get("scope"))

    # SLO burn rates (obs.history.slo_burn): latest record per SLO
    latest_burn: Dict[str, dict] = {}
    for b in (m for m in metrics if m.get("kind") == "slo_burn"):
        latest_burn[str(b.get("slo", "?"))] = b
    for name in sorted(latest_burn):
        b = latest_burn[name]
        fam("slo_burn_rate", "gauge",
            "error-budget burn rate (>1 = violating the SLO)").add(
            b.get("burn_rate"), run_id=run_id, slo=name)
        fam("slo_target", "gauge", "declared SLO target").add(
            b.get("target"), run_id=run_id, slo=name)
        fam("slo_observed", "gauge", "observed SLI value").add(
            b.get("observed"), run_id=run_id, slo=name)

    # serve-tier health (resilience): the latest serve summary's
    # queue/shed/degrade view — what /healthz reports, as gauges
    latest_serve = None
    for s in (m for m in metrics if m.get("kind") == "serve"):
        latest_serve = s
    if latest_serve is not None:
        s = latest_serve
        fam("serve_queue_depth", "gauge",
            "requests admitted but not yet batched").add(
            s.get("queue_depth"), run_id=run_id)
        fam("serve_shed_total", "gauge",
            "requests refused by admission control (queue full / "
            "deadline unmeetable / draining)").add(
            s.get("shed_total"), run_id=run_id)
        fam("serve_shed_rate", "gauge",
            "fraction of submit attempts shed at admission").add(
            s.get("shed_rate"), run_id=run_id)
        fam("serve_deadline_expired_total", "gauge",
            "admitted requests completed with DeadlineExceeded").add(
            s.get("expired"), run_id=run_id)
        if s.get("engine_state") is not None:
            fam("serve_degraded", "gauge",
                "1 while serving on the degraded fallback engine "
                "(degraded/probation), 0 when normal").add(
                0 if s.get("engine_state") == "normal" else 1,
                run_id=run_id, state=str(s.get("engine_state")))

    # per-tenant accounting (obs.workload.TenantAccountant):
    # latest tenant_stats record per tenant — the fairness index is a
    # GLOBAL value every row carries, exported once unlabeled
    latest_tenant: Dict[str, dict] = {}
    for t in (m for m in metrics if m.get("kind") == "tenant_stats"):
        latest_tenant[str(t.get("tenant", "?"))] = t
    for name in sorted(latest_tenant):
        t = latest_tenant[name]
        fam("tenant_requests_total", "gauge",
            "requests completed for this tenant").add(
            t.get("requests"), run_id=run_id, tenant=name)
        fam("tenant_shed_total", "gauge",
            "requests shed at admission for this tenant").add(
            t.get("shed"), run_id=run_id, tenant=name)
        fam("tenant_expired_total", "gauge",
            "requests whose deadline expired while queued").add(
            t.get("expired"), run_id=run_id, tenant=name)
        fam("tenant_degraded_total", "gauge",
            "requests answered on the degraded fallback engine").add(
            t.get("degraded"), run_id=run_id, tenant=name)
        fam("tenant_ewma_ms", "gauge",
            "EWMA service time for this tenant (ms)").add(
            t.get("ewma_ms"), run_id=run_id, tenant=name)
        fam("tenant_p99_ms", "gauge",
            "p99 latency for this tenant (ms)").add(
            t.get("p99_ms"), run_id=run_id, tenant=name)
        fam("tenant_goodput_qps", "gauge",
            "completed requests per second for this tenant").add(
            t.get("goodput_qps"), run_id=run_id, tenant=name)
        fam("tenant_slo_burn_rate", "gauge",
            "per-tenant p99 error-budget burn rate (>1 = violating)").add(
            t.get("burn_rate"), run_id=run_id, tenant=name)
    if latest_tenant:
        any_row = latest_tenant[sorted(latest_tenant)[0]]
        fam("tenant_fairness_index", "gauge",
            "Jain's fairness index over per-tenant goodput "
            "(1 = even, 1/n = one tenant has it all)").add(
            any_row.get("fairness_index"), run_id=run_id)

    # workload-class mix (obs.workload.QueryFingerprinter):
    # latest windowed distribution, one gauge per class
    latest_mix = None
    for m in (m for m in metrics if m.get("kind") == "workload_mix"):
        latest_mix = m
    if latest_mix is not None and isinstance(
            latest_mix.get("classes"), dict):
        for cls in sorted(latest_mix["classes"]):
            fam("workload_class_requests", "gauge",
                "requests in this workload class over the latest "
                "fingerprint window").add(
                latest_mix["classes"][cls], run_id=run_id,
                workload_class=cls)

    # loadgen summary (obs.workload.run_loadgen): the latest
    # generated-load verdict, the four compare-gated keys as gauges
    latest_lg = None
    for m in (m for m in metrics if m.get("kind") == "loadgen_summary"):
        latest_lg = m
    if latest_lg is not None:
        m = latest_lg
        for key, help_ in (
                ("loadgen_qps", "sustained completed qps under load"),
                ("loadgen_p99_ms", "p99 client-observed latency (ms)"),
                ("loadgen_shed_rate", "fraction of requests shed"),
                ("loadgen_fairness_index",
                 "Jain fairness over per-tenant goodput under load")):
            fam(key, "gauge", help_).add(
                m.get(key), run_id=run_id, mode=m.get("mode"))

    # portfolio routing (portfolio): per-slot routed-request
    # counts and per-rule routing decisions over the whole run, plus
    # per-slot promotion counts from slot_swap events
    route_slots: Dict[Any, int] = {}
    route_reasons: Dict[Any, int] = {}
    for m in (m for m in metrics if m.get("kind") == "portfolio_route"):
        slot = m.get("slot")
        route_slots[slot] = route_slots.get(slot, 0) + 1
        reason = m.get("reason")
        route_reasons[reason] = route_reasons.get(reason, 0) + 1
    for slot in sorted(route_slots, key=str):
        fam("portfolio_slot_requests", "gauge",
            "requests routed to this portfolio slot over the run "
            "(slot -1 = AOT coverage-fallback engine)").add(
            route_slots[slot], run_id=run_id, slot=slot)
    for reason in sorted(route_reasons, key=str):
        fam("portfolio_route_decisions", "gauge",
            "routing decisions by rule (pin / affinity / ab / default "
            "/ fallback / query)").add(
            route_reasons[reason], run_id=run_id, reason=reason)
    slot_swaps: Dict[Any, int] = {}
    for e in (e for e in events if e.get("kind") == "slot_swap"):
        slot = e.get("slot")
        slot_swaps[slot] = slot_swaps.get(slot, 0) + 1
    for slot in sorted(slot_swaps, key=str):
        fam("portfolio_slot_swaps", "gauge",
            "slot-table promotions into this portfolio slot "
            "(each one a zero-compile H2D upload)").add(
            slot_swaps[slot], run_id=run_id, slot=slot)

    # device-resident snapshot cache (ServeEngine content-hash ktable
    # cache): reuse vs upload economics of the sharded serve path
    latest_cache = None
    for c in (m for m in metrics if m.get("kind") == "snapshot_cache"):
        latest_cache = c
    if latest_cache is not None:
        c = latest_cache
        fam("serve_snapshot_cache_hits", "gauge",
            "query batches whose padded ktable was already device-"
            "resident").add(c.get("hits"), run_id=run_id)
        fam("serve_snapshot_cache_misses", "gauge",
            "query batches that uploaded a fresh ktable").add(
            c.get("misses"), run_id=run_id)
        fam("serve_snapshot_cache_entries", "gauge",
            "device buffers currently held by the LRU cache").add(
            c.get("entries"), run_id=run_id)
        fam("serve_snapshot_cache_hit_rate", "gauge",
            "hits / (hits + misses)").add(
            c.get("hit_rate"), run_id=run_id)
        fam("serve_h2d_bytes_per_query", "gauge",
            "host-to-device bytes shipped per answered query "
            "(post-packing, cache-discounted)").add(
            c.get("h2d_bytes_per_query"), run_id=run_id)

    # executable-footprint ledger (obs.memory): the predicted
    # HBM claim of each compiled executable, latest record per
    # (component, exe_key) — what the run WILL hold resident, from
    # memory_analysis, before any allocator ever reports pressure
    latest_fp: Dict[Tuple[str, str], dict] = {}
    for m in (m for m in metrics if m.get("kind") == "memory_footprint"):
        latest_fp[(str(m.get("component", "?")),
                   str(m.get("exe_key", "?")))] = m
    for component, exe_key in sorted(latest_fp):
        m = latest_fp[(component, exe_key)]
        fam("mem_exe_temp_bytes", "gauge",
            "XLA scratch (temp) bytes reserved by this executable").add(
            m.get("temp_bytes"), run_id=run_id, component=component,
            exe=exe_key)
        fam("mem_exe_total_bytes", "gauge",
            "predicted HBM claim: temp + argument + output + "
            "generated-code bytes").add(
            m.get("total_bytes"), run_id=run_id, component=component,
            exe=exe_key)

    # watermark sampler (obs.memory): the latest host/device
    # high-water sample; per-device rows carry the allocator's view
    latest_wm = None
    for m in (m for m in metrics if m.get("kind") == "memory_watermark"):
        latest_wm = m
    if latest_wm is not None:
        m = latest_wm
        fam("mem_host_rss_kb", "gauge",
            "host resident set size at the latest watermark sample").add(
            m.get("host_rss_kb"), run_id=run_id, stage=m.get("stage"))
        for d in (m.get("devices") or []):
            if not isinstance(d, dict):
                continue
            did = d.get("id", "?")
            fam("mem_device_bytes_in_use", "gauge",
                "device allocator bytes in use at the latest watermark "
                "sample").add(d.get("bytes_in_use"), run_id=run_id,
                              device=did, platform=d.get("platform"))
            fam("mem_device_peak_bytes", "gauge",
                "device allocator peak bytes in use").add(
                d.get("peak_bytes_in_use"), run_id=run_id, device=did,
                platform=d.get("platform"))

    # leak-sentinel verdicts (obs.memory): net live-array drift
    # across each fenced hot loop, latest record per loop
    latest_leak: Dict[str, dict] = {}
    for m in (m for m in metrics if m.get("kind") == "leak_check"):
        latest_leak[str(m.get("loop", "?"))] = m
    for loop in sorted(latest_leak):
        m = latest_leak[loop]
        fam("mem_leak_drift_bytes", "gauge",
            "net live-array byte drift across the fenced loop").add(
            m.get("drift_bytes"), run_id=run_id, loop=loop)
        fam("mem_leak_ok", "gauge",
            "1 when the fenced loop stayed within drift tolerance").add(
            1 if m.get("ok") else 0, run_id=run_id, loop=loop)

    # per-layout cost ledger (obs.layout): the roll-up per
    # (workload, mesh, layout) — pad waste and lane-step occupancy of
    # every layout the run exercised, plus the explorer's latest
    # steady-seconds probe per mesh shape
    layout_rows = [m for m in metrics if m.get("kind") == "layout_ledger"]
    if layout_rows:
        from fks_tpu_torch.obs.layout import rollup_layouts  # deferred
        for a in rollup_layouts(
                layout_rows,
                footprints=[m for m in metrics
                            if m.get("kind") == "memory_footprint"]):
            labels = dict(run_id=run_id,
                          workload=a["workload_key"] or "-",
                          mesh=a["mesh_layout"] or "unsharded",
                          layout=a["layout_key"])
            fam("layout_pad_waste_fraction", "gauge",
                "worst padded-lane waste fraction recorded under this "
                "layout").add(a["pad_waste_fraction_max"], **labels)
            fam("layout_occupancy", "gauge",
                "real / launched lane-steps under this layout").add(
                a["occupancy"], **labels)
    latest_probe: Dict[str, dict] = {}
    for m in (m for m in metrics if m.get("kind") == "layout_probe"):
        latest_probe[str(m.get("mesh_shape", "?"))] = m
    for shape in sorted(latest_probe):
        m = latest_probe[shape]
        fam("layout_probe_seconds", "gauge",
            "best warm steady seconds measured for this mesh shape by "
            "the layout explorer").add(
            m.get("steady_seconds"), run_id=run_id, mesh=shape,
            layout=m.get("layout_key"))

    # per-request latency histogram with trace-id EXEMPLARS: each bucket
    # cites the slowest request that landed in it, so a fat-tail bucket
    # on a dashboard links straight to the ``cli spans --trace`` waterfall
    # explaining it
    hist = _latency_histogram(metrics, run_id)
    if hist is not None:
        fams[hist.name] = hist

    counts: Dict[str, int] = {}
    for e in events:
        kind = e.get("kind", "?")
        counts[kind] = counts.get(kind, 0) + 1
    ev = fam("events_total", "counter", "recorder events by kind")
    for kind in sorted(counts):
        ev.add(counts[kind], run_id=run_id, kind=kind)
    wd = fam("watchdog_violations_total", "counter",
             "watchdog numeric-guard events")
    wd.add(counts.get("watchdog", 0), run_id=run_id)
    al = fam("alerts_total", "counter", "alert events (parity drift etc.)")
    al.add(counts.get("alert", 0), run_id=run_id)

    compile_s = sum(float(e.get("seconds", 0.0)) for e in events
                    if e.get("kind") == "compile")
    if compile_s:
        fam("compile_seconds_total", "counter",
            "total XLA compile wall seconds").add(compile_s, run_id=run_id)

    health = run_health(run_dir, meta=meta, metrics=metrics)
    fam("heartbeat_age_seconds", "gauge",
        "seconds since the last heartbeat (-1: no heartbeat file)").add(
        health["age"] if health["age"] is not None else -1, run_id=run_id)
    fam("run_healthy", "gauge",
        "1 when finished or heartbeat within 2x cadence, else 0").add(
        1 if health["state"] in ("FINISHED", "HEALTHY") else 0,
        run_id=run_id)

    lines: List[str] = []
    for name in sorted(fams):
        lines.extend(fams[name].render())
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _latency_histogram(metrics: List[Dict[str, Any]],
                       run_id: str) -> Optional[_Family]:
    """``fks_serve_latency_seconds``: cumulative histogram over the run's
    ``serve_request`` latencies, with an OpenMetrics EXEMPLAR on every
    non-empty bucket — the slowest traced request that landed there
    (``# {trace_id="..."} value`` suffix), so hot buckets link to their
    causal waterfall."""
    lats: List[Tuple[float, Optional[str]]] = []
    for m in metrics:
        if m.get("kind") != "serve_request":
            continue
        v = _num(m.get("latency_ms"))
        if v is not None:
            lats.append((v / 1e3, m.get("trace_id")))
    if not lats:
        return None
    f = _Family(f"{PREFIX}_serve_latency_seconds", "histogram",
                "per-request serve latency (exemplars cite the slowest "
                "traced request per bucket)")
    lab = _labels(run_id=run_id)[1:-1]  # inner body, le= appended per bucket
    cum = 0
    lo = -1.0  # first bucket includes zero-latency samples
    for le in (*LATENCY_BUCKETS, float("inf")):
        inside = [(s, t) for s, t in lats if lo < s <= le] if le != float(
            "inf") else [(s, t) for s, t in lats if s > lo]
        cum += len(inside)
        le_s = "+Inf" if le == float("inf") else f"{le:.10g}"
        line = f'{f.name}_bucket{{{lab},le="{le_s}"}} {cum}'
        exemplar = max((p for p in inside if p[1]), default=None)
        if exemplar is not None:
            line += (f' # {{trace_id="{_escape_label(exemplar[1])}"}}'
                     f" {exemplar[0]:.6g}")
        f.samples.append(line)
        lo = le
    f.samples.append(
        f"{f.name}_sum{{{lab}}} {sum(s for s, _ in lats):.6g}")
    f.samples.append(f"{f.name}_count{{{lab}}} {len(lats)}")
    return f


def _heartbeat_age(run_dir: str) -> Optional[float]:
    """Seconds since the run's last heartbeat, None when absent/corrupt.

    Two clocks bound the age: the timestamp INSIDE the file (the
    writer's wall clock) and the file's mtime (the filesystem's clock).
    On a shared filesystem either can lag or lead — writer/reader clock
    skew, NFS attribute-cache delay — and a one-sided read flaps a
    healthy run between STALE and DEAD. The age is the SMALLER of the
    two (most recent evidence of life), clamped at zero against skew
    that puts the heartbeat in the future."""
    path = os.path.join(run_dir, "heartbeat")
    try:
        with open(path) as f:
            beat = json.load(f)
        now = time.time()
        age = now - float(beat["ts"])
        try:
            age = min(age, now - os.path.getmtime(path))
        except OSError:
            pass
        return max(0.0, age)
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _cadence(metrics: List[Dict[str, Any]]) -> float:
    """Median inter-record gap of the metrics stream (seconds), floored
    at MIN_CADENCE_SECONDS; the floor alone when under two records."""
    ts = sorted(float(m["ts"]) for m in metrics if _num(m.get("ts")))
    gaps = sorted(b - a for a, b in zip(ts, ts[1:]) if b > a)
    if not gaps:
        return MIN_CADENCE_SECONDS
    return max(MIN_CADENCE_SECONDS, gaps[len(gaps) // 2])


def run_health(run_dir: str, meta: Optional[dict] = None,
               metrics: Optional[list] = None) -> Dict[str, Any]:
    """Liveness verdict for a run dir: ``{"state", "age", "cadence"}``
    with state one of FINISHED / HEALTHY / STALE / DEAD (see module
    docstring for the thresholds)."""
    if meta is None or metrics is None:
        meta, _events, metrics = load_run(run_dir)
    age = _heartbeat_age(run_dir)
    cadence = _cadence(metrics or [])
    if meta.get("status") in ("ok", "error") or "finished" in meta:
        return {"state": "FINISHED", "age": age, "cadence": cadence,
                "status": meta.get("status")}
    if age is None:
        return {"state": "DEAD", "age": None, "cadence": cadence,
                "status": meta.get("status")}
    if age > DEAD_FACTOR * cadence:
        state = "DEAD"
    elif age > STALE_FACTOR * cadence:
        state = "STALE"
    else:
        state = "HEALTHY"
    return {"state": state, "age": age, "cadence": cadence,
            "status": meta.get("status")}


def health_line(run_dir: str) -> str:
    """One-line liveness summary, as shown by ``cli watch``/``report``."""
    h = run_health(run_dir)
    age = "-" if h["age"] is None else f"{h['age']:.0f}s"
    return (f"{h['state']}: heartbeat age {age} "
            f"(cadence ~{h['cadence']:.0f}s)")


def watch(run_dir: str, interval: float = 5.0, once: bool = False,
          out=None, clock=time.sleep) -> int:
    """Live-tail a run: print the latest generation/bench line plus the
    liveness verdict every ``interval`` seconds until the run finishes
    (or forever under an external watchdog). Returns 0 when the run
    finished ok, 1 when it finished in error or is DEAD."""
    import sys

    out = out or sys.stdout
    seen = 0
    while True:
        meta, _events, metrics = load_run(run_dir)
        fresh = metrics[seen:]
        seen = len(metrics)
        for m in fresh:
            kind = m.get("kind")
            if kind == "generation":
                out.write(f"gen {m.get('generation')}: "
                          f"best {m.get('best_score', 0.0):.4f} "
                          f"new {m.get('new_candidates', 0)} "
                          f"eval {m.get('eval_seconds', 0.0):.1f}s\n")
            elif kind == "parity":
                out.write(f"parity gen {m.get('generation')}: "
                          f"max drift {m.get('max_drift')}\n")
            elif kind == "bench_stage":
                v = m.get("value", m.get("evals_per_sec"))
                out.write(f"bench {m.get('stage', '?')}: {v}\n")
            elif kind == "leak_check":
                verdict = "ok" if m.get("ok") else "LEAK"
                out.write(f"leak {m.get('loop', '?')}: {verdict} "
                          f"drift {m.get('drift_count', 0)} arrays / "
                          f"{m.get('drift_bytes', 0)} bytes over "
                          f"{m.get('iterations', 0)} iters\n")
            elif kind == "slo_burn":
                rate = _num(m.get("burn_rate")) or 0.0
                line = (f"slo {m.get('slo', '?')}: burn {rate:.2f}x "
                        f"(observed {m.get('observed')} vs target "
                        f"{m.get('target')})")
                if rate > 1.0:
                    line = "SLO ALERT " + line
                out.write(line + "\n")
            elif kind == "tenant_stats":
                rate = _num(m.get("burn_rate")) or 0.0
                line = (f"tenant {m.get('tenant', '?')}: "
                        f"{m.get('requests', 0)} req "
                        f"p99 {m.get('p99_ms', 0.0)}ms "
                        f"shed {m.get('shed', 0)} "
                        f"burn {rate:.2f}x "
                        f"fair {m.get('fairness_index', 1.0)}")
                if rate > 1.0:
                    line = "TENANT SLO ALERT " + line
                out.write(line + "\n")
            elif kind == "workload_mix":
                classes = m.get("classes") or {}
                top = sorted(classes.items(), key=lambda kv: -kv[1])[:3]
                mix = " ".join(f"{c}={n}" for c, n in top)
                out.write(f"workload mix ({m.get('window', 0)} req, "
                          f"{m.get('distinct', 0)} classes): {mix}\n")
            elif kind == "loadgen_summary":
                out.write(f"loadgen [{m.get('mode', '?')}]: "
                          f"{m.get('loadgen_qps', 0.0)} qps "
                          f"p99 {m.get('loadgen_p99_ms', 0.0)}ms "
                          f"shed {m.get('loadgen_shed_rate', 0.0)} "
                          f"fair {m.get('loadgen_fairness_index', 1.0)}\n")
        h = run_health(run_dir, meta=meta, metrics=metrics)
        age = "-" if h["age"] is None else f"{h['age']:.0f}s"
        out.write(f"[{h['state']}] status={meta.get('status', '?')} "
                  f"heartbeat {age}\n")
        out.flush()
        if h["state"] == "FINISHED":
            return 0 if meta.get("status") == "ok" else 1
        if h["state"] == "DEAD":
            return 1
        if once:
            return 0
        clock(interval)
