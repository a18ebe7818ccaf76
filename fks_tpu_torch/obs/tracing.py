"""Decision-trace extraction, alignment and first-divergence localization.

Port of fks_tpu.obs.tracing. The engines' ``SimConfig.decision_trace``
(``sim.types.TraceBuffer``) logs one row per processed event: kind, pod,
chosen node, winning score and second-best margin, pending count and the
post-step free aggregates. This module is the host-side half:

- ``extract_trace``: a TraceBuffer or SimResult (one lane of a batched
  one) -> list of row dicts;
- ``align_traces``: the first divergent row of two extracted traces;
- ``replay``: re-run one engine with the trace forced on;
- ``trace_diff``: replay two (engine, policy) specs on one workload,
  align them, record ``decision_trace`` and ``trace_diff`` events through
  the active recorder;
- ``format_diff``: a readable table of a ``trace_diff`` record;
- ``policy_params``: a zoo policy, or candidate source on the funsearch
  VM, as ``(param_policy, params)``.

- ``candidate_trace_diff``: a candidate's search-tier evaluation (a
  ``funsearch.backend.CodeEvaluator``'s engine, on the VM when the
  candidate lowers) against the exact engine on the transpiled tier.

Only the first divergent row is a root cause: every later difference is
downstream of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.obs.recorder import get_recorder
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.sim.types import (
    TRACE_KIND_NAMES, TraceBuffer, map_tensors,
)

#: row fields compared exactly / within score_tol by align_traces
_EXACT_FIELDS = ("kind", "pod", "node", "pending",
                 "free_cpu", "free_mem", "free_gpu", "free_gpu_milli")
_SCORE_FIELDS = ("score", "margin")


def extract_trace(result_or_buffer, lane: Optional[int] = None
                  ) -> List[Dict[str, Any]]:
    """Written rows of a decision trace as plain dicts, one per processed
    event in step order. Accepts a ``SimResult`` (anything with a
    ``.trace``) or a ``TraceBuffer``; a batched one needs ``lane`` unless
    it holds a single lane."""
    buf = getattr(result_or_buffer, "trace", result_or_buffer)
    if buf is None:
        raise ValueError(
            "no decision trace recorded — run with SimConfig(decision_trace"
            "=True) (the fused kernel does not support tracing)")
    if not isinstance(buf, TraceBuffer):
        raise TypeError(f"not a TraceBuffer: {type(buf).__name__}")
    data, scores, count = buf.data, buf.scores, buf.count
    if data.dim() == 3:
        if lane is None and data.shape[0] != 1:
            raise ValueError(f"batched trace (data shape "
                             f"{tuple(data.shape)}); pass lane=")
        i = 0 if lane is None else lane
        data, scores, count = data[i], scores[i], count[i]
    elif lane is not None:
        raise ValueError("lane= given for a one-lane trace")
    n = min(int(count), buf.length)
    data = data[:n].cpu().tolist()
    scores = scores[:n].cpu().tolist()
    col = TraceBuffer
    return [{
        "step": i,
        "kind": TRACE_KIND_NAMES[d[col.COL_KIND]],
        "pod": d[col.COL_POD],
        "node": d[col.COL_NODE],
        "pending": d[col.COL_PENDING],
        "free_cpu": d[col.COL_FREE_CPU],
        "free_mem": d[col.COL_FREE_MEM],
        "free_gpu": d[col.COL_FREE_GPU],
        "free_gpu_milli": d[col.COL_FREE_GPU_MILLI],
        "score": float(sc[0]),
        "margin": float(sc[1]),
    } for i, (d, sc) in enumerate(zip(data, scores))]


def align_traces(a: Sequence[Dict[str, Any]], b: Sequence[Dict[str, Any]],
                 score_tol: float = 1e-5) -> Optional[Dict[str, Any]]:
    """First divergent step between two extracted traces, or None when they
    agree. Integer fields compare exactly; score/margin within
    ``score_tol``. A strict-prefix match diverges at the first missing row
    (field "length", the shorter side's row None)."""
    for i in range(min(len(a), len(b))):
        ra, rb = a[i], b[i]
        for field in _EXACT_FIELDS:
            if ra[field] != rb[field]:
                return {"step": i, "field": field, "a": ra, "b": rb}
        for field in _SCORE_FIELDS:
            if abs(ra[field] - rb[field]) > score_tol:
                return {"step": i, "field": field, "a": ra, "b": rb}
    if len(a) != len(b):
        i = min(len(a), len(b))
        return {"step": i, "field": "length",
                "a": a[i] if i < len(a) else None,
                "b": b[i] if i < len(b) else None}
    return None


def replay(workload, engine: str, param_policy, params,
           cfg: SimConfig = SimConfig(), device=None):
    """Re-run ``engine`` ("exact" | "flat") on ``workload`` with the
    decision trace forced on, on ``device`` (default ``cuda``), the params
    (weights, a VM program, or None) moved there too; returns the one-lane
    SimResult (``.trace`` set, no lane axis)."""
    from fks_tpu_torch.sim import get_engine

    cfg = dataclasses.replace(cfg, decision_trace=True)
    mod = get_engine(engine)  # rejects "fused" with an explanation
    wl = workload.to(resolve_device(device))
    run = mod.make_param_run_fn(wl, param_policy, cfg)
    params = map_tensors(lambda x: x.to(wl.device), params)
    return run(params, mod.initial_state(wl, cfg)).lane(0)


def trace_diff(workload, specs, cfg: Optional[SimConfig] = None,
               score_tol: float = 1e-5, recorder=None, label: str = "",
               max_trace_events: int = 64, device=None) -> Dict[str, Any]:
    """Replay exactly two ``(name, engine, param_policy, params)`` specs on
    the same workload, align their decision logs, and return the
    ``trace_diff`` record (also written to the recorder, with one bounded
    ``decision_trace`` event per spec)."""
    if len(specs) != 2:
        raise ValueError(
            f"trace_diff compares exactly 2 specs, got {len(specs)}")
    if cfg is None:
        # fks_tpu's replay config; cond_policy changes no port result
        cfg = SimConfig(cond_policy=True)
    rec = recorder if recorder is not None else get_recorder()
    names, traces, scores = [], [], {}
    for name, engine, param_policy, params in specs:
        res = replay(workload, engine, param_policy, params, cfg, device)
        rows = extract_trace(res)
        names.append(name)
        traces.append(rows)
        scores[name] = float(res.policy_score)
        rec.event("decision_trace", engine=name, label=label,
                  steps=len(rows), events=rows[:max_trace_events])
    div = align_traces(traces[0], traces[1], score_tol=score_tol)
    record = {
        "engines": names,
        "label": label,
        "steps": {names[0]: len(traces[0]), names[1]: len(traces[1])},
        "scores": scores,
        "score_tol": score_tol,
        "divergent": div is not None,
        "first_divergence": div,
    }
    rec.event("trace_diff", **record)
    return record


def format_diff(record: Dict[str, Any]) -> str:
    """Human-readable rendering of a ``trace_diff`` record."""
    na, nb = record["engines"]
    lines = [f"trace-diff: {na} vs {nb}"
             + (f"  [{record['label']}]" if record.get("label") else "")]
    for n in (na, nb):
        lines.append(f"  {n}: {record['steps'][n]} steps, "
                     f"fitness {record['scores'][n]:.6f}")
    div = record.get("first_divergence")
    if div is None:
        steps = record["steps"][na]
        lines.append(f"  no divergence ({steps} steps compared)")
        return "\n".join(lines)
    lines.append(f"  FIRST DIVERGENCE at step {div['step']} "
                 f"(field: {div['field']})")
    hdr = f"    {'engine':<24} {'kind':<7} {'pod':>4} {'node':>4} " \
          f"{'score':>12} {'margin':>12} {'pending':>7}"
    lines.append(hdr)
    for n, row in ((na, div.get("a")), (nb, div.get("b"))):
        if row is None:
            lines.append(f"    {n:<24} <trace ended>")
            continue
        lines.append(
            f"    {n:<24} {row['kind']:<7} {row['pod']:>4} {row['node']:>4} "
            f"{row['score']:>12.6f} {row['margin']:>12.6f} "
            f"{row['pending']:>7}")
    return "\n".join(lines)


def policy_params(workload, policy_name: str = "", code: str = "",
                  capacity: int = 512) -> Tuple[Any, Any]:
    """(param_policy, params) for a replay: candidate source ``code`` runs
    on the funsearch VM (``vm.score`` and its program for the workload's
    padded shape, float64); otherwise ``policy_name`` picks a zoo policy
    (params None)."""
    if code:
        from fks_tpu_torch.funsearch import vm
        return vm.score, vm.compile_for_workload(code, workload,
                                                 capacity=capacity)
    from fks_tpu_torch.models import zoo
    if policy_name not in zoo.ZOO:
        raise ValueError(f"unknown policy {policy_name!r}; "
                         f"available: {', '.join(sorted(zoo.ZOO))}")
    pol = zoo.ZOO[policy_name]()
    return (lambda _p, pod, nodes: pol(pod, nodes)), None


def candidate_trace_diff(evaluator, code: str, recorder=None,
                         score_tol: float = 1e-5,
                         label: str = "") -> Dict[str, Any]:
    """Trace-diff a candidate's SEARCH-tier evaluation (the evaluator's
    engine, on the VM when the candidate lowers) against the exact engine
    on the transpiled tier — the two numbers fks_tpu's parity sentinel
    compares, so the first divergence is the root-cause step of a drift.
    Replays on the evaluator's device."""
    from fks_tpu_torch.funsearch import transpiler, vm

    wl = evaluator.workload
    cfg = dataclasses.replace(evaluator.cfg, cond_policy=True)
    engine = evaluator.engine if evaluator.engine in ("exact", "flat") \
        else "flat"
    policy = transpiler.transpile(code)

    def jit_policy(_p, pod, nodes):
        return policy(pod, nodes)

    search_policy, search_params, search_tier = jit_policy, None, "jit"
    if getattr(evaluator, "use_vm", True):
        try:
            search_params = vm.compile_for_workload(code, wl)
            search_policy, search_tier = vm.score, "vm"
        except Exception:  # noqa: BLE001 — VM-ineligible -> transpiled
            pass
    specs = [
        (f"search:{engine}/{search_tier}", engine, search_policy,
         search_params),
        ("reference:exact/jit", "exact", jit_policy, None),
    ]
    return trace_diff(wl, specs, cfg=cfg, score_tol=score_tol,
                      recorder=recorder, label=label,
                      device=getattr(evaluator, "device", None))
