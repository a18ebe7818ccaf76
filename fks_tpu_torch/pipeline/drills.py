"""The deterministic fault-injection drill matrix.

Port of fks_tpu.pipeline.drills, on a device of the caller's choosing
(``cuda`` by default, ``cpu`` for the CPU tests). ``run_drills`` stands
up a tiny warm serve stack (synthetic cluster, exact engine, request
coalescer) and walks every failure mode the
promotion pipeline claims to survive, asserting the PRECISE degraded
behaviour — serve keeps answering on the old champion throughout:

- corrupt champion JSON (torn mid-write)      -> REJECTED at load
- device-eval exception during the build      -> REJECTED, no crash
- injected p99 regression in shadow           -> REJECTED at shadow
- kill -9 after PENDING / SHADOW / PROMOTED   -> restart resumes to a
  consistent state from promotion.jsonl alone
- post-promotion SLO burn                     -> automatic ROLLED_BACK
- clean promotion                             -> zero warm-path graph
  captures around the hot swap (CompileWatcher)
- total LLM outage                            -> evolve loop halts with
  the llm_outage circuit breaker, checkpoint on disk

plus the resilience matrix (``resilience.drills``): deadline storms,
queue overload, device loss mid-batch, degrade-then-recover, SIGTERM
drain, and WAL resume mid-generation.

Everything is seeded and fault-driven, so the matrix is a CLI (``cli
pipeline --drill``), a test and a phase of ``chip_smoke.py``, all from
one function. The controller runs with fks_tpu's envelope
(``PromotionConfig`` defaults, two replayed queries): the rejecting
latency drill is driven by ``FaultPlan.shadow_latency_ms`` and the
rollback by an impossible p99 target, and the promoting drills must
clear the default 2x p99 gate on their own replay times, the one
verdict that reads a clock. Engines are cached per champion code so the
matrix captures each ladder once. The details keep fks_tpu's keys
(``recompiles`` counts graph captures).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List

from fks_tpu_torch.pipeline.controller import PromotionConfig, PromotionController
from fks_tpu_torch.pipeline.faults import (
    FaultPlan, KillSwitch, OutageBackend, write_champion,
    write_corrupt_champion,
)

INCUMBENT_LOGIC = "score = 1000"
CANDIDATE_LOGIC = ("score = 1000 + (node.cpu_milli_left - pod.cpu_milli) "
                   "/ max(1, node.cpu_milli_total)")


class DrillStack:
    """Shared warm serving stack for the matrix on ``device``: one
    incumbent engine, one candidate-engine cache, fresh ``ServeService``
    + promotion log per drill (services are cheap; captured ladders are
    not)."""

    def __init__(self, device=None) -> None:
        from fks_tpu_torch.data.synthetic import synthetic_workload
        from fks_tpu_torch.device import resolve_device
        from fks_tpu_torch.funsearch import template
        from fks_tpu_torch.serve import ChampionSpec, ShapeEnvelope

        self.device = resolve_device(device)
        self.workload = synthetic_workload(8, 16, seed=0)
        self.envelope = ShapeEnvelope(max_pods=8, min_pod_bucket=8,
                                      max_batch=2)
        self.incumbent_code = template.fill_template(INCUMBENT_LOGIC)
        self.candidate_code = template.fill_template(CANDIDATE_LOGIC)
        self._cache: Dict[str, Any] = {}
        self.incumbent = self.engine_for(
            ChampionSpec(code=self.incumbent_code, score=0.4,
                         source="<drill-seed>"))

    def engine_for(self, champ) -> Any:
        from fks_tpu_torch.serve import ServeEngine

        key = champ.code
        if key not in self._cache:
            eng = ServeEngine(champ, self.workload, envelope=self.envelope,
                              device=self.device)
            eng.warmup()
            self._cache[key] = eng
        return self._cache[key]

    def service(self):
        from fks_tpu_torch.serve import ServeService

        return ServeService(self.incumbent, max_wait_s=0.002)

    def controller(self, service, tmp: str, *, faults=None,
                   **cfg_overrides) -> PromotionController:
        cfg = PromotionConfig(shadow_queries=2, **cfg_overrides)
        return PromotionController(
            service, self.workload, ledger_dir=tmp,
            log_path=os.path.join(tmp, "promotion.jsonl"), config=cfg,
            faults=faults, engine_factory=self.engine_for)

    def traffic(self, service, n: int = 3, pods: int = 3) -> List[dict]:
        base = self.incumbent.base_pods
        futs = [service.submit(
            {"id": f"d{i}",
             "pods": [dict(base[(i + j) % len(base)]) for j in range(pods)]})
            for i in range(n)]
        return [f.result(timeout=300) for f in futs]


def drills() -> Dict[str, Callable[[DrillStack], Dict[str, Any]]]:
    """The matrix in its order: drill name -> drill (the 11 promotion
    drills, then ``resilience.drills.RESILIENCE_DRILLS``)."""
    from fks_tpu_torch.resilience.drills import RESILIENCE_DRILLS

    return {d.__name__.replace("_drill_", ""): d for d in (
        _drill_corrupt_champion, _drill_device_eval_error,
        _drill_p99_regression_rejected, _drill_kill_pending,
        _drill_kill_shadow, _drill_kill_promoted,
        _drill_rollback_on_burn, _drill_zero_recompile_swap,
        _drill_vm_double_swap, _drill_portfolio_slot_promotion,
        _drill_llm_outage, *RESILIENCE_DRILLS)}


def run_drill(stack: DrillStack, name: str) -> Dict[str, Any]:
    """One drill's result dict: ``drill``, ``ok`` and its detail. A drill
    crash is a failed drill, its error in the detail."""
    try:
        detail = drills()[name](stack)
        ok = bool(detail.pop("ok"))
    except Exception as e:  # noqa: BLE001 — a drill crash is a failure
        detail, ok = {"error": f"{type(e).__name__}: {e}"}, False
    return {"drill": name, "ok": ok, **detail}


def run_drills(log: Callable[[str], None] = print,
               only: str = "", device=None) -> List[Dict[str, Any]]:
    """Run the whole matrix on ``device`` (default ``cuda``); one result
    dict per drill, ``ok`` per drill. ``only`` is a comma-separated list
    of name substrings — the CLI's ``--only`` runs a subset without
    paying for the rest of the matrix."""
    stack = DrillStack(device)
    results = []
    filters = [t.strip() for t in only.split(",") if t.strip()]
    for name in drills():
        if filters and not any(f in name for f in filters):
            continue
        res = run_drill(stack, name)
        detail = {k: v for k, v in res.items() if k not in ("drill", "ok")}
        log(f"drill {name}: {'ok' if res['ok'] else 'FAIL'} {detail}")
        results.append(res)
    return results


def _drill_corrupt_champion(stack: DrillStack) -> Dict[str, Any]:
    """A torn champion JSON degrades to REJECTED; serving never stops."""
    service = stack.service()
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            path = write_corrupt_champion(tmp)
            ctrl = stack.controller(service, tmp)
            out = ctrl.poll_once(path)
            answers = stack.traffic(service, 2)
            return {"ok": (out["action"] == "rejected"
                           and "load_failed" in out["reason"]
                           and len(answers) == 2
                           and all("score" in a for a in answers)),
                    "action": out["action"], "reason": out.get("reason", "")}
    finally:
        service.close()


def _drill_device_eval_error(stack: DrillStack) -> Dict[str, Any]:
    """A device-eval exception while building the shadow engine degrades
    to REJECTED (build_failed), not a controller crash."""
    service = stack.service()
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            write_champion(tmp, stack.candidate_code, 0.9)
            ctrl = stack.controller(service, tmp,
                                    faults=FaultPlan(device_eval_error=True))
            out = ctrl.poll_once()
            answers = stack.traffic(service, 2)
            return {"ok": (out["action"] == "rejected"
                           and "build_failed" in out["reason"]
                           and len(answers) == 2),
                    "action": out["action"], "reason": out.get("reason", "")}
    finally:
        service.close()


def _drill_p99_regression_rejected(stack: DrillStack) -> Dict[str, Any]:
    """A fitness-winning candidate with an injected latency regression is
    rejected at shadow — it never reaches traffic."""
    service = stack.service()
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            stack.traffic(service, 3)
            write_champion(tmp, stack.candidate_code, 0.9)
            from fks_tpu_torch.obs.history import SLOConfig

            ctrl = stack.controller(
                service, tmp, faults=FaultPlan(shadow_latency_ms=400.0),
                max_p99_regression=1.5, slo=SLOConfig(p99_ms=50.0))
            out = ctrl.poll_once()
            return {"ok": (out["action"] == "rejected"
                           and service.engine is stack.incumbent
                           and service.swaps == 0),
                    "action": out["action"], "reason": out.get("reason", "")}
    finally:
        service.close()


def _kill_drill(stack: DrillStack, state: str) -> Dict[str, Any]:
    """kill -9 right after ``state`` hits the log; then a fresh
    controller+service (a restarted process) resumes from the log."""
    service = stack.service()
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            cand = write_champion(tmp, stack.candidate_code, 0.9)
            ctrl = stack.controller(service, tmp,
                                    faults=FaultPlan(kill_after_state=state))
            killed = False
            try:
                ctrl.poll_once()
            except KillSwitch:
                killed = True
            # the crashed controller never took serving down
            survived = len(stack.traffic(service, 2)) == 2
            service2 = stack.service()
            try:
                ctrl2 = stack.controller(service2, tmp)
                rec = ctrl2.recover()
                if state == "PROMOTED":
                    # the log committed before the flip: restart must
                    # resolve to the candidate, with nothing left to do
                    out = ctrl2.poll_once()
                    ok = (killed and survived
                          and rec["active"] is not None
                          and ctrl2.active_champion() == cand
                          and out["action"] == "idle")
                else:
                    out = ctrl2.poll_once()
                    ok = (killed and survived and rec["interrupted"]
                          and out["action"] == "promoted"
                          and service2.engine.champion.score == 0.9)
                return {"ok": ok, "killed_after": state,
                        "recovered": out["action"]}
            finally:
                service2.close()
    finally:
        service.close()


def _drill_kill_pending(stack: DrillStack) -> Dict[str, Any]:
    return _kill_drill(stack, "PENDING")


def _drill_kill_shadow(stack: DrillStack) -> Dict[str, Any]:
    return _kill_drill(stack, "SHADOW")


def _drill_kill_promoted(stack: DrillStack) -> Dict[str, Any]:
    return _kill_drill(stack, "PROMOTED")


def _drill_rollback_on_burn(stack: DrillStack) -> Dict[str, Any]:
    """Post-promotion SLO burn inside the probation window rolls back to
    the last-good engine automatically."""
    from fks_tpu_torch.obs.history import SLOConfig

    service = stack.service()
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            stack.traffic(service, 2)
            write_champion(tmp, stack.candidate_code, 0.9)
            ctrl = stack.controller(service, tmp, probation_requests=16)
            promoted = ctrl.poll_once()
            # production degrades after the swap: every request now
            # misses the (retroactively impossible) p99 target
            ctrl.cfg = dataclasses.replace(ctrl.cfg,
                                           slo=SLOConfig(p99_ms=1e-6))
            stack.traffic(service, 3)
            out = ctrl.check_probation()
            return {"ok": (promoted["action"] == "promoted"
                           and out is not None
                           and out["action"] == "rolled_back"
                           and service.engine is stack.incumbent
                           and ctrl.log.state_of(out["attempt"])
                           == "ROLLED_BACK"),
                    "promoted": promoted["action"],
                    "then": out["action"] if out else "nothing"}
    finally:
        service.close()


def _drill_zero_recompile_swap(stack: DrillStack) -> Dict[str, Any]:
    """A clean promotion: the hot swap plus post-swap traffic capture
    ZERO new graphs (the ladder was captured off the request path)."""
    from fks_tpu_torch.obs import CompileWatcher

    service = stack.service()
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            stack.traffic(service, 3)
            write_champion(tmp, stack.candidate_code, 0.9)
            ctrl = stack.controller(service, tmp)
            out = ctrl.poll_once()
            watcher = CompileWatcher().install()
            try:
                answers = stack.traffic(service, 4)
                recompiles = watcher.backend_compile_count
            finally:
                watcher.uninstall()
            return {"ok": (out["action"] == "promoted"
                           and service.engine.champion.score == 0.9
                           and recompiles == 0 and len(answers) == 4),
                    "action": out["action"], "recompiles": recompiles,
                    "swap_ms": ctrl.last_swap_ms}
    finally:
        service.close()


def _drill_vm_double_swap(stack: DrillStack) -> Dict[str, Any]:
    """The VM-native promotion fast path: TWO consecutive hot-swaps on
    a champion-as-data incumbent capture ZERO graphs end to end —
    shadow eval, swap, and post-swap traffic are all table copies into
    the warm graphs."""
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.obs import CompileWatcher
    from fks_tpu_torch.serve import ChampionSpec, ServeService, VMServeEngine

    incumbent = VMServeEngine(
        ChampionSpec(code=stack.incumbent_code, score=0.4,
                     source="<drill-seed>"),
        stack.workload, envelope=stack.envelope, device=stack.device)
    incumbent.warmup()
    service = ServeService(incumbent, max_wait_s=0.002)
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            stack.traffic(service, 3)
            ctrl = stack.controller(service, tmp)
            second = template.fill_template(
                "score = 2000 + (node.memory_mib_left - pod.memory_mib)"
                " / max(1, node.memory_mib_total)")
            watcher = CompileWatcher().install()
            try:
                write_champion(tmp, stack.candidate_code, 0.9)
                first = ctrl.poll_once()
                stack.traffic(service, 2)
                write_champion(tmp, second, 1.3)
                then = ctrl.poll_once()
                stack.traffic(service, 2)
                recompiles = watcher.backend_compile_count
            finally:
                watcher.uninstall()
            return {"ok": (first["action"] == "promoted"
                           and first.get("engine_kind") == "vm"
                           and then["action"] == "promoted"
                           and then.get("engine_kind") == "vm"
                           and service.engine is incumbent
                           and incumbent.vm_swaps == 2
                           and recompiles == 0),
                    "first": first["action"], "then": then["action"],
                    "recompiles": recompiles,
                    "vm_swaps": incumbent.vm_swaps,
                    "swap_ms": incumbent.last_swap_breakdown.get(
                        "swap_ms", 0.0)}
    finally:
        service.close()


def _drill_portfolio_slot_promotion(stack: DrillStack) -> Dict[str, Any]:
    """Per-slot promotion inside the shared portfolio graphs: the
    FleetController stages the candidate in a spare shadow slot of the
    LIVE graphs, evaluates it on mirrored traffic, and commits it
    into the target slot — zero graph captures end to end, and a
    bystander slot's answers are bit-identical across the whole
    lifecycle (promoting slot 1 must never perturb slot 2)."""
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.obs import CompileWatcher
    from fks_tpu_torch.portfolio import (
        FleetController, PortfolioEngine, PortfolioService, Router,
    )
    from fks_tpu_torch.serve import ChampionSpec

    second = template.fill_template(
        "score = 2000 + (node.memory_mib_left - pod.memory_mib)"
        " / max(1, node.memory_mib_total)")
    champs = [
        ChampionSpec(code=stack.incumbent_code, score=0.4,
                     source="<slot0>"),
        ChampionSpec(code=stack.candidate_code, score=0.5,
                     source="<slot1>"),
        ChampionSpec(code=second, score=0.6, source="<slot2>"),
    ]
    engine = PortfolioEngine(champs, stack.workload,
                             envelope=stack.envelope, n_slots=4,
                             device=stack.device)
    engine.warmup()
    base = engine.base_pods
    bystander_q = [dict(base[j]) for j in range(3)]
    before = engine.answer_batch([bystander_q], slots=[2])[0]
    service = PortfolioService(engine, router=Router(engine.n_slots),
                               max_wait_s=0.002)
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            stack.traffic(service, 3)
            ctrl = FleetController(
                service, stack.workload, slot=1, shadow_slot=3,
                ledger_dir=tmp,
                log_path=os.path.join(tmp, "promotion.jsonl"),
                config=PromotionConfig(shadow_queries=2))
            promoted_code = template.fill_template(
                "score = 3000 + (node.cpu_milli_left - pod.cpu_milli)"
                " / max(1, node.cpu_milli_total)")
            watcher = CompileWatcher().install()
            try:
                write_champion(tmp, promoted_code, 0.9)
                verdict = ctrl.poll_once()
                stack.traffic(service, 2)
                recompiles = watcher.backend_compile_count
            finally:
                watcher.uninstall()
            after = engine.answer_batch([bystander_q], slots=[2])[0]
            return {"ok": (verdict["action"] == "promoted"
                           and service.engine is engine
                           and engine.slot_swaps[1] >= 1
                           and recompiles == 0
                           and after["score"] == before["score"]
                           and after["placements"]
                           == before["placements"]),
                    "verdict": verdict["action"],
                    "recompiles": recompiles,
                    "slot_swaps": list(engine.slot_swaps),
                    "bystander_drift":
                        abs(after["score"] - before["score"])}
    finally:
        service.close()


def _drill_llm_outage(stack: DrillStack) -> Dict[str, Any]:
    """Total LLM outage: the evolve loop halts via the circuit breaker
    (llm_outage after N empty generations) with a checkpoint on disk,
    instead of spinning through the generation budget."""
    from fks_tpu_torch.funsearch import EvolutionConfig
    from fks_tpu_torch.funsearch import evolution as evo

    with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
        ck = os.path.join(tmp, "evo.json")
        cfg = EvolutionConfig(
            population_size=4, generations=6, elite_size=2,
            candidates_per_generation=2, max_workers=1, seed=3,
            early_stop_threshold=1.1, llm_outage_generations=2)
        backend = OutageBackend()
        fs = evo.run(stack.workload, cfg, backend=backend,
                     checkpoint_path=ck, out_dir=os.path.join(tmp, "out"),
                     log=lambda _m: None, device=stack.device)
        return {"ok": (fs.llm_outage and fs.generation == 2
                       and os.path.exists(ck) and fs.best is not None
                       and backend.calls > 0),
                "halted_at_generation": fs.generation,
                "llm_calls": backend.calls}
