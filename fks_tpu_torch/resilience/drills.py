"""The resilience drill matrix.

Port of fks_tpu.resilience.drills. Each drill takes the shared
``DrillStack`` (``pipeline.drills``, on the stack's device) and
returns a detail dict with an ``ok`` bool; ``run_drills`` mixes these
into the promotion matrix. Everything is event-gated and fault-driven —
no sleeps standing in for synchronization, no probabilities:

- deadline_storm       -> impossible-deadline requests fail with TYPED
                          resilience errors (shed at admission or
                          expired in queue), normal traffic unharmed
- queue_overload       -> a bounded queue sheds the overflow submit
                          with Retry-After while admitted work completes
- device_loss_mid_batch-> an injected device fault mid-batch flips the
                          service to the exact fallback and the SAME
                          batch is answered there, parity drift 0.0
- device_loss_sharded_serve -> the same fault against the MESH-SHARDED
                          engine (8 logical shards of the stack's
                          device) degrades to the one-shard exact
                          fallback with 0.0 drift and a live batcher
                          (follow-up traffic answers)
- degrade_then_recover -> fault -> fallback -> rebuilt primary ->
                          probation -> normal, with ZERO post-recovery
                          graph captures (the rebuild was a warm engine)
- sigterm_drain        -> the drain coordinator completes every
                          in-flight Future, persists the replay buffer,
                          and a restarted service preloads it
- wal_resume_mid_generation -> a kill mid-generation resumes from the
                          WAL with zero LLM calls and zero device evals
                          for the interrupted generation

The details keep fks_tpu's keys: ``recompiles`` and
``post_recovery_recompiles`` count CUDA graph captures (the port's
compiles), and ``resume_device_programs`` the evaluator's runners.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict

from fks_tpu_torch.resilience.deadline import ResilienceError, ShedError
from fks_tpu_torch.resilience.degrade import DegradeConfig
from fks_tpu_torch.resilience.drain import (
    DrainCoordinator, load_serve_state,
)

#: logical shards of the sharded-serve drill's mesh
SHARDED_SERVE_SHARDS = 8


def _fallback_engine(stack) -> Any:
    """The reduced-batch exact fallback for the degrade drills, cached on
    the stack (its ladder is captured once per matrix run)."""
    if getattr(stack, "_resilience_fallback", None) is None:
        from fks_tpu_torch.serve import ServeEngine

        env = dataclasses.replace(stack.envelope, max_batch=1)
        eng = ServeEngine(stack.incumbent.champion, stack.workload,
                          envelope=env, engine="exact",
                          device=stack.device)
        eng.warmup()
        stack._resilience_fallback = eng
    return stack._resilience_fallback


def _drill_deadline_storm(stack) -> Dict[str, Any]:
    """Every impossible-deadline request fails with a TYPED resilience
    error (never a hang, never a late answer); interleaved normal
    requests are answered."""
    service = stack.service()
    try:
        base = stack.incumbent.base_pods
        storm_failures = 0
        for i in range(4):
            q = {"id": f"storm{i}", "deadline_ms": 0.0,
                 "pods": [dict(base[i % len(base)])]}
            try:
                fut = service.submit(q)
            except ShedError:
                storm_failures += 1  # refused at admission
                continue
            try:
                fut.result(timeout=30)
            except ResilienceError:
                storm_failures += 1  # expired while queued
        answers = stack.traffic(service, 2)
        hz = service.healthz()
        return {"ok": (storm_failures == 4 and len(answers) == 2
                       and all("score" in a for a in answers)
                       and hz["shed_total"] + hz["expired"] >= 4),
                "typed_failures": storm_failures,
                "shed": hz["shed_total"], "expired": hz["expired"]}
    finally:
        service.close()


def _drill_queue_overload(stack) -> Dict[str, Any]:
    """A bounded queue sheds the overflow submit with a Retry-After hint
    while every admitted request still completes. Event-gated: the shed
    happens while the worker is PROVABLY inside the blocked batch."""
    import threading

    from fks_tpu_torch.serve.batcher import RequestBatcher

    gate, entered = threading.Event(), threading.Event()

    def blocked(queries, enq):
        entered.set()
        if not gate.wait(30):
            raise RuntimeError("drill gate never released")
        return list(queries)

    b = RequestBatcher(blocked, max_batch=1, max_wait_s=0.0, max_queue=2)
    try:
        first = b.submit("a")
        if not entered.wait(30):
            return {"ok": False, "error": "worker never entered the batch"}
        admitted = [b.submit("b"), b.submit("c")]  # fills the queue
        shed_error = None
        try:
            b.submit("d")
        except ShedError as e:
            shed_error = e
        gate.set()
        done = [first.result(30)] + [f.result(30) for f in admitted]
        return {"ok": (shed_error is not None
                       and shed_error.retry_after_s is not None
                       and shed_error.retry_after_s > 0
                       and done == ["a", "b", "c"]
                       and b.admission.shed_queue_full == 1),
                "retry_after_s": getattr(shed_error, "retry_after_s", None),
                "completed": len(done)}
    finally:
        gate.set()
        b.close()


def _traffic_drift(stack, answers) -> float:
    """Max |served - exact reference| score drift for ``stack.traffic``
    answers — degraded-mode serving must stay bit-faithful."""
    drift = 0.0
    base = stack.incumbent.base_pods
    for i, ans in enumerate(answers):
        pods = [dict(base[(i + j) % len(base)]) for j in range(3)]
        ref = stack.incumbent.reference_answer(pods)
        drift = max(drift, abs(ans["score"] - ref["score"]))
    return drift


def _degrade_traffic_parity(stack, service, n: int) -> float:
    """Drive traffic and return max score drift vs the exact reference."""
    return _traffic_drift(stack, stack.traffic(service, n))


def _connected_traces(run_dir: str) -> Dict[str, Any]:
    """Read a degrade drill's flight-recorder dir back and verify the
    causal-trace contract (``obs.trace_ctx``): every served request
    reconstructs a COMPLETE waterfall, and the faulted batch's requests
    carry a ``primary_attempt`` child — primary-fail -> fallback-retry
    linked on ONE trace."""
    from fks_tpu_torch.obs import trace_ctx
    from fks_tpu_torch.obs.report import read_jsonl

    events = read_jsonl(os.path.join(run_dir, "events.jsonl"))
    metrics = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    by = trace_ctx.traces_by_id(trace_ctx.trace_spans(events))
    served = [m["trace_id"] for m in metrics
              if m.get("kind") == "serve_request" and m.get("trace_id")]
    complete = [t for t in served
                if trace_ctx.waterfall_complete(by.get(t, []))]
    retried = [t for t in served
               if any(s.get("path") == "serve/request/primary_attempt"
                      for s in by.get(t, []))]
    return {"served": len(served), "complete": len(complete),
            "retried": len(retried),
            "traces_ok": bool(served) and len(complete) == len(served)
            and bool(retried)}


def _drill_device_loss_mid_batch(stack) -> Dict[str, Any]:
    """An injected device fault mid-batch flips the service to the
    reduced-batch exact fallback and the SAME batch is retried there —
    the client sees an answer, not an error, and parity drift is 0.0."""
    from fks_tpu_torch.pipeline.faults import FlakyEngineProxy
    from fks_tpu_torch.serve import ServeService

    flaky = FlakyEngineProxy(stack.incumbent, failures=1)
    service = ServeService(flaky, max_wait_s=0.002)
    service.enable_degraded_mode(
        lambda: _fallback_engine(stack),
        config=DegradeConfig(background_rebuild=False))
    try:
        drift = _degrade_traffic_parity(stack, service, 3)
        degrade = service.degrade.healthz()
        return {"ok": (flaky.faults_raised == 1
                       and degrade["state"] == "degraded"
                       and degrade["flips"] == 1
                       and degrade["last_fault"] == "device_fault"
                       and service.engine is _fallback_engine(stack)
                       and drift == 0.0),
                "state": degrade["state"], "flips": degrade["flips"],
                "parity_drift": drift}
    finally:
        service.close()


def _drill_degrade_then_recover(stack) -> Dict[str, Any]:
    """Fault -> fallback -> rebuilt primary -> probation -> normal. The
    rebuild hands back the WARM incumbent, so post-recovery traffic
    captures zero new graphs."""
    from fks_tpu_torch.obs import CompileWatcher, FlightRecorder
    from fks_tpu_torch.pipeline.faults import FlakyEngineProxy
    from fks_tpu_torch.serve import ServeService

    flaky = FlakyEngineProxy(stack.incumbent, failures=1)
    with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
        # drill-local recorder: the primary-fail -> fallback-retry chain
        # must come back as ONE connected trace per request
        rec = FlightRecorder(tmp)
        service = ServeService(flaky, max_wait_s=0.002, recorder=rec)
        mgr = service.enable_degraded_mode(
            lambda: _fallback_engine(stack),
            rebuild_factory=lambda: stack.incumbent,
            config=DegradeConfig(probation_requests=2,
                                 background_rebuild=False))
        try:
            drift = _degrade_traffic_parity(stack, service, 2)  # fault+flip
            # the inline rebuild already finished; the next batch promotes
            # it into probation and the one after releases probation. Only
            # the SERVED path sits under the watcher — the parity reference
            # is computed after it (reference_answer captures graphs of its
            # own on the card)
            watcher = CompileWatcher().install()
            try:
                answers = stack.traffic(service, 4)
                recompiles = watcher.backend_compile_count
            finally:
                watcher.uninstall()
            drift = max(drift, _traffic_drift(stack, answers))
            hz = mgr.healthz()
        finally:
            service.close()
            rec.finish("ok")
            rec.close()
        traces = _connected_traces(tmp)
        return {"ok": (hz["state"] == "normal" and hz["recoveries"] == 1
                       and hz["flips"] == 1 and recompiles == 0
                       and service.engine is stack.incumbent
                       and drift == 0.0 and traces["traces_ok"]),
                "state": hz["state"], "recoveries": hz["recoveries"],
                "post_recovery_recompiles": recompiles,
                "parity_drift": drift, **traces}


def _drill_sigterm_drain(stack) -> Dict[str, Any]:
    """The drain coordinator completes every in-flight Future, persists
    the replay buffer + summary, and a restarted service preloads the
    replay — zero pending Futures, zero lost shadow traffic."""
    service = stack.service()
    closed = False
    try:
        with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
            state_path = os.path.join(tmp, "serve_state.json")
            answers = stack.traffic(service, 3)
            base = stack.incumbent.base_pods
            tail = [service.submit({"id": f"t{i}",
                                    "pods": [dict(base[i % len(base)])]})
                    for i in range(2)]
            dc = DrainCoordinator(service, state_path=state_path,
                                  grace_s=30.0)
            dc.handle_signal()  # the SIGTERM path, invoked directly
            closed = True
            pending_after = [f for f in tail if not f.done()]
            state = load_serve_state(state_path)
            service2 = stack.service()
            try:
                preloaded = service2.preload_replay(state["replay"])
            finally:
                service2.close()
            report = dc.report or {}
            return {"ok": (len(answers) == 3 and not pending_after
                           and report.get("stuck") is False
                           and state["requests_served"] >= 3
                           and len(state["replay"]) >= 3
                           and preloaded == len(state["replay"])
                           and dc.drain() is report),  # idempotent
                    "drained_pending": report.get("pending"),
                    "completed": report.get("completed"),
                    "shed": report.get("shed"),
                    "replay_persisted": len(state["replay"])}
    finally:
        if not closed:
            service.close()


def _drill_wal_resume_mid_generation(stack) -> Dict[str, Any]:
    """kill -9 mid-generation (after the ledger committed, before the
    checkpoint/WAL commit landed): the resumed run replays the WAL with
    ZERO LLM calls and ZERO device evaluations for that generation."""
    from fks_tpu_torch.funsearch import EvolutionConfig
    from fks_tpu_torch.funsearch import evolution as evo
    from fks_tpu_torch.pipeline.faults import CountingBackend, KillSwitch

    with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
        ck = os.path.join(tmp, "evo.json")
        wal = os.path.join(tmp, "wal.jsonl")

        def cfg():
            return EvolutionConfig(
                population_size=4, generations=2, elite_size=2,
                candidates_per_generation=2, max_workers=1, seed=3)

        fired = {}

        def kill_mid_gen2(stats):
            if stats.generation == 2 and not fired:
                fired["x"] = True
                raise KillSwitch("injected kill -9 mid-generation 2")

        backend = CountingBackend(seed=3)
        killed = False
        try:
            evo.run(stack.workload, cfg(), backend=backend,
                    checkpoint_path=ck, wal_path=wal,
                    on_generation=kill_mid_gen2, log=lambda _m: None,
                    device=stack.device)
        except KillSwitch:
            killed = True
        calls_before = backend.calls

        backend2 = CountingBackend(seed=3)
        fs = evo.run(stack.workload, cfg(), backend=backend2,
                     checkpoint_path=ck, wal_path=wal, log=lambda _m: None,
                     device=stack.device)
        return {"ok": (killed and backend2.calls == 0
                       and fs.wal_replayed_codes > 0
                       and fs.wal_replayed_evals > 0
                       and fs.evaluator.compile_count == 0
                       and fs.generation == 2 and fs.best is not None),
                "resume_llm_calls": backend2.calls,
                "replayed_codes": fs.wal_replayed_codes,
                "replayed_evals": fs.wal_replayed_evals,
                "resume_device_programs": fs.evaluator.compile_count}


def _drill_device_loss_sharded_serve(stack) -> Dict[str, Any]:
    """Losing a mesh lane mid-batch on the SHARDED serve engine (lane
    axis sharded over ``SHARDED_SERVE_SHARDS`` logical shards of the
    stack's device — fks_tpu's tests run it over 8 virtual CPU devices —
    with packed uploads and the device-resident snapshot cache) degrades
    to the one-shard exact fallback — the same batch is answered there
    with 0.0 drift, and the batcher is NOT wedged: follow-up traffic on
    the degraded service still completes."""
    from fks_tpu_torch.parallel.mesh import population_mesh
    from fks_tpu_torch.pipeline.faults import FlakyEngineProxy
    from fks_tpu_torch.serve import ServeService

    if getattr(stack, "_resilience_sharded", None) is None:
        from fks_tpu_torch.serve import ServeEngine

        eng = ServeEngine(stack.incumbent.champion, stack.workload,
                          envelope=stack.envelope, engine="flat",
                          state_pack=True,
                          mesh=population_mesh(
                              [stack.device] * SHARDED_SERVE_SHARDS))
        eng.warmup()
        stack._resilience_sharded = eng
    from fks_tpu_torch.obs import FlightRecorder

    flaky = FlakyEngineProxy(stack._resilience_sharded, failures=1)
    with tempfile.TemporaryDirectory(prefix="fks_drill_") as tmp:
        rec = FlightRecorder(tmp)
        service = ServeService(flaky, max_wait_s=0.002, recorder=rec)
        service.enable_degraded_mode(
            lambda: _fallback_engine(stack),
            config=DegradeConfig(background_rebuild=False))
        try:
            drift = _degrade_traffic_parity(stack, service, 3)
            follow_up = stack.traffic(service, 2)  # batcher still alive
            degrade = service.degrade.healthz()
        finally:
            service.close()
            rec.finish("ok")
            rec.close()
        traces = _connected_traces(tmp)
        return {"ok": (flaky.faults_raised == 1
                       and degrade["state"] == "degraded"
                       and degrade["flips"] == 1
                       and degrade["last_fault"] == "device_fault"
                       and service.engine is _fallback_engine(stack)
                       and drift == 0.0
                       and len(follow_up) == 2
                       and all("score" in a for a in follow_up)
                       and traces["traces_ok"]),
                "state": degrade["state"], "flips": degrade["flips"],
                "parity_drift": drift,
                "mesh_devices": SHARDED_SERVE_SHARDS,
                "follow_up_answers": len(follow_up), **traces}


RESILIENCE_DRILLS = (
    _drill_deadline_storm,
    _drill_queue_overload,
    _drill_device_loss_mid_batch,
    _drill_device_loss_sharded_serve,
    _drill_degrade_then_recover,
    _drill_sigterm_drain,
    _drill_wal_resume_mid_generation,
)
