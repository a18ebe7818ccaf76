"""PromotionController: shadow-gated champion hot-swap with rollback.

Port of fks_tpu.pipeline.controller. The controller closes the loop
between evolve and serve. It tails a champion ledger directory (the
evolve loop's ``--out`` dir) for new champions; each candidate runs the
promotion state machine recorded in ``promotion.jsonl``
(``pipeline.state``):

1. PENDING   — candidate seen; cheap fitness gate (must beat the
               incumbent's score by ``min_score_gain``) before any
               device work.
2. SHADOW    — the candidate's shadow engine is built OFF the request
               path (a table upload into the incumbent's graphs on the VM
               fast path, a warmed bucket ladder of CUDA graphs on the
               AOT path), then shadow-evaluated against a replay of recent
               live serve traffic: per-query parity vs its own unbatched
               exact reference (``ParitySentinel``), p99 vs the incumbent
               on the same queries, SLO burn on the shadow latencies, and
               optionally the robust scenario suite (``make_suite_eval``
               + ``aggregate``).
3. PROMOTED  — the PROMOTED record is appended FIRST (the log is the
               commit point), then the service's engine is flipped — one
               attribute assignment (AOT) or one table copy (VM), zero
               graph captures because the shadow is already warm. A kill
               between append and flip resolves to the promoted champion
               on restart.
   REJECTED  — any gate failure; serve keeps answering on the incumbent.
4. probation — for the next ``probation_requests`` live requests the
               controller prices SLO burn on post-swap latencies; a
               burn > 1 swaps the last-good engine back and appends
               ROLLED_BACK (again: log first, then flip).

Attempt ids are content-addressed (sha1 of the champion file bytes), so
a restarted controller resumes the SAME attempt after ``kill -9`` and a
rewritten champion file is a new attempt.

The shadow is built and replayed while the service's batcher thread
keeps serving. Its graph captures run under
``obs.telemetry.capture_scope("shadow")``, so a ``CompileWatcher`` counts
them apart from the serving path's (which must stay at zero), and
``sim.engine.capture`` lets a capture run beside another thread's
serving work.

A port engine answers one batch at a time, so the incumbent's replay of
a query cannot run beside live batches. The shadow's replay is held to
the same terms: each replay, the shadow's and the incumbent's, takes the
incumbent's batch turn (``ServeEngine.exclusive``) and starts its clock
inside it. Neither time then holds a wait behind a live batch, and
neither shares the device with one. The controller holds the turn for
one replayed query at a time, so live batches go between replays.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from fks_tpu_torch import obs
from fks_tpu_torch.funsearch.vm import VMUnsupported
from fks_tpu_torch.obs import telemetry, trace_ctx
from fks_tpu_torch.obs.history import SLOConfig, slo_burn
from fks_tpu_torch.obs.watchdog import ParitySentinel
from fks_tpu_torch.pipeline.faults import NO_FAULTS, FaultPlan, KillSwitch
from fks_tpu_torch.pipeline.state import TERMINAL, PromotionLog
from fks_tpu_torch.serve.artifact import (
    CHAMPION_DIR, ChampionSpec, ServeEngine, latest_champion, load_champion,
)

#: the ``capture_scope`` of a promotion's shadow build and replay
SHADOW_SCOPE = "shadow"


@dataclasses.dataclass
class PromotionConfig:
    """Gates a candidate must clear before (and after) shipping."""
    min_score_gain: float = 0.0       # candidate.score - incumbent.score
    parity_tol: float = 1e-5          # shadow answer vs its exact reference
    shadow_queries: int = 4           # replayed live queries per shadow eval
    max_p99_regression: float = 2.0   # shadow p99 <= factor * incumbent p99
    probation_requests: int = 100     # live requests watched after a swap
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    suite: str = ""                   # optional robust scenario-suite gate
    robust_aggregation: str = "mean"


def attempt_id(path: str) -> str:
    """Content-addressed attempt id: sha1 of the champion file bytes."""
    h = hashlib.sha1()
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:12]


class PromotionController:
    """Drives the promotion state machine over a live ``ServeService``.

    ``engine_factory(champion) -> warm ServeEngine`` is injectable so
    tests and drills can share captured ladders; the default builds a
    ServeEngine with the incumbent's envelope, engine knobs, device and
    mesh, and warms it.
    """

    def __init__(self, service, workload=None, *, ledger_dir: str = "",
                 log_path: str = "", config: Optional[PromotionConfig] = None,
                 recorder=None, faults: Optional[FaultPlan] = None,
                 engine_factory: Optional[Callable[..., Any]] = None) -> None:
        self.service = service
        self.cfg = config or PromotionConfig()
        self.ledger_dir = ledger_dir or CHAMPION_DIR
        self.log = PromotionLog(
            log_path or os.path.join(self.ledger_dir, "promotion.jsonl"))
        self.recorder = recorder if recorder is not None else obs.get_recorder()
        self.faults = faults or NO_FAULTS
        self.workload = workload
        self._factory = engine_factory or self._build_engine
        self.last_swap_ms = 0.0
        self.last_shadow: Dict[str, Any] = {}
        self._probation: Optional[Dict[str, Any]] = None
        # terminal attempts never retry; PROMOTED ones never re-promote.
        # Interrupted attempts (PENDING/SHADOW) stay eligible — that is
        # the kill -9 recovery path.
        self._done = {a for a, s in self.log.states().items()
                      if s in TERMINAL or s == "PROMOTED"}

    # -------------------------------------------------------- recovery

    def recover(self) -> Dict[str, Any]:
        """What a restarted controller finds in the log: the active
        promotion (what should be serving), interrupted attempts (will
        be replayed by the next poll), torn-line count."""
        return {"active": self.log.active(),
                "interrupted": self.log.interrupted(),
                "skipped_lines": self.log.skipped_lines}

    def active_champion(self) -> Optional[str]:
        """Champion path of the surviving promotion, if any — what a
        restarted server should load before taking traffic."""
        rec = self.log.active()
        return rec.get("champion") if rec else None

    # ------------------------------------------------------------ poll

    def poll_once(self, path: Optional[str] = None) -> Dict[str, Any]:
        """One supervision step: probation check first (rollback beats
        new work), then resolve the newest ledger champion and run the
        attempt if it has not been decided yet."""
        out = self.check_probation()
        if out is not None:
            return out
        path = path or latest_champion(self.ledger_dir,
                                       recorder=self.recorder)
        if path is None:
            return {"action": "idle", "reason": "no readable champion in "
                                                f"{self.ledger_dir}"}
        try:
            aid = attempt_id(path)
        except OSError as e:
            return {"action": "idle", "reason": f"unreadable champion: {e}"}
        if aid in self._done:
            return {"action": "idle", "attempt": aid,
                    "reason": "newest champion already decided"}
        return self._attempt(aid, path)

    # --------------------------------------------------------- attempt

    def _attempt(self, aid: str, path: str) -> Dict[str, Any]:
        """One promotion attempt under ONE causal trace: the trace id is
        derived from the content-addressed attempt id (``promo-<aid>``),
        so a restarted controller resuming the same attempt continues
        the SAME trace."""
        ctx = (trace_ctx.TraceContext(f"promo-{aid}", trace_ctx.new_span_id())
               if getattr(self.recorder, "enabled", False) else None)
        t0 = time.perf_counter()
        with trace_ctx.activate(ctx):
            out = self._attempt_decide(aid, path)
            trace_ctx.emit(self.recorder, "promotion",
                           time.perf_counter() - t0, ctx=ctx, root=True,
                           attempt=aid, action=out.get("action", "?"))
        return out

    def _attempt_decide(self, aid: str, path: str) -> Dict[str, Any]:
        self._transition(aid, "PENDING", champion=path)
        try:
            champ = load_champion(path)
        except (ValueError, OSError) as e:
            return self._reject(aid, path, f"load_failed: {e}")
        # content link to the evolve generation that produced this
        # champion: the same sha1(code) the candidate marker spans carry
        trace_ctx.emit(self.recorder, "promotion/candidate", 0.0,
                       code_sha=hashlib.sha1(
                           champ.code.encode()).hexdigest()[:12],
                       attempt=aid, score=round(champ.score, 6))
        incumbent = self.service.engine
        inc_spec = self._incumbent_spec(incumbent)
        gain = champ.score - inc_spec.score
        if gain < self.cfg.min_score_gain or gain <= 0:
            return self._reject(
                aid, path,
                f"fitness: candidate {champ.score:.4f} vs incumbent "
                f"{inc_spec.score:.4f} (gain {gain:+.4f} < "
                f"required {max(self.cfg.min_score_gain, 0):g})")
        t0 = time.perf_counter()
        try:
            self.faults.maybe_eval_error()
            with obs.span("build", attempt=aid), \
                    telemetry.capture_scope(SHADOW_SCOPE):
                shadow, engine_kind = self._build_shadow(champ, incumbent,
                                                         aid, path)
        except KillSwitch:
            raise
        except Exception as e:  # device eval / transpile / OOM — degrade
            return self._reject(aid, path,
                                f"build_failed: {type(e).__name__}: {e}")
        self._transition(aid, "SHADOW", champion=path,
                         engine_kind=engine_kind)
        # overlap the host-side transpile with the shadow replay: by the
        # time the gate passes, the commit swap lowers from a warm cache
        # entry (the swap's vm_swap event records transpile_overlapped)
        if engine_kind == "vm" and hasattr(self.service.engine,
                                           "begin_overlapped_transpile"):
            self.service.engine.begin_overlapped_transpile(champ)
        try:
            with obs.span("shadow", attempt=aid), \
                    telemetry.capture_scope(SHADOW_SCOPE):
                verdict = self._shadow_eval(
                    shadow, incumbent,
                    exact_reference=(engine_kind != "vm"))
        except KillSwitch:
            raise
        except Exception as e:
            return self._reject(aid, path,
                                f"shadow_eval_failed: "
                                f"{type(e).__name__}: {e}")
        verdict["shadow_seconds"] = round(time.perf_counter() - t0, 3)
        self.last_shadow = verdict
        if verdict["failures"]:
            return self._reject(aid, path, "; ".join(verdict["failures"]),
                                shadow=_strip(verdict))
        # commit point: PROMOTED lands in the log BEFORE the flip — a
        # kill between the two resolves to the new champion on restart
        self._transition(aid, "PROMOTED", champion=path,
                         previous=inc_spec.source,
                         engine_kind=engine_kind, shadow=_strip(verdict))
        t1 = time.perf_counter()
        old = self._commit_swap(champ, shadow, engine_kind)
        self.last_swap_ms = round((time.perf_counter() - t1) * 1e3, 3)
        trace_ctx.emit(self.recorder, "promotion/swap",
                       self.last_swap_ms / 1e3, attempt=aid,
                       engine_kind=engine_kind)
        self._done.add(aid)
        self._probation = {"attempt": aid, "champion": path,
                           "old_engine": old,
                           "mark": self.service.requests_served,
                           "t0": time.monotonic()}
        self.recorder.metric("promotion_event", attempt=aid,
                             state="SWAPPED", champion=path,
                             swap_ms=self.last_swap_ms,
                             engine_kind=engine_kind)
        return {"action": "promoted", "attempt": aid, "champion": path,
                "swap_ms": self.last_swap_ms, "engine_kind": engine_kind,
                "shadow": _strip(verdict)}

    def _incumbent_spec(self, incumbent) -> ChampionSpec:
        """The ChampionSpec a candidate competes against — the engine's
        resident champion here; the FleetController narrows it to ONE
        slot's champion."""
        return incumbent.champion

    def _commit_swap(self, champ: ChampionSpec, shadow, engine_kind: str):
        """The swap itself, returning the rollback handle: the VM fast
        path copies the candidate's tables INTO the resident engine's
        graphs (``swap_engine`` dispatches on ChampionSpec — no graph was
        ever captured on this path); the AOT path flips to the prebuilt
        shadow engine. The FleetController overrides this (and
        ``_restore``) with a per-slot table copy."""
        return self.service.swap_engine(
            champ if engine_kind == "vm" else shadow)

    def _restore(self, old) -> None:
        """Invert ``_commit_swap`` with its rollback handle."""
        self.service.swap_engine(old)

    def _build_shadow(self, champ: ChampionSpec, incumbent, aid: str,
                      path: str):
        """The candidate's shadow engine plus how the swap will bind it.

        VM fast path: an incumbent exposing ``shadow_for`` (the VM-native
        engine) lowers the candidate into a shadow VIEW sharing the warm
        champion-agnostic graphs — zero captures. ``VMUnsupported``
        (candidate outside the VM vocabulary, or longer than the resident
        capacity bucket) records a fallback ``vm_swap`` event and degrades
        to the AOT build; any other failure propagates to the caller's
        build_failed reject."""
        if hasattr(incumbent, "shadow_for"):
            try:
                return incumbent.shadow_for(champ), "vm"
            except VMUnsupported as e:
                self.recorder.event(
                    "vm_swap", outcome="fallback", champion=path,
                    attempt=aid, detail=f"{type(e).__name__}: {e}")
        return self._factory(champ), "aot"

    # ----------------------------------------------------- shadow eval

    def _shadow_eval(self, shadow, incumbent,
                     exact_reference: bool = True) -> Dict[str, Any]:
        """Replay recent live traffic through the candidate, gate on
        parity / p99-vs-incumbent / SLO burn / robust suite.

        ``exact_reference=False`` (the VM fast path) skips the per-query
        unbatched exact reference: its own graphs would be captured on
        the serving process, defeating the zero-capture swap. VM-vs-AOT
        score parity is held offline instead (the port's VM serving
        tests); the replay still gates latency, SLO burn and the robust
        suite."""
        cfg = self.cfg
        queries = self.service.recent_queries(cfg.shadow_queries)
        if not queries:
            queries = self._synthetic_queries(incumbent, cfg.shadow_queries)
        failures: List[str] = []
        sentinel = ParitySentinel(None, tol=cfg.parity_tol,
                                  recorder=self.recorder)
        delay = self.faults.shadow_delay_s()
        lat, inc_lat = [], []
        for i, q in enumerate(queries):
            # each clock starts inside the incumbent's batch turn (module
            # docstring): no wait behind a live batch on either side
            with incumbent.exclusive():
                t0 = time.perf_counter()
                ans = shadow.answer_batch([q])[0]
                lat.append((time.perf_counter() - t0 + delay) * 1e3)
            if exact_reference:
                ref = shadow.reference_answer(q)
                sentinel.audit_served(
                    f"shadow-{i}", ans["score"], ref["score"],
                    placements_match=ans["placements"] == ref["placements"],
                    source="shadow")
            with incumbent.exclusive():
                t0 = time.perf_counter()
                incumbent.answer_batch([q])
                inc_lat.append((time.perf_counter() - t0) * 1e3)
        if sentinel.alerts:
            failures.append(
                f"parity: {sentinel.alerts}/{len(queries)} replayed answers "
                f"drifted > {cfg.parity_tol:g} from the exact reference")
        p99 = float(np.percentile(lat, 99)) if lat else 0.0
        inc_p99 = float(np.percentile(inc_lat, 99)) if inc_lat else 0.0
        if inc_p99 > 0 and p99 > cfg.max_p99_regression * inc_p99:
            failures.append(
                f"latency: shadow p99 {p99:.1f}ms > "
                f"{cfg.max_p99_regression:g}x incumbent p99 {inc_p99:.1f}ms")
        if cfg.slo.enabled and lat:
            burning = [b for b in slo_burn(cfg.slo, lat, sum(lat) / 1e3)
                       if b["slo"] == "p99_ms" and b["burn_rate"] > 1.0]
            if burning:
                failures.append(
                    f"slo: shadow replay burns "
                    f"{burning[0]['burn_rate']:.1f}x the p99 error budget")
        robust = inc_robust = None
        if cfg.suite:
            robust, inc_robust = self._robust_scores(shadow, incumbent)
            if robust < inc_robust:
                failures.append(
                    f"robust: suite {cfg.suite} score {robust:.4f} < "
                    f"incumbent {inc_robust:.4f}")
        return {"failures": failures, "queries": len(queries),
                "p99_ms": round(p99, 3), "incumbent_p99_ms": round(inc_p99, 3),
                "parity_alerts": sentinel.alerts,
                "parity_mode": ("exact_reference" if exact_reference
                                else "offline"),
                "robust": robust, "incumbent_robust": inc_robust}

    def _robust_scores(self, shadow, incumbent):
        """Robust scenario-suite gate: the candidate must not lose ground
        on the whole suite (one batched eval per engine, on the engine's
        device)."""
        from fks_tpu_torch.scenarios import (
            RobustConfig, aggregate, get_suite, make_suite_eval,
        )
        from fks_tpu_torch.sim.types import map_tensors

        suite = get_suite(self.cfg.suite, self._workload(incumbent))
        rc = RobustConfig(aggregation=self.cfg.robust_aggregation)
        out = []
        for eng in (shadow, incumbent):
            dev = eng.device
            ev = make_suite_eval(suite, param_policy=eng.param_policy,
                                 engine=eng.engine_name, device=dev)
            res = ev(map_tensors(lambda x: x.to(dev), eng.params))
            out.append(float(aggregate(res.policy_score, rc)))
        return out[0], out[1]

    def _workload(self, engine):
        if self.workload is not None:
            return self.workload
        from fks_tpu_torch.data.entities import Workload
        from fks_tpu_torch.serve.artifact import _pods_from_dicts
        return Workload(cluster=engine.cluster.to("cpu"),
                        pods=_pods_from_dicts(engine.base_pods))

    def _synthetic_queries(self, engine, n: int) -> List[List[dict]]:
        """No live traffic yet (fresh service): slide windows over the
        engine's base pods, like ``serve --selftest`` does."""
        base = engine.base_pods
        per = max(1, min(3, engine.envelope.max_pods, len(base)))
        return [[dict(base[(i + j) % len(base)]) for j in range(per)]
                for i in range(n)]

    # ------------------------------------------------------- probation

    def check_probation(self) -> Optional[Dict[str, Any]]:
        """Price SLO burn on post-swap live latencies; roll back on a
        burn, release the probation after ``probation_requests``."""
        p = self._probation
        if p is None:
            return None
        served = self.service.requests_served - p["mark"]
        if served <= 0:
            return None
        if self.cfg.slo.enabled:
            lat = self.service.latencies_since(p["mark"])
            elapsed = max(1e-9, time.monotonic() - p["t0"])
            burning = [b for b in slo_burn(self.cfg.slo, lat, elapsed)
                       if b["burn_rate"] > 1.0]
            if burning:
                return self._rollback(p, burning)
        if served >= self.cfg.probation_requests:
            self._probation = None
            self.recorder.metric("promotion_event", attempt=p["attempt"],
                                 state="PROBATION_PASSED",
                                 champion=p["champion"], requests=served)
            return {"action": "probation_passed", "attempt": p["attempt"],
                    "requests": served}
        return None

    def _rollback(self, p: Dict[str, Any],
                  burning: List[dict]) -> Dict[str, Any]:
        aid = p["attempt"]
        burn = {k: burning[0][k] for k in ("slo", "burn_rate", "observed")
                if k in burning[0]}
        # log first (the durable commit), then flip back
        self._transition(aid, "ROLLED_BACK", champion=p["champion"],
                         reason="slo_burn", burn=burn)
        self._restore(p["old_engine"])
        self.recorder.event("rollback", attempt=aid, reason="slo_burn",
                            champion=p["champion"], **burn)
        self._probation = None
        return {"action": "rolled_back", "attempt": aid,
                "champion": p["champion"], "burn": burn}

    # --------------------------------------------------------- helpers

    def _build_engine(self, champ: ChampionSpec):
        """Default factory: the incumbent's serving knobs, placement and
        mesh, fully warmed off the request path (every bucket x lane
        captured here, so the swap itself captures nothing)."""
        inc = self.service.engine
        eng = ServeEngine(champ, self._workload(inc), envelope=inc.envelope,
                          engine=inc.engine_name,
                          prefilter_k=inc.prefilter_k,
                          state_pack=inc.state_pack,
                          max_steps_factor=inc.max_steps_factor,
                          mesh=inc.mesh, recorder=self.recorder,
                          device=inc.device)
        eng.warmup()
        return eng

    def _reject(self, aid: str, path: str, reason: str,
                **extra) -> Dict[str, Any]:
        self._done.add(aid)
        self._transition(aid, "REJECTED", champion=path, reason=reason,
                         **extra)
        return {"action": "rejected", "attempt": aid, "champion": path,
                "reason": reason}

    def _transition(self, aid: str, state: str, **detail) -> None:
        """Durable log append + promotion_event metric, THEN the kill
        hook — a drill kill always lands after the record is on disk.
        An active promotion trace stamps its id onto the metric (the
        durable log keeps its schema untouched)."""
        self.log.append(aid, state, **detail)
        ctx = trace_ctx.current()
        self.recorder.metric("promotion_event", attempt=aid, state=state,
                             **detail,
                             **({"trace_id": ctx.trace_id} if ctx else {}))
        self.faults.maybe_kill(state)


def follow_ledger(controller: PromotionController, interval: float = 5.0,
                  stop: Optional[threading.Event] = None):
    """Run the controller's poll loop on a daemon thread (the
    ``serve --follow-ledger`` engine room). A poll failure is recorded
    and swallowed — supervision must never take serving down."""
    stop = stop or threading.Event()

    def _loop() -> None:
        while not stop.is_set():
            try:
                controller.poll_once()
            except Exception as e:  # noqa: BLE001 — serve must survive
                controller.recorder.event(
                    "alert", source="promotion_poll",
                    detail=f"poll failed: {type(e).__name__}: {e}")
            stop.wait(interval)

    thread = threading.Thread(target=_loop, name="promotion-poll",
                              daemon=True)
    thread.start()
    return stop, thread


def _strip(verdict: Dict[str, Any]) -> Dict[str, Any]:
    """Shadow verdict without the failure list (already in ``reason``)."""
    return {k: v for k, v in verdict.items() if k != "failures"}
