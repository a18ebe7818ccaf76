"""The port's promotion pipeline (``fks_tpu_torch.pipeline``) held against
fks_tpu's.

- ``PromotionLog``: a log either package writes (torn tail included)
  reads the same in the other, the next append repairs it in both, and
  ``attempt_id`` is equal;
- the controller on fks_tpu's synthetic test stack
  (``synthetic_workload(8, 16, seed=0)``, ``score = 1000`` as the
  incumbent, one module-scoped stack per package, the port's on the CPU):
  for the fitness gate, the corrupt champion, the p99 regression that
  ``FaultPlan`` injects, the zero-capture swap (closure and VM engines),
  kill -9 after PENDING / SHADOW / PROMOTED, rollback on burn, probation
  release and the ``follow_ledger`` thread, the sequence of promotion-log
  states and of poll actions is fks_tpu's;
- ``cli pipeline`` prints fks_tpu's status JSON for the same log, and
  ``cli serve --follow-ledger --drain-state`` runs on the CPU.

Both controllers run fks_tpu's default 2x p99 gate, and each controller
module reads a pinned clock (``ReplayClock``), so every replayed query
times 1 ms plus the pad that ``FaultPlan`` injects, whatever the host's
load.
"""
import dataclasses
import json
import os
import threading
import time

import pytest

import fks_tpu.cli as fk_cli
import fks_tpu.obs as fk_obs
import fks_tpu.obs.history as fk_history
import fks_tpu.pipeline as fk_pipeline
import fks_tpu.pipeline.controller as fk_controller
import fks_tpu.serve as fk_serve
import fks_tpu_torch.cli as pt_cli
import fks_tpu_torch.obs as pt_obs
import fks_tpu_torch.obs.history as pt_history
import fks_tpu_torch.pipeline as pt_pipeline
import fks_tpu_torch.pipeline.controller as pt_controller
import fks_tpu_torch.serve as pt_serve
from fks_tpu.data.synthetic import synthetic_workload as fk_synthetic
from fks_tpu.funsearch import template as fk_template
from fks_tpu_torch.data.synthetic import synthetic_workload as pt_synthetic
from fks_tpu_torch.funsearch import template as pt_template

BETTER_LOGIC = ("score = 1000 + (node.cpu_milli_left - pod.cpu_milli) "
                "/ max(1, node.cpu_milli_total)")


class ReplayClock:
    """A controller module's ``time`` with a pinned ``perf_counter``: each
    reading is 1 ms after the last, so an interval read around one call
    is 1 ms on any host. Everything else is the real ``time``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._now = 0.0

    def perf_counter(self):
        with self._lock:
            self._now += 1e-3
            return self._now

    def advance(self, seconds):
        with self._lock:
            self._now += seconds

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture(autouse=True)
def replay_clock(monkeypatch):
    for mod in (fk_controller, pt_controller):
        monkeypatch.setattr(mod, "time", ReplayClock())


class Side:
    """One package's serving stack: fks_tpu's test_pipeline ``Stack``,
    engines cached per champion code so the module builds each once."""

    def __init__(self, name, pipeline, serve, obs, history, synthetic,
                 template, **engine_kw):
        self.name, self.pipeline, self.serve = name, pipeline, serve
        self.obs, self.history, self.template = obs, history, template
        self.engine_kw = engine_kw
        self.wl = synthetic(8, 16, seed=0)
        self.envelope = serve.ShapeEnvelope(max_pods=8, min_pod_bucket=8,
                                            max_batch=2)
        self._cache = {}
        self.incumbent = self.factory(self.champion("score = 1000", 0.4))
        self._vm = None

    def champion(self, logic, score, source="<test-seed>"):
        return self.serve.ChampionSpec(
            code=self.template.fill_template(logic), score=score,
            source=source)

    def factory(self, champ):
        if champ.code not in self._cache:
            eng = self.serve.ServeEngine(champ, self.wl,
                                         envelope=self.envelope,
                                         **self.engine_kw)
            eng.warmup()
            self._cache[champ.code] = eng
        return self._cache[champ.code]

    def vm_incumbent(self):
        """A fresh VM engine serving the incumbent (a swap rewrites its
        tables, so no two tests share one)."""
        eng = self.serve.VMServeEngine(self.champion("score = 1000", 0.4),
                                       self.wl, envelope=self.envelope,
                                       **self.engine_kw)
        eng.warmup()
        return eng

    def service(self, engine=None, **kw):
        return self.serve.ServeService(engine or self.incumbent,
                                       max_wait_s=0.002, **kw)

    def traffic(self, service, n=3, pods=3):
        base = service.engine.base_pods
        futs = [service.submit(
            {"pods": [dict(base[(i + j) % len(base)]) for j in range(pods)]})
            for i in range(n)]
        return [f.result(timeout=300) for f in futs]

    def ctrl(self, service, tmp, *, faults=None, factory=None, **over):
        cfg = self.pipeline.PromotionConfig(shadow_queries=2, **over)
        return self.pipeline.PromotionController(
            service, self.wl, ledger_dir=str(tmp),
            log_path=os.path.join(str(tmp), "promotion.jsonl"), config=cfg,
            faults=faults, engine_factory=factory or self.factory)

    def better(self, tmp, score=0.9):
        return self.pipeline.write_champion(
            str(tmp), self.template.fill_template(BETTER_LOGIC), score)


@pytest.fixture(scope="module")
def sides():
    return [
        Side("fks_tpu", fk_pipeline, fk_serve, fk_obs, fk_history,
             fk_synthetic, fk_template),
        Side("port", pt_pipeline, pt_serve, pt_obs, pt_history,
             pt_synthetic, pt_template, device="cpu"),
    ]


def states(ctrl):
    return [r["state"] for r in ctrl.log.records]


def both(sides, tmp_path, case):
    """Run ``case(side, tmp)`` on each package; its traces must agree."""
    traces = [case(s, tmp_path / s.name) for s in sides]
    assert traces[0] == traces[1], traces
    return traces[1]


# -------------------------------------------------------- promotion log


def test_promotion_log_crosses_both_ways_torn_tail_included(tmp_path):
    for write, read in ((fk_pipeline, pt_pipeline),
                        (pt_pipeline, fk_pipeline)):
        path = tmp_path / f"{write.__name__}.jsonl"
        log = write.PromotionLog(path)
        log.append("a1", "PENDING", champion="c.json")
        log.append("a1", "SHADOW", champion="c.json", engine_kind="vm")
        log.append("a2", "PENDING", champion="d.json")
        log.append("a2", "REJECTED", champion="d.json", reason="fitness")
        with open(path, "a") as f:  # kill -9 mid-append
            f.write('{"ts": 1, "attempt": "a1", "state": "PROMO')
        theirs = read.PromotionLog(path)
        ours = write.PromotionLog(path)
        assert theirs.summary() == ours.summary()
        assert theirs.skipped_lines == 1
        assert theirs.interrupted() == ["a1"]
        with pytest.raises(ValueError, match="illegal"):
            theirs.append("a2", "PENDING")  # terminal states are closed
        theirs.append("a1", "PROMOTED", champion="c.json")  # repairs
        again = write.PromotionLog(path)
        assert again.state_of("a1") == "PROMOTED"
        assert again.active()["attempt"] == "a1"
        assert again.skipped_lines == 1
        assert again.records == read.PromotionLog(path).records


def test_attempt_id_and_champion_files_equal(tmp_path):
    paths = [p.write_champion(str(tmp_path / p.__name__), "code-a", 0.5,
                              name="a") for p in (fk_pipeline, pt_pipeline)]
    assert open(paths[0]).read() == open(paths[1]).read()
    assert fk_pipeline.attempt_id(paths[0]) == \
        pt_pipeline.attempt_id(paths[1]) == pt_pipeline.attempt_id(paths[0])
    torn = [p.write_corrupt_champion(str(tmp_path / f"c{i}"))
            for i, p in enumerate((fk_pipeline, pt_pipeline))]
    assert open(torn[0]).read() == open(torn[1]).read()
    assert os.path.basename(torn[0]) == os.path.basename(torn[1])


# ------------------------------------------------------ gates + rejects


def test_fitness_gate_rejects_before_any_device_work(sides, tmp_path):
    def case(side, tmp):
        service = side.service()
        built = []
        try:
            side.better(tmp, score=0.1)  # worse than the incumbent's 0.4
            ctrl = side.ctrl(service, tmp,
                             factory=lambda c: built.append(c))
            out = ctrl.poll_once()
            again = ctrl.poll_once()["action"]
            return (states(ctrl), out["action"], out["reason"], built,
                    again)
        finally:
            service.close()

    st, action, reason, built, again = both(sides, tmp_path, case)
    assert st == ["PENDING", "REJECTED"] and action == "rejected"
    assert reason.startswith("fitness") and not built and again == "idle"


def test_corrupt_champion_rejected_serving_survives(sides, tmp_path):
    def case(side, tmp):
        service = side.service()
        try:
            path = side.pipeline.write_corrupt_champion(str(tmp))
            ctrl = side.ctrl(service, tmp)
            out = ctrl.poll_once(path)
            answers = side.traffic(service, 2)
            return (states(ctrl), out["action"],
                    out["reason"].split(":")[0], len(answers))
        finally:
            service.close()

    assert both(sides, tmp_path, case) == (
        ["PENDING", "REJECTED"], "rejected", "load_failed", 2)


def test_p99_regression_rejected_at_shadow(sides, tmp_path):
    def case(side, tmp):
        service = side.service()
        try:
            side.traffic(service, 3)
            side.better(tmp)
            ctrl = side.ctrl(
                service, tmp,
                faults=side.pipeline.FaultPlan(shadow_latency_ms=400.0),
                max_p99_regression=1.5,
                slo=side.history.SLOConfig(p99_ms=50.0))
            out = ctrl.poll_once()
            gates = [g.split(":")[0].strip()
                     for g in out["reason"].split(";")]
            return (states(ctrl), out["action"], gates,
                    service.engine is side.incumbent, service.swaps)
        finally:
            service.close()

    assert both(sides, tmp_path, case) == (
        ["PENDING", "SHADOW", "REJECTED"], "rejected", ["latency", "slo"],
        True, 0)


@pytest.mark.parametrize("pad_ms", [0.0, 5.0])
def test_replays_are_timed_inside_the_incumbents_turn(sides, tmp_path,
                                                      pad_ms):
    """A live client holds the incumbent's batch turn back to back while
    the port's controller replays through the AOT path, and each live
    batch moves the controller's pinned clock on by 10 s: a replay timed
    from before its turn would read that wait. Both the shadow's and the
    incumbent's replays read 1 ms (plus the shadow's pad): the clocks
    start inside the turn. A shadow padded past the 2x gate is still
    rejected on latency."""
    side = sides[1]
    clock = pt_controller.time
    service = side.service()
    stop = threading.Event()

    def live():
        while not stop.is_set():
            with side.incumbent.exclusive():
                time.sleep(0.02)
                clock.advance(10.0)

    try:
        side.traffic(service, 2)
        side.better(tmp_path)
        ctrl = side.ctrl(service, tmp_path, faults=pt_pipeline.FaultPlan(
            shadow_latency_ms=pad_ms))
        client = threading.Thread(target=live)
        client.start()
        try:
            out = ctrl.poll_once()
        finally:
            stop.set()
            client.join()
    finally:
        service.close()
    verdict = ctrl.last_shadow
    assert verdict["queries"] == 2
    assert verdict["incumbent_p99_ms"] == pytest.approx(1.0), verdict
    assert verdict["p99_ms"] == pytest.approx(1.0 + pad_ms), verdict
    if pad_ms:
        assert out["action"] == "rejected", out
        assert out["reason"].startswith("latency"), out
    else:
        assert out["action"] == "promoted", out


# --------------------------------------------------------- the hot swap


@pytest.mark.parametrize("kind", ["aot", "vm"])
def test_promotion_hot_swap_captures_nothing(sides, tmp_path, kind):
    def case(side, tmp):
        engine = side.vm_incumbent() if kind == "vm" else None
        service = side.service(engine)
        try:
            side.traffic(service, 3)
            side.better(tmp)
            ctrl = side.ctrl(service, tmp)
            watcher = side.obs.CompileWatcher().install()
            try:
                out = ctrl.poll_once()
                swap_compiles = watcher.backend_compile_count
                answers = side.traffic(service, 4)
                warm = watcher.backend_compile_count - swap_compiles
            finally:
                watcher.uninstall()
            shadow = out["shadow"]
            return (states(ctrl), out["action"], out["engine_kind"],
                    shadow["parity_mode"], shadow["parity_alerts"],
                    shadow["queries"], service.swaps,
                    service.engine.champion.score, len(answers),
                    warm, swap_compiles if kind == "vm" else None,
                    ctrl.poll_once()["action"])
        finally:
            service.close()

    got = both(sides, tmp_path, case)
    assert got[:3] == (["PENDING", "SHADOW", "PROMOTED"], "promoted", kind)
    # the promoted engine was warm: post-swap traffic compiles / captures
    # nothing (on the CPU the port captures no graph at all; the card's
    # count is chip_smoke.py phase 14's)
    assert got[9] == 0 and got[-1] == "idle"


@pytest.mark.parametrize("state", ["PENDING", "SHADOW", "PROMOTED"])
def test_kill_and_recover(sides, tmp_path, state):
    def case(side, tmp):
        service = side.service()
        try:
            cand = side.better(tmp)
            ctrl = side.ctrl(
                service, tmp,
                faults=side.pipeline.FaultPlan(kill_after_state=state))
            with pytest.raises(side.pipeline.KillSwitch):
                ctrl.poll_once()
            survived = len(side.traffic(service, 2))
            service2 = side.service()
            try:
                ctrl2 = side.ctrl(service2, tmp)
                rec = ctrl2.recover()
                out = ctrl2.poll_once()
                return (states(ctrl), states(ctrl2), survived,
                        rec["active"] is not None, len(rec["interrupted"]),
                        ctrl2.active_champion() == cand, out["action"],
                        service2.engine.champion.score)
            finally:
                service2.close()
        finally:
            service.close()

    got = both(sides, tmp_path, case)
    if state == "PROMOTED":
        assert got[3] and got[5] and got[6] == "idle"
    else:
        assert got[4] == 1 and got[6] == "promoted" and got[7] == 0.9


# ------------------------------------------------------------ probation


def test_rollback_on_burn(sides, tmp_path):
    def case(side, tmp):
        service = side.service()
        try:
            side.traffic(service, 2)
            side.better(tmp)
            ctrl = side.ctrl(service, tmp, probation_requests=32)
            first = ctrl.poll_once()["action"]
            # production degrades after the swap: every request now
            # misses the (retroactively impossible) p99 target
            ctrl.cfg = dataclasses.replace(
                ctrl.cfg, slo=side.history.SLOConfig(p99_ms=1e-6))
            side.traffic(service, 3)
            out = ctrl.check_probation()
            return (states(ctrl), first, out["action"],
                    sorted(out["burn"]), service.engine is side.incumbent,
                    ctrl.poll_once()["action"])
        finally:
            service.close()

    got = both(sides, tmp_path, case)
    assert got[0][-1] == "ROLLED_BACK" and got[2] == "rolled_back"
    assert got[4] and got[5] == "idle"


def test_rollback_recorded_in_the_run_dir(sides, tmp_path):
    """The port's recorded promotion passes fks_tpu's schema checker and
    holds fks_tpu's promotion_event states and rollback event."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    try:
        import check_jsonl_schema as cjs
    finally:
        sys.path.pop(0)

    def case(side, tmp):
        rec = side.obs.FlightRecorder(str(tmp / "run"))
        service = side.service(recorder=rec)
        try:
            with side.obs.recording(rec):
                side.traffic(service, 2)
                side.better(tmp / "ledger")
                ctrl = side.pipeline.PromotionController(
                    service, side.wl, ledger_dir=str(tmp / "ledger"),
                    config=side.pipeline.PromotionConfig(
                        shadow_queries=2, probation_requests=32),
                    recorder=rec, engine_factory=side.factory)
                ctrl.poll_once()
                ctrl.cfg = dataclasses.replace(
                    ctrl.cfg, slo=side.history.SLOConfig(p99_ms=1e-6))
                side.traffic(service, 3)
                ctrl.check_probation()
        finally:
            service.close()
        cjs.check_run_dir(str(tmp / "run"))
        rows = [json.loads(ln) for ln in
                (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
        events = [json.loads(ln) for ln in
                  (tmp / "run" / "events.jsonl").read_text().splitlines()]
        return ([m["state"] for m in rows
                 if m["kind"] == "promotion_event"],
                sorted({m["kind"] for m in rows}),
                [e["reason"] for e in events if e["kind"] == "rollback"])

    got = both(sides, tmp_path, case)
    assert got[0] == ["PENDING", "SHADOW", "PROMOTED", "SWAPPED",
                      "ROLLED_BACK"]
    assert got[2] == ["slo_burn"]


def test_probation_release(sides, tmp_path):
    def case(side, tmp):
        service = side.service()
        try:
            side.traffic(service, 2)
            side.better(tmp)
            ctrl = side.ctrl(service, tmp, probation_requests=2,
                             slo=side.history.SLOConfig(p99_ms=1e9))
            first = ctrl.poll_once()["action"]
            side.traffic(service, 3)
            out = ctrl.check_probation()
            return (states(ctrl), first, out["action"], out["requests"],
                    ctrl.check_probation())
        finally:
            service.close()

    got = both(sides, tmp_path, case)
    assert got[1:] == ("promoted", "probation_passed", 3, None)


# -------------------------------------------------- follow-ledger + CLI


def test_follow_ledger_thread_promotes(sides, tmp_path):
    def case(side, tmp):
        service = side.service()
        try:
            ctrl = side.ctrl(service, tmp)
            stop, thread = side.pipeline.follow_ledger(ctrl, interval=0.05)
            try:
                side.better(tmp)
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline and service.swaps == 0:
                    time.sleep(0.05)
            finally:
                stop.set()
                thread.join(timeout=30)
            return (states(ctrl), service.swaps,
                    service.engine.champion.score, thread.is_alive())
        finally:
            service.close()

    assert both(sides, tmp_path, case) == (
        ["PENDING", "SHADOW", "PROMOTED"], 1, 0.9, False)


def test_cli_pipeline_status_prints_fks_tpu_json(tmp_path, capsys):
    log = pt_pipeline.PromotionLog(tmp_path / "promotion.jsonl")
    log.append("abc", "PENDING", champion="c.json")
    log.append("abc", "SHADOW", champion="c.json")
    log.append("def", "PENDING", champion="d.json")
    log.append("def", "SHADOW", champion="d.json")
    log.append("def", "PROMOTED", champion="d.json")
    with open(log.path, "a") as f:
        f.write('{"attempt": "x"')
    out = []
    for cli in (fk_cli, pt_cli):
        assert cli.main(["pipeline", "--cpu", "--ledger-dir",
                         str(tmp_path)]) == 0
        out.append(json.loads(capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[1]["attempts"] == {"abc": "SHADOW", "def": "PROMOTED"}
    assert out[1]["interrupted"] == ["abc"]
    assert out[1]["active"]["attempt"] == "def"
    assert out[1]["skipped_lines"] == 1


def test_cli_serve_follow_ledger_and_drain_state(tmp_path, capsys):
    """``serve --follow-ledger --drain-state`` on the CPU: the ledger's
    champion is served, the up-front poll decides it (no gain over
    itself), the queries are answered, the drain persists a state that
    the next start preloads, and the run directory passes the schema."""
    import shutil
    import sys

    from fks_tpu_torch.resilience import load_serve_state
    from fks_tpu_torch.serve import pods_to_dicts
    from fks_tpu_torch.data import TraceParser

    ledger = tmp_path / "ledger"
    ledger.mkdir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "policies", "discovered",
                       "funsearch_20260801_023751_score0.5268.json")
    shutil.copy(src, ledger)
    base = pods_to_dicts(TraceParser().parse_workload(max_pods=16).pods)
    queries = tmp_path / "q.jsonl"
    queries.write_text("".join(
        json.dumps({"id": f"q{i}", "pods": base[i:i + 4]}) + "\n"
        for i in range(3)))
    state = tmp_path / "state.json"
    args = ["serve", "--cpu", "--serve-engine", "vm", "--max-pods", "16",
            "--max-batch", "2", "--ledger-dir", str(ledger),
            "--follow-ledger", "--promote-interval", "0.05",
            "--drain-state", str(state), "--queries", str(queries)]
    assert pt_cli.main(args + ["--run-dir", str(tmp_path / "run")]) == 0
    answers = [json.loads(ln) for ln in
               capsys.readouterr().out.splitlines()]
    assert [a["id"] for a in answers] == ["q0", "q1", "q2"]
    saved = load_serve_state(str(state))
    assert saved["requests_served"] == 3 and len(saved["replay"]) == 3
    log = pt_pipeline.PromotionLog(ledger / "promotion.jsonl")
    assert list(log.states().values()) == ["REJECTED"]
    sys.path.insert(0, os.path.join(root, "tools"))
    try:
        import check_jsonl_schema as cjs
    finally:
        sys.path.pop(0)
    counts = cjs.check_run_dir(str(tmp_path / "run"))
    assert counts["metrics.jsonl"] > 0
    # the next start preloads the persisted replay buffer
    assert pt_cli.main(args) == 0
    assert "replay buffer preloaded: 3 queries" in capsys.readouterr().err
