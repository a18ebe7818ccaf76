"""The port's serve-tier resilience (deadlines, admission control, the
request batcher, degraded mode) against fks_tpu's, on the CPU.

The units run the same script through both packages (``pkg``
parametrization) and compare what comes out: typed errors and their JSON
bodies, shed decisions and Retry-After hints, the batcher's counters. The
degraded-mode flows inject the same fault (a ``NaNFlood`` from an engine
proxy, fks_tpu's fault vocabulary) into a service of each package and
compare the manager's state after every request and the ``degraded``
events it records.
"""
import dataclasses
import threading
import time

import pytest

import fks_tpu.resilience as jax_res
import fks_tpu.serve as jax_serve
import fks_tpu_torch.resilience as res
import fks_tpu_torch.serve as serve
from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.funsearch import template as jax_template
from fks_tpu_torch.testing import one_torch_thread, port_workload

PKGS = {"port": (res, serve), "fks_tpu": (jax_res, jax_serve)}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def both(fn):
    """``fn(res, serve)`` in each package; returns (port, fks_tpu)."""
    return tuple(fn(*PKGS[k]) for k in ("port", "fks_tpu"))


# ------------------------------------------------------- deadline units


def test_deadline_from_query_and_errors_match():
    def run(r, _s):
        d = r.Deadline.from_query({"deadline_ms": 5000}, default_s=1.0)
        none = r.Deadline.from_query({}, default_s=0.0)
        dflt = r.Deadline.from_query({"x": 1}, default_s=2.0)
        past = r.Deadline.after(-1.0)
        errs = [r.ShedError("full", retry_after_s=0.123456,
                            reason="queue_full", trace_id="t1").to_json(),
                r.DeadlineExceeded("late").to_json(),
                r.ResilienceError("x").to_json()]
        return (4.9 < d.remaining() <= 5.0, none is None,
                1.9 < dflt.remaining() <= 2.0, past.expired(),
                r.Deadline.never().expired(), errs,
                [c.http_status for c in (r.ShedError, r.DeadlineExceeded)])
    got, want = both(run)
    assert got == want and got[0] and got[3] and not got[4]


def test_admission_decisions_match():
    """The same admit/note/release script: the same shed decisions,
    reasons, Retry-After hints, counters and EWMA."""
    def run(r, _s):
        out = []
        ctl = r.AdmissionController(r.AdmissionConfig(max_queue=2,
                                                      ewma_alpha=0.5))
        ctl.service_time_for = lambda t: 0.5 if t == "slow" else None
        for step in range(6):
            try:
                ctl.admit(r.Deadline.after(60.0) if step % 2 else None,
                          tenant="slow" if step == 3 else None)
                out.append(("ok", ctl.depth))
            except r.ShedError as e:
                out.append((e.reason, round(e.retry_after_s, 6)))
            if step == 1:
                ctl.note_batch(2, 0.2)
            if step == 2:
                ctl.release(1)
        ctl.note_batch(1, 0.3)
        try:
            ctl.admit(r.Deadline.after(0.001))
        except r.ShedError as e:
            out.append((e.reason, str(e)[:24]))
        ctl.note_expired(2)
        out.append((ctl.shed_queue_full, ctl.shed_deadline, ctl.expired,
                    round(ctl.shed_rate, 6), round(ctl.projected_wait_s(), 6),
                    round(ctl.retry_after_s(), 6)))
        return out
    got, want = both(run)
    assert got == want


# -------------------------------------------------------- batcher units


def _gated(s, **kw):
    """A batcher whose worker parks inside its first batch until
    released — the deterministic way to hold requests in the queue."""
    gate, entered = threading.Event(), threading.Event()

    def handler(queries, enq):
        entered.set()
        if not gate.wait(30):
            raise RuntimeError("test gate never released")
        return list(queries)

    return s.RequestBatcher(handler, max_wait_s=0.0, **kw), gate, entered


def test_batcher_coalesces_and_flushes_on_max_wait():
    def run(_r, s):
        batches = []

        def handler(queries, _enq):
            batches.append(list(queries))
            return [q * 10 for q in queries]

        b = s.RequestBatcher(handler, max_batch=3, max_wait_s=0.2)
        full = [f.result(5) for f in [b.submit(i) for i in (1, 2, 3)]]
        b.close()
        b2 = s.RequestBatcher(lambda qs, enq: list(qs), max_batch=8,
                              max_wait_s=0.01)
        lonely = b2.submit("lonely").result(5)  # flushed by max_wait
        b2.close()
        return (full, batches, b.submitted, b.batches, b.mean_occupancy,
                lonely, b2.batches)
    got, want = both(run)
    assert got == want == ([10, 20, 30], [[1, 2, 3]], 3, 1, 1.0, "lonely",
                           1)


def test_batcher_failure_paths_match():
    """Short answer lists, handler exceptions, pre-expired deadlines,
    closed batchers: the same typed outcomes in both packages."""
    def run(r, s):
        out = []
        b = s.RequestBatcher(lambda qs, enq: list(qs)[:1], max_batch=4,
                             max_wait_s=0.01)
        futs = [b.submit(i) for i in range(3)]
        out.append(futs[0].result(30))
        for f in futs[1:]:
            try:
                f.result(30)
            except r.ResilienceError as e:
                out.append((type(e).__name__, e.reason, str(e)))
        b.close()

        def boom(queries, enq):
            raise ValueError("device fell over")

        b = s.RequestBatcher(boom, max_batch=4, max_wait_s=0.01)
        for f in [b.submit(i) for i in range(2)]:
            with pytest.raises(ValueError, match="fell over"):
                f.result(30)
        out.append(b.completed)
        b.close()
        b = s.RequestBatcher(lambda qs, enq: list(qs), max_batch=2)
        with pytest.raises(r.ShedError) as ei:
            b.submit("x", deadline=r.Deadline.after(-1.0))
        out.append(ei.value.to_json())
        out.append(b.submit("y").result(30))
        b.close()
        with pytest.raises(RuntimeError, match="closed"):
            b.submit("z")
        return out
    got, want = both(run)
    assert got == want


def test_batcher_deadline_expiry_and_shed_bodies_match():
    """A request whose deadline lapses in the queue completes with
    ``DeadlineExceeded``; a bounded queue sheds with a 503 body carrying
    Retry-After; a drained batcher sheds with reason ``draining``."""
    def run(r, s):
        out = []
        b, gate, entered = _gated(s, max_batch=1)
        expired = []
        b._expired_cb = expired.append
        first = b.submit("a")
        assert entered.wait(30)
        deadline = r.Deadline.after(0.02)
        late = b.submit("b", deadline=deadline)
        while not deadline.expired():
            time.sleep(0.001)
        gate.set()
        out.append(first.result(30))
        with pytest.raises(r.DeadlineExceeded) as ei:
            late.result(30)
        out.append((ei.value.to_json(), b.expired, b.admission.expired,
                    expired))
        b.close()
        b, gate, entered = _gated(s, max_batch=1, max_queue=1)
        first = b.submit("a")
        assert entered.wait(30)
        queued = b.submit("b")
        with pytest.raises(r.ShedError) as ei:
            b.submit("c")
        body = ei.value.to_json()
        out.append((body["kind"], ei.value.reason, ei.value.http_status,
                    body["retry_after_s"] >= 0.05))
        gate.set()
        out.append([first.result(30), queued.result(30)])
        b.close()
        b = s.RequestBatcher(lambda qs, enq: list(qs), max_batch=2)
        futs = [b.submit(i) for i in range(3)]
        report = b.drain(grace_s=30.0)
        out.append(({k: v for k, v in report.items()},
                    [f.result(0) for f in futs]))
        with pytest.raises(r.ShedError) as ei:
            b.submit("late")
        out.append((ei.value.reason, b.shed_draining))
        return out
    got, want = both(run)
    assert got == want


# -------------------------------------------------- fault classification


def test_classify_fault_vocabulary_matches():
    class XlaRuntimeError(Exception):  # the name is what is classified
        pass

    class AcceleratorError(Exception):  # PyTorch's CUDA runtime error
        pass

    def run(r, _s):
        return [r.classify_fault(e) for e in (
            r.DeviceFault("lost"), r.NaNFlood("flood"),
            r.EngineBuildError("bad build"), XlaRuntimeError("dead"),
            ValueError("not a device fault"))]
    got, want = both(run)
    assert got == want == ["device_fault", "nan_flood", "engine_build",
                           "xla_runtime", None]
    assert res.classify_fault(AcceleratorError("CUDA error")) == \
        "xla_runtime"


# ------------------------------------------------------------ degraded mode


class Flaky:
    """An engine proxy whose first ``failures`` batches raise the
    package's ``NaNFlood`` (a watchdog-detected device fault)."""

    def __init__(self, engine, exc, failures=1):
        self._engine, self._exc, self.failures = engine, exc, failures

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def answer_batch(self, queries):
        if self.failures > 0:
            self.failures -= 1
            raise self._exc("non-finite scores flooding the engine")
        return self._engine.answer_batch(queries)


class Rec:
    enabled = False

    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))

    def metric(self, *a, **k):
        pass


@pytest.fixture(scope="module")
def stacks():
    """Per package: a flat incumbent and its batch-1 exact fallback on the
    same cluster (fks_tpu's tests/test_resilience.py stack)."""
    jwl = jax_synthetic(8, 16, seed=0)
    code = jax_template.fill_template("score = 1000")
    out = {}
    for key, wl, kw in (("port", port_workload(jwl), {"device": "cpu"}),
                        ("fks_tpu", jwl, {})):
        s = PKGS[key][1]
        champ = s.ChampionSpec(code=code, score=0.5, source="<test-seed>")
        env = s.ShapeEnvelope(max_pods=8, min_pod_bucket=8, max_batch=2)
        out[key] = {
            "incumbent": s.ServeEngine(champ, wl, envelope=env,
                                       engine="flat", **kw),
            "fallback": s.ServeEngine(
                champ, wl, envelope=dataclasses.replace(env, max_batch=1),
                engine="exact", **kw)}
    return out


def _pods(engine, i, n=3):
    base = engine.base_pods
    return [dict(base[(i + j) % len(base)]) for j in range(n)]


def _degrade_run(key, stack, **cfg):
    r, s = PKGS[key]
    rec = Rec()
    service = s.ServeService(Flaky(stack["incumbent"], r.NaNFlood),
                             max_wait_s=0.002, recorder=rec)
    mgr = service.enable_degraded_mode(
        lambda: stack["fallback"],
        rebuild_factory=(lambda: stack["incumbent"]) if cfg.pop(
            "rebuild", False) else None,
        config=r.DegradeConfig(background_rebuild=False, **cfg))
    states, answers = [], []
    try:
        for i in range(4):
            ans = service.submit({"pods": _pods(stack["incumbent"], i)}
                                 ).result(300)
            answers.append((ans["score"], ans["placements"]))
            states.append(dict(mgr.healthz()))
        hz = service.healthz()
    finally:
        service.close()
    events = [(k, {f: v for f, v in e.items() if f != "detail"})
              for k, e in rec.events if k == "degraded"]
    return states, answers, events, hz, service.engine is stack["fallback"]


def test_degraded_flip_under_nan_flood_matches(stacks):
    """The flip: the faulted batch is answered on the exact fallback with
    zero drift from the reference, the manager stays degraded (no
    rebuild factory), and both packages record the same transitions."""
    got = _degrade_run("port", stacks["port"])
    want = _degrade_run("fks_tpu", stacks["fks_tpu"])
    assert got[0] == want[0] and got[2] == want[2]
    assert got[0][0] == {"state": "degraded", "flips": 1, "recoveries": 0,
                         "last_fault": "nan_flood"}
    assert got[3]["engine_state"] == want[3]["engine_state"] == "degraded"
    assert got[4] and want[4]
    ref = stacks["port"]["incumbent"].reference_answer(
        _pods(stacks["port"]["incumbent"], 0))
    assert got[1][0] == (ref["score"], ref["placements"])
    for (a, pa), (b, pb) in zip(got[1], want[1]):
        assert pa == pb and abs(a - b) <= 2e-6


def test_degraded_recovery_through_probation_matches(stacks):
    got = _degrade_run("port", stacks["port"], rebuild=True,
                       probation_requests=1)
    want = _degrade_run("fks_tpu", stacks["fks_tpu"], rebuild=True,
                        probation_requests=1)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[0][-1]["state"] == "normal" and got[0][-1]["recoveries"] == 1
    assert [e["state"] for _, e in got[2]] == ["degraded", "probation",
                                                "normal"]


def test_unclassified_exception_still_raises(stacks):
    stack = stacks["port"]

    class Broken(Flaky):
        def answer_batch(self, queries):
            raise ValueError("a plain bug, not a device fault")

    service = serve.ServeService(Broken(stack["incumbent"], None),
                                 max_wait_s=0.002)
    service.enable_degraded_mode(
        lambda: stack["fallback"],
        config=res.DegradeConfig(background_rebuild=False))
    try:
        fut = service.submit({"pods": _pods(stack["incumbent"], 0)})
        with pytest.raises(ValueError, match="plain bug"):
            fut.result(300)
        assert service.degrade.healthz()["state"] == "normal"
    finally:
        service.close()


def test_degraded_mode_is_off_unless_armed(stacks):
    """Nothing arms degraded mode by default: a device fault fails the
    batch and the service stays on its engine."""
    stack = stacks["port"]
    service = serve.ServeService(Flaky(stack["incumbent"], res.NaNFlood),
                                 max_wait_s=0.002)
    try:
        assert service.degrade is None
        with pytest.raises(res.NaNFlood):
            service.submit({"pods": _pods(stack["incumbent"], 0)}
                           ).result(300)
        assert service.healthz()["engine_state"] == "normal"
    finally:
        service.close()


def test_exact_fallback_factory_builds_a_cpu_exact_engine(stacks):
    stack = stacks["port"]
    inc = stack["incumbent"]
    from fks_tpu_torch.data.entities import Workload

    wl = Workload(cluster=inc._cluster_host, pods=serve.artifact
                  ._pods_from_dicts(inc.base_pods))
    eng = res.exact_fallback_factory(inc.champion, wl, inc.envelope)()
    assert eng.engine_name == "exact" and eng.envelope.max_batch == 1
    assert eng.device.type == "cpu" and eng.cold_compiles > 0
    q = _pods(inc, 2)
    assert eng.answer_batch([q])[0]["placements"] == \
        inc.reference_answer(q)["placements"]
