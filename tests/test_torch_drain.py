"""The port's SIGTERM drain (``resilience.drain``) held against fks_tpu's:
serve-state files cross both ways (the same schema and
``STATE_VERSION``), a torn or unknown-version file is refused by both,
the coordinator's report equals fks_tpu's for the same traffic, a drain
waits for the batch in flight before it completes its Futures, and the
signal path works from the main thread and declines elsewhere.
"""
import os
import signal
import threading

import pytest

import fks_tpu.resilience as fk_res
import fks_tpu.serve as fk_serve
import fks_tpu_torch.resilience as pt_res
import fks_tpu_torch.serve as pt_serve
from fks_tpu.data.synthetic import synthetic_workload as fk_synthetic
from fks_tpu.funsearch import template as fk_template
from fks_tpu_torch.data.synthetic import synthetic_workload as pt_synthetic
from fks_tpu_torch.funsearch import template as pt_template


class Side:
    def __init__(self, name, res, serve, synthetic, template, **kw):
        self.name, self.res, self.serve = name, res, serve
        wl = synthetic(8, 16, seed=0)
        env = serve.ShapeEnvelope(max_pods=8, min_pod_bucket=8, max_batch=2)
        self.engine = serve.ServeEngine(
            serve.ChampionSpec(code=template.fill_template("score = 1000"),
                               score=0.4, source="<seed>"),
            wl, envelope=env, **kw)
        self.engine.warmup()

    def service(self, engine=None):
        return self.serve.ServeService(engine or self.engine,
                                       max_wait_s=0.002)

    def queries(self, n, pods=3):
        base = self.engine.base_pods
        return [{"id": f"d{i}", "pods": [dict(base[(i + j) % len(base)])
                                         for j in range(pods)]}
                for i in range(n)]


@pytest.fixture(scope="module")
def sides():
    return {"fks_tpu": Side("fks_tpu", fk_res, fk_serve, fk_synthetic,
                            fk_template),
            "port": Side("port", pt_res, pt_serve, pt_synthetic,
                         pt_template, device="cpu")}


def served_state(side, path):
    """Answer four queries, then persist the service's state."""
    service = side.service()
    try:
        futs = [service.submit(q) for q in side.queries(4)]
        answers = [f.result(timeout=120) for f in futs]
        side.res.persist_serve_state(service, str(path))
    finally:
        service.close()
    return answers


def test_serve_state_crosses_both_ways(sides, tmp_path):
    states = {}
    for name, side in sides.items():
        served_state(side, tmp_path / f"{name}.json")
        states[name] = {reader: other.res.load_serve_state(
            str(tmp_path / f"{name}.json"))
            for reader, other in sides.items()}
        assert states[name]["fks_tpu"] == states[name]["port"]
    fk, pt = states["fks_tpu"]["port"], states["port"]["fks_tpu"]
    assert fk["version"] == pt["version"] == pt_res.drain.STATE_VERSION
    assert fk["requests_served"] == pt["requests_served"] == 4
    assert fk["replay"] == pt["replay"]
    assert set(fk) == set(pt)
    assert set(fk["summary"]) <= set(pt["summary"])
    # either package's state refills the other's replay buffer
    for name, side in sides.items():
        other = "port" if name == "fks_tpu" else "fks_tpu"
        service = side.service()
        try:
            n = service.preload_replay(states[other][name]["replay"])
            assert n == 4
            assert service.recent_queries(4) == fk["replay"]
        finally:
            service.close()


@pytest.mark.parametrize("body", ['{"version": 1, "replay": [[{"cpu',
                                  '{"version": 2, "replay": []}'])
def test_torn_or_unknown_state_refused_by_both(tmp_path, body):
    path = tmp_path / "state.json"
    path.write_text(body)
    for res in (fk_res, pt_res):
        with pytest.raises(ValueError, match="torn|version"):
            res.load_serve_state(str(path))


def test_drain_report_equals_fks_tpu(sides, tmp_path):
    """One batch in flight and two requests queued behind it when SIGTERM
    lands: the drain completes all three, persists, sheds later submits,
    and reports what fks_tpu's reports."""
    reports = {}
    for name, side in sides.items():
        gated = GatedEngine(side.engine)
        service = side.serve.ServeService(gated, max_wait_s=0.002,
                                          max_batch=1)
        answers = [service.submit(q) for q in side.queries(1)]
        assert gated.entered.wait(60)
        tail = [service.submit(q) for q in side.queries(2, pods=1)]
        dc = side.res.DrainCoordinator(
            service, state_path=str(tmp_path / f"{name}.json"),
            grace_s=30.0)
        threading.Timer(0.2, gated.release.set).start()
        dc.handle_signal()  # the SIGTERM path, invoked directly
        assert all(f.done() and "score" in f.result()
                   for f in answers + tail)
        assert dc.requested and dc.drain() is dc.report  # idempotent
        with pytest.raises(side.res.ShedError):
            service.submit(side.queries(1)[0])  # draining: typed shed
        state = side.res.load_serve_state(str(tmp_path / f"{name}.json"))
        assert state["requests_served"] == 3 and len(state["replay"]) == 3
        reports[name] = {k: v for k, v in dc.report.items()
                         if k not in ("drain_s", "state_path")}
    assert reports["fks_tpu"] == reports["port"]
    assert reports["port"] == {"pending": 2, "completed": 3, "expired": 0,
                               "shed": 0, "stuck": False}


class GatedEngine:
    """A serve engine whose batch stays in flight until released."""

    def __init__(self, inner):
        self._inner = inner
        self.entered, self.release = threading.Event(), threading.Event()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def answer_batch(self, pod_lists):
        self.entered.set()
        assert self.release.wait(60)
        return self._inner.answer_batch(pod_lists)


def test_drain_waits_for_the_batch_in_flight(sides, tmp_path):
    side = sides["port"]
    gated = GatedEngine(side.engine)
    service = side.service(gated)
    futs = [service.submit(q) for q in side.queries(2)]
    assert gated.entered.wait(60)
    dc = pt_res.DrainCoordinator(service, state_path=str(tmp_path / "s"),
                                 grace_s=30.0)
    drainer = threading.Thread(target=dc.handle_signal)
    drainer.start()
    drainer.join(0.2)
    assert drainer.is_alive()  # the drain waits for the batch
    assert not any(f.done() for f in futs)
    gated.release.set()
    drainer.join(60)
    assert not drainer.is_alive()
    assert [f.result()["id"] for f in futs] == ["d0", "d1"]
    assert dc.report["completed"] == 2 and dc.report["stuck"] is False


def test_drain_sheds_what_the_grace_cannot_finish(sides, tmp_path):
    """Past the grace budget the queued requests are shed with a typed
    error (fks_tpu's rule), never left pending."""
    side = sides["port"]
    gated = GatedEngine(side.engine)
    service = pt_serve.ServeService(gated, max_wait_s=0.002, max_batch=1)
    first = service.submit(side.queries(1)[0])
    assert gated.entered.wait(60)
    queued = [service.submit(q) for q in side.queries(2)]
    dc = pt_res.DrainCoordinator(service, grace_s=0.2)
    threading.Timer(0.5, gated.release.set).start()
    report = dc.drain()
    assert first.result(timeout=60)["id"] == "d0"
    for f in queued:
        with pytest.raises(pt_res.ShedError):
            f.result(timeout=60)
    assert report["pending"] == 2


def test_signal_install_main_thread_only(sides, tmp_path):
    side = sides["port"]
    results = {}

    def off_main():
        for name, res in (("fks_tpu", fk_res), ("port", pt_res)):
            dc = res.DrainCoordinator(object())
            results[name] = dc.install()
    t = threading.Thread(target=off_main)
    t.start()
    t.join()
    assert results == {"fks_tpu": False, "port": False}
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("the real-signal half needs the main thread")
    service = side.service()
    called = []
    dc = pt_res.DrainCoordinator(service, state_path=str(tmp_path / "s"))
    dc.add_callback(lambda: called.append(True))
    prev = signal.getsignal(signal.SIGTERM)
    assert dc.install()
    try:
        service.submit(side.queries(1)[0]).result(timeout=60)
        os.kill(os.getpid(), signal.SIGTERM)
        assert dc.requested and called == [True]
        assert pt_res.load_serve_state(str(tmp_path / "s"))[
            "requests_served"] == 1
    finally:
        dc.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
