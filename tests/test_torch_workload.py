"""The port's workload observability (fks_tpu_torch.obs.workload) and SLO
burn (obs.history) against fks_tpu's, on the CPU.

Fingerprint classes, the windowed class mix, tenant accounting rows,
Jain's index, SLO burn records, tenant specs and loadgen summaries are
pure host code: both packages must give the same values on the same
inputs (latency-derived loadgen fields aside). Loadgen also drives the
port's serve stack in process and over HTTP.
"""
import random
import threading
import time

import pytest

import fks_tpu.obs.history as jax_history
import fks_tpu.obs.workload as jax_wl
import fks_tpu_torch.obs.history as history
import fks_tpu_torch.obs.workload as wl
from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu_torch.testing import one_torch_thread, port_workload

PODS = [
    {"cpu_milli": 120, "memory_mib": 512, "creation_time": 0,
     "duration_time": 40},
    {"cpu_milli": 55, "memory_mib": 1024, "creation_time": 1,
     "duration_time": 40},
    {"cpu_milli": 700, "memory_mib": 256, "gpu_milli": 500,
     "creation_time": 2, "duration_time": 80},
]


class RecStub:
    enabled = True

    def __init__(self):
        self.metrics = []

    def metric(self, kind, *a, **fields):
        rec = dict(a[0]) if a and isinstance(a[0], dict) else {}
        rec.update(fields)
        self.metrics.append({"kind": kind, **rec})


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _queries(seed=0, n=40):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        k = rng.randint(1, 70)
        out.append([{"cpu_milli": rng.choice([0, 5, 50, 120, 900, 12000]),
                     "memory_mib": rng.randint(0, 70000),
                     "gpu_milli": rng.choice([0, 0, 250, 1000]),
                     "creation_time": j,
                     "duration_time": rng.choice([1, 40, 600, 10**6])}
                    for j in range(k)])
    return out


def test_tenant_of_matches():
    for q in ({"tenant": "acme"}, {}, {"tenant": ""}, {"tenant": 7},
              "not a dict"):
        assert wl.tenant_of(q) == jax_wl.tenant_of(q)


def test_fingerprint_classes_and_mix_match():
    """Classes (snapshot-table digest included) and the windowed mix
    equal fks_tpu's; classes ignore pod order and key order."""
    fp, jfp = wl.QueryFingerprinter(), jax_wl.QueryFingerprinter()
    for q in _queries():
        assert fp.observe(q) == jfp.observe(q)
    assert fp.classify(PODS) == fp.classify(PODS[::-1]) == \
        fp.classify([dict(reversed(list(p.items()))) for p in PODS])
    assert fp.mix() == jfp.mix()
    rec, jrec = RecStub(), RecStub()
    assert fp.record_mix(rec) == jfp.record_mix(jrec)
    assert rec.metrics == jrec.metrics
    assert fp.record_mix(rec) == {} == jfp.record_mix(jrec)


def test_jain_fairness_and_slo_burn_match():
    for vals in ([10, 10], [10, 0], [], [0, 0], [3, 1, 4, 1, 5]):
        assert wl.jain_fairness(vals) == jax_wl.jain_fairness(vals)
    assert wl.jain_fairness([10, 0]) == 0.5
    lat = [1.0] * 90 + [100.0] * 10
    for kw in (dict(p99_ms=50.0), dict(qps=80.0), dict(p99_ms=50.0,
                                                       qps=200.0),
               dict(), dict(p99_ms=0.5, error_budget=0.05)):
        slo, jslo = history.SLOConfig(**kw), jax_history.SLOConfig(**kw)
        assert slo.enabled == jslo.enabled
        for elapsed in (1.0, 0.0):
            assert history.slo_burn(slo, lat, elapsed) == \
                jax_history.slo_burn(jslo, lat, elapsed)
        rec, jrec = RecStub(), RecStub()
        assert history.record_slo_burn(slo, lat, 1.0, recorder=rec) == \
            jax_history.record_slo_burn(jslo, lat, 1.0, recorder=jrec)
        assert rec.metrics == jrec.metrics
    burn = history.slo_burn(history.SLOConfig(p99_ms=50.0), lat, 1.0)
    assert burn[0]["burn_rate"] == 10.0


def test_accountant_rows_match():
    slo = dict(p99_ms=5.0)
    acc = wl.TenantAccountant(slo=history.SLOConfig(**slo))
    jacc = jax_wl.TenantAccountant(slo=jax_history.SLOConfig(**slo))
    script = [("note_request", "a", 3.0), ("note_request", "a", 9.0),
              ("note_request", "b", 1.0), ("note_shed", "b"),
              ("note_expired", "a"), ("note_request", "c", 2.0),
              ("degraded", "c", 4.0)]
    for a in (acc, jacc):
        for op in script:
            if op[0] == "degraded":
                a.note_request(op[1], op[2], degraded=True)
            else:
                getattr(a, op[0])(*op[1:])
    strip = lambda rows: {t: {k: v for k, v in r.items()  # noqa: E731
                              if k != "goodput_qps"}
                          for t, r in rows.items()}
    assert strip(acc.stats()) == strip(jacc.stats())
    assert acc.tenants() == jacc.tenants() == ["a", "b", "c"]
    assert acc.ewma_service_s("a") == jacc.ewma_service_s("a")
    assert acc.ewma_service_s("nobody") is None
    assert acc.fairness_index() == jacc.fairness_index()
    rec = RecStub()
    acc.record(rec)
    assert [m["tenant"] for m in rec.metrics] == ["a", "b", "c"]


@pytest.mark.parametrize("spec", ["a:closed:2, b:open:25, c:closed:1:5",
                                  "x:open:3.5:9"])
def test_parse_tenant_spec_matches(spec):
    assert [t.__dict__ for t in wl.parse_tenant_spec(spec)] == \
        [t.__dict__ for t in jax_wl.parse_tenant_spec(spec)]


@pytest.mark.parametrize("bad", ["", "a:closed", "a:open:0", "a:closed:0",
                                 "a:zigzag:3"])
def test_parse_tenant_spec_rejects(bad):
    for mod in (wl, jax_wl):
        with pytest.raises(ValueError):
            mod.parse_tenant_spec(bad)


def test_default_make_pods_match():
    load = wl.TenantLoad("a", "closed", concurrency=1, pods_per_query=3)
    jload = jax_wl.TenantLoad("a", "closed", concurrency=1,
                              pods_per_query=3)
    for i in range(6):
        assert wl.default_make_pods(load, i) == \
            jax_wl.default_make_pods(jload, i)
    assert wl.LOADGEN_MODES == jax_wl.LOADGEN_MODES


def test_run_loadgen_fake_send():
    calls = []
    lock = threading.Lock()

    def send(query):
        with lock:
            calls.append(query)
            n = len(calls)
        time.sleep(0.001)
        return {"outcome": "shed"} if n % 5 == 0 else {"outcome": "ok"}

    rec = RecStub()
    out = wl.run_loadgen(send, wl.parse_tenant_spec("a:closed:2,b:open:80"),
                         duration_s=0.25, seed=3, recorder=rec)
    assert out["mode"] == "mixed" and out["tenant_count"] == 2
    assert out["requests"] == out["completed"] + out["shed"] + out["errors"]
    assert out["errors"] == 0 and 0.0 < out["loadgen_shed_rate"] < 1.0
    assert out["tenants"]["b"]["sent"] > 0
    assert all(wl.tenant_of(q) in ("a", "b") for q in calls)
    summary = [m for m in rec.metrics if m["kind"] == "loadgen_summary"]
    assert len(summary) == 1 and summary[0]["mode"] == "mixed"
    jout = jax_wl.run_loadgen(lambda q: {"outcome": "ok"},
                              jax_wl.parse_tenant_spec("a:closed:2"),
                              duration_s=0.05)
    assert sorted(out) == sorted(jout)


@pytest.fixture(scope="module")
def engine():
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.serve import ChampionSpec, ServeEngine, ShapeEnvelope

    eng = ServeEngine(ChampionSpec(code=template.fill_template(
        "score = 1000")), port_workload(jax_synthetic(8, 16, seed=0)),
        envelope=ShapeEnvelope(max_pods=4, min_pod_bucket=4, max_batch=4),
        device="cpu")
    eng.warmup()
    return eng


@pytest.mark.parametrize("front", ["service", "http"])
def test_loadgen_drives_the_port_service(engine, front):
    """Closed-loop tenants through ``service_client`` and ``http_client``:
    every request answered, the tenants accounted by the service."""
    from fks_tpu_torch.serve import ServeService, make_http_server

    service = ServeService(engine, max_wait_s=0.002, accounting=True)
    server = None
    if front == "http":
        server = make_http_server(service, 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        send = wl.http_client(server.server_address[1])
    else:
        send = wl.service_client(service)
    try:
        out = wl.run_loadgen(send, wl.parse_tenant_spec(
            "a:closed:1:2,b:closed:1:3"), duration_s=0.3)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        service.close()
    assert out["errors"] == 0 and out["shed"] == 0 and out["completed"] > 0
    stats = service.accountant.stats()
    assert sorted(stats) == ["a", "b"]
    assert sum(s["requests"] for s in stats.values()) == out["completed"]
