"""The port's champion serving (fks_tpu_torch.serve) against fks_tpu's, on
the CPU.

Both packages serve the first_fit seed champion on
``synthetic_workload(8, 16, seed=0)`` with ``ShapeEnvelope(max_pods=16,
min_pod_bucket=4, max_batch=4)`` (fks_tpu's own tests/test_serve.py
fixture): the same queries go through both engines. Placements and
scheduled counts must be identical and scores within ``SCORE_TOL`` (2e-6,
the bar the port's engine tests hold against fks_tpu in float32, the
serve engines' score dtype); on these workloads they are in fact equal.

Also here: bucket and lane routing, the query pack plan and the packed
tables, ``selftest``'s output dict field by field, an fks_tpu artifact
loaded by the port, the HTTP front on an ephemeral port, the service's
tenant accounting and SLO burn, the options that wait for later slices,
the CLI, and ``fks_tpu_serve_pins``, which makes
tests/fixtures/serve_pins.json (chip_smoke.py phase 12).
"""
import json
import pathlib
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.funsearch import template as jax_template
from fks_tpu.obs.history import SLOConfig as JaxSLOConfig
from fks_tpu.obs.recorder import NullRecorder as JaxNullRecorder
from fks_tpu.serve import ChampionSpec as JaxChampionSpec
from fks_tpu.serve import ServeEngine as JaxServeEngine
from fks_tpu.serve import ServeService as JaxServeService
from fks_tpu.serve import ShapeEnvelope as JaxShapeEnvelope
from fks_tpu.serve import batcher as jax_batcher
from fks_tpu.serve import selftest as jax_selftest
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.funsearch import template
from fks_tpu_torch.obs.history import SLOConfig
from fks_tpu_torch.obs.recorder import NullRecorder
from fks_tpu_torch.obs.telemetry import CompileWatcher
from fks_tpu_torch.serve import (
    ChampionSpec, ServeEngine, ServeService, ShapeEnvelope, batcher,
    load_champion, make_http_server, selftest,
)
from fks_tpu_torch.sim import get_engine
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import one_torch_thread, port_workload

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINS = ROOT / "tests" / "fixtures" / "serve_pins.json"
CHAMPIONS = ("funsearch_20260801_045536_score0.5365.json",
             "funsearch_20260801_134224_score0.4430.json")
SCORE_TOL = 2e-6
#: selftest fields that count bytes of the initial state, whose layout
#: differs between the packages' engines (the port's exact SimState keeps
#: other fields); every other field is compared exactly
STATE_BYTE_FIELDS = ("h2d_bytes_total", "h2d_bytes_per_query")


class Capture(NullRecorder):
    """The port's recorder API, keeping every metric and event row."""

    enabled = True

    def __init__(self):
        self.metrics, self.events = [], []

    def event(self, kind, **fields):
        self.events.append((kind, fields))

    def metric(self, kind, record=None, **fields):
        self.metrics.append({"kind": kind, **(record or fields)})


class JaxCapture(JaxNullRecorder):
    enabled = True

    def __init__(self):
        self.metrics, self.events = [], []

    def event(self, kind, **fields):
        self.events.append((kind, fields))

    def metric(self, kind, record=None, **fields):
        self.metrics.append({"kind": kind, **(record or fields)})


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _envelope(cls):
    return cls(max_pods=16, min_pod_bucket=4, max_batch=4,
               max_gpu_milli=1000)


@pytest.fixture(scope="module")
def engines():
    return make_engines()


def make_engines():
    """(port engine, fks_tpu engine): the first_fit seed champion on the
    same synthetic cluster."""
    jwl = jax_synthetic(8, 16, seed=0)
    code = template.fill_template("score = 1000")
    assert code == jax_template.fill_template("score = 1000")
    jeng = JaxServeEngine(JaxChampionSpec(code=code, score=0.5), jwl,
                          envelope=_envelope(JaxShapeEnvelope))
    eng = ServeEngine(ChampionSpec(code=code, score=0.5), port_workload(jwl),
                      envelope=_envelope(ShapeEnvelope), device="cpu")
    return eng, jeng


def _query(i, n=2):
    return [{"cpu_milli": 10 + 7 * i + j, "memory_mib": 50 + 11 * j,
             "creation_time": j, "duration_time": 40}
            for j in range(n)]


def _gpu_query(i, n=3):
    return [{"cpu_milli": 100 + 13 * i + j, "memory_mib": 64 + 7 * j,
             "num_gpu": 1 + (i + j) % 2, "gpu_milli": 250 * (1 + j % 3),
             "creation_time": 2 * j, "duration_time": 5 + i}
            for j in range(n)]


def assert_answers_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["placements"] == b["placements"]
        for k in ("scheduled", "failed", "truncated", "events",
                  "bucket_pods", "bucket_lanes"):
            assert a[k] == b[k], k
        assert abs(a["score"] - b["score"]) <= SCORE_TOL


# ----------------------------------------------------------- envelope units


@pytest.mark.parametrize("kw", [
    dict(max_pods=1024, min_pod_bucket=16, pod_bucket_growth=4,
         max_batch=8),
    dict(max_pods=100, min_pod_bucket=16, pod_bucket_growth=4, max_batch=3),
    dict(max_pods=16, min_pod_bucket=4, max_batch=4),
])
def test_bucket_and_lane_routing_match(kw):
    env, jenv = ShapeEnvelope(**kw), JaxShapeEnvelope(**kw)
    assert env.pod_buckets() == jenv.pod_buckets()
    assert env.lane_buckets() == jenv.lane_buckets()
    assert env.wait_hist_size == jenv.wait_hist_size
    for n in range(1, kw["max_pods"] + 1):
        assert env.pod_bucket_for(n) == jenv.pod_bucket_for(n)
    for b in env.pod_buckets():
        assert env.min_real_pods(b) == jenv.min_real_pods(b)
    for q in range(1, kw["max_batch"] + 1):
        assert env.lanes_for(q) == jenv.lanes_for(q)
    for bad in (kw["max_pods"] + 1,):
        with pytest.raises(ValueError):
            env.pod_bucket_for(bad)
    with pytest.raises(ValueError):
        env.lanes_for(kw["max_batch"] + 1)


def test_load_champion_single_and_list(tmp_path):
    from fks_tpu.serve import load_champion as jax_load

    single = {"code": "def f(): pass", "score": 0.4, "generation": 3}
    top = [{"code": "a", "score": 0.1}, {"code": "b", "score": 0.9},
           {"code": "c", "score": 0.5}]
    (tmp_path / "one.json").write_text(json.dumps(single))
    (tmp_path / "top.json").write_text(json.dumps(top))
    for name in ("one.json", "top.json"):
        p = str(tmp_path / name)
        assert load_champion(p).to_json() == jax_load(p).to_json()
    (tmp_path / "bad.json").write_text("{\"notcode\": 1}")
    for load in (load_champion, jax_load):
        with pytest.raises(ValueError):
            load(str(tmp_path / "bad.json"))


# --------------------------------------------------------- serving parity


def test_batch_answers_match_fks_tpu(engines):
    """Distinct queries in one batch, CPU and GPU pods, several buckets:
    every lane's answer equals fks_tpu's, and equals the port's own
    unbatched reference."""
    eng, jeng = engines
    queries = [_query(0, 1), _query(1, 2), _gpu_query(2, 3), _query(3, 5),
               _gpu_query(4, 9), _query(5, 16)]
    got = eng.answer_batch(queries)
    assert_answers_match(got, jeng.answer_batch(queries))
    for q, ans in zip(queries, got):
        ref = eng.reference_answer(q)
        assert ans["placements"] == ref["placements"]
        assert abs(ans["score"] - ref["score"]) <= 1e-5
    assert len({a["score"] for a in got}) > 1


def test_reference_answer_matches_fks_tpu(engines):
    eng, jeng = engines
    for q in (_query(7, 3), _gpu_query(1, 4)):
        assert_answers_match([eng.reference_answer(q)],
                             [jeng.reference_answer(q)])


def test_batch_order_preserved(engines):
    eng, _ = engines
    queries = [_query(3, 2), _query(4, 2)]
    fwd = eng.answer_batch(queries)
    rev = eng.answer_batch(queries[::-1])
    assert fwd[0]["score"] == rev[1]["score"]
    assert fwd[0]["placements"] == rev[1]["placements"]


def test_oversized_and_malformed_queries_rejected(engines):
    for eng in engines:
        for bad in ([[]], [_query(0, 17)], [[{"cpu_milli": -1}]],
                    [[{"gpu_milli": 5000}]]):
            with pytest.raises(ValueError):
                eng.answer_batch(bad)


def test_selftest_dict_matches_fks_tpu():
    """On fresh engines (the snapshot-cache counters are cumulative)."""
    eng, jeng = make_engines()
    got = selftest(eng, count=4, pods_per_query=3)
    want = jax_selftest(jeng, count=4, pods_per_query=3)
    assert got["ok"] and got["max_drift"] == 0.0
    for d in (got, want):
        for k in STATE_BYTE_FIELDS:
            d["snapshot_cache"].pop(k)
    assert got == want


def test_warm_path_captures_nothing(engines):
    """The warm path builds no new bucket graph (on the CPU the watcher
    sees no capture either: there is nothing to capture)."""
    eng, _ = engines
    eng.answer_batch([_query(5, 2), _query(6, 3)])
    built = eng.cold_compiles
    with CompileWatcher() as w:
        for i in range(3):
            eng.answer_batch([_query(7 + i, 3), _query(9 + i, 2)])
    assert w.backend_compile_count == 0 and eng.cold_compiles == built


# ------------------------------------------------------------ pack and stack


@pytest.mark.parametrize("state_pack", [False, True])
@pytest.mark.parametrize("bucket", [4, 16])
def test_query_pack_plan_and_tables_match(engines, state_pack, bucket):
    """The per-bucket pack plan, the stacked pod tables and the packed
    upload tables equal fks_tpu's; unpacking on the device restores the
    int32 tables bit for bit."""
    eng, jeng = engines
    cfg = SimConfig(max_steps=8 * bucket, state_pack=state_pack)
    jcfg = JaxConfig(max_steps=8 * bucket, state_pack=state_pack)
    plan = batcher.query_pack_plan(cfg, bucket, 1000)
    assert plan == jax_batcher.query_pack_plan(jcfg, bucket, 1000)
    lo = eng.envelope.min_real_pods(bucket)  # routing sends no fewer
    queries = [_query(1, lo), _gpu_query(2, bucket)]
    klen = eng._klen(bucket)
    pods, kt, _ = batcher.stack_query_tables(
        get_engine("exact"), eng._cluster_host, queries, bucket, cfg, klen)
    from fks_tpu.sim import get_engine as jax_get_engine
    jpods, jkt, _ = jax_batcher.stack_query_tables(
        jax_get_engine("exact"), jeng.cluster, queries, bucket, jcfg, klen)
    for f in batcher.PODARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(pods, f), getattr(jpods, f))
    np.testing.assert_array_equal(kt, jkt)
    ppods, pkt = batcher.pack_query_tables(pods, kt, plan)
    jppods, jpkt = jax_batcher.pack_query_tables(jpods, jkt, plan)
    for f in batcher.PODARRAY_FIELDS:
        a, b = np.asarray(getattr(ppods, f)), np.asarray(getattr(jppods, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert pkt.dtype == jpkt.dtype
    np.testing.assert_array_equal(pkt, jpkt)
    tpods = type(ppods)(**{f: batcher.to_tensor(getattr(ppods, f))
                           for f in batcher.PODARRAY_FIELDS})
    upods, ukt = batcher.unpack_query_tables(tpods, batcher.to_tensor(pkt),
                                             plan)
    np.testing.assert_array_equal(ukt.numpy(), kt)
    for f in batcher.PODARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(upods, f).numpy(),
                                      getattr(pods, f))


def test_stack_queries_match(engines):
    """The full-workload stacking entry: the same stacked pod tables and
    snapshot tables as fks_tpu's, one lane per query."""
    eng, jeng = engines
    from fks_tpu.sim import get_engine as jax_get_engine

    cfg, jcfg = SimConfig(max_steps=128), JaxConfig(max_steps=128)
    queries = [_query(1, 5), _gpu_query(2, 9), _query(3, 16)]
    wl, kt, s0 = batcher.stack_queries(get_engine("flat"), eng._cluster_host,
                                       queries, 16, cfg, eng._klen(16))
    jwl, jkt, _ = jax_batcher.stack_queries(
        jax_get_engine("flat"), jeng.cluster, queries, 16, jcfg,
        eng._klen(16))
    for f in batcher.PODARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(wl.pods, f).numpy(),
                                      np.asarray(getattr(jwl.pods, f)))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(jkt))
    assert s0.lanes == 3 and wl.cluster.cpu_total.shape[0] == 3


def test_pods_to_dicts_and_workload_match(engines):
    eng, jeng = engines
    from fks_tpu.data import TraceParser as JaxParser

    from fks_tpu_torch.data import TraceParser
    jwl = JaxParser().parse_workload(pod_file="openb_pod_list_multigpu20.csv")
    wl = TraceParser().parse_workload(pod_file="openb_pod_list_multigpu20.csv")
    assert batcher.pods_to_dicts(wl.pods, 50) == \
        jax_batcher.pods_to_dicts(jwl.pods, 50)
    assert eng.base_pods == jeng.base_pods
    q = _gpu_query(3, 5)
    w = batcher.build_query_workload(eng._cluster_host, q, 16)
    jw = jax_batcher.build_query_workload(jeng.cluster, q, 16)
    for f in batcher.PODARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(w.pods, f).numpy(),
                                      np.asarray(getattr(jw.pods, f)))
    assert w.pods.pod_ids == jw.pods.pod_ids


# --------------------------------------------------------- artifact I/O


def test_fks_tpu_artifact_loads_in_the_port(tmp_path, engines):
    """An artifact saved by fks_tpu's ServeEngine loads in the port and
    answers as fks_tpu does; the port's own save round-trips, and fks_tpu
    loads it."""
    eng, jeng = engines
    d = str(tmp_path / "jax_artifact")
    jeng.save(d)
    loaded = ServeEngine.load(d, device="cpu")
    q = [_query(10, 2), _gpu_query(5, 4)]
    assert_answers_match(loaded.answer_batch(q), jeng.answer_batch(q))
    assert loaded.envelope.to_json() == jeng.envelope.to_json()
    assert loaded.prefilter_k == jeng.prefilter_k
    assert loaded.base_pods == jeng.base_pods
    assert loaded.policy_tier == jeng.policy_tier
    d2 = str(tmp_path / "port_artifact")
    eng.save(d2)
    doc = json.loads((tmp_path / "port_artifact" / "artifact.json")
                     .read_text())
    jdoc = json.loads((tmp_path / "jax_artifact" / "artifact.json")
                      .read_text())
    assert doc == jdoc
    assert_answers_match(JaxServeEngine.load(d2).answer_batch(q),
                         eng.answer_batch(q))
    doc["version"] = 999
    (tmp_path / "port_artifact" / "artifact.json").write_text(
        json.dumps(doc))
    with pytest.raises(ValueError):
        ServeEngine.load(d2, device="cpu")


# ---------------------------------------------------------- service + audit


def _serve(service, queries, extra=lambda i: {}):
    futs = [service.submit({"id": f"q{i}", "pods": q, **extra(i)})
            for i, q in enumerate(queries)]
    answers = [f.result(timeout=120) for f in futs]
    service.close()
    return answers


def test_service_answers_audits_and_summary(engines):
    """Both services answer the same requests identically; the summary
    rows agree on every count."""
    eng, jeng = engines
    queries = [_query(i, 2) for i in range(3)]
    rows = []
    for e, cls in ((eng, ServeService), (jeng, JaxServeService)):
        service = cls(e, max_wait_s=0.005, audit_every=1)
        answers = _serve(service, queries, extra=lambda i: {})
        assert [a["id"] for a in answers] == ["q0", "q1", "q2"]
        assert all(a["latency_ms"] > 0 for a in answers)
        rows.append((answers, service.summary(record=False)))
    (got, s), (want, js) = rows
    assert_answers_match(got, want)
    for k in ("requests", "audits", "audit_failures", "engine_kind",
              "policy_tier", "swaps", "queue_depth", "shed_total",
              "expired", "engine_state"):
        assert s[k] == js[k], k
    assert s["audits"] == 3 and s["audit_failures"] == 0


def test_service_tenant_accounting_and_slo(engines):
    """accounting=True: the same tenants, request counts, workload classes
    and SLO burn records in both packages (latencies differ, so the SLO
    is set where both observe every request over it)."""
    eng, jeng = engines
    queries = [_query(i, 2) for i in range(3)]
    tenants = ("acme", "acme", "zoo")
    out = []
    for e, cls, rec, slo in (
            (eng, ServeService, Capture(), SLOConfig(p99_ms=1e-6)),
            (jeng, JaxServeService, JaxCapture(), JaxSLOConfig(p99_ms=1e-6))):
        # one request per batch: the windows close at the same requests
        service = cls(e, recorder=rec, max_batch=1, max_wait_s=0.002,
                      accounting=True, workload_every=2, slo=slo,
                      slo_every=3)
        _serve(service, queries, extra=lambda i: {"tenant": tenants[i]})
        out.append((service, service.summary(record=False), rec))
    (s, sm, rec), (js, jsm, jrec) = out
    st, jst = s.accountant.stats(), js.accountant.stats()
    assert sorted(st) == sorted(jst) == ["acme", "zoo"]
    for t in st:
        for k in ("requests", "shed", "expired", "degraded",
                  "fairness_index", "burn_rate"):
            assert st[t][k] == jst[t][k], (t, k)
    reqs = [m for m in rec.metrics if m["kind"] == "serve_request"]
    jreqs = [m for m in jrec.metrics if m["kind"] == "serve_request"]
    assert [(m["tenant"], m["workload_class"]) for m in reqs] == \
        [(m["tenant"], m["workload_class"]) for m in jreqs]
    assert sm["workload_mix"] == jsm["workload_mix"]
    assert sm["fairness_index"] == jsm["fairness_index"]
    burn = [{k: v for k, v in m.items() if k != "observed"}
            for m in rec.metrics if m["kind"] == "slo_burn"]
    jburn = [{k: v for k, v in m.items() if k != "observed"}
             for m in jrec.metrics if m["kind"] == "slo_burn"]
    assert burn == jburn and burn[0]["burn_rate"] == 100.0
    assert [{k: v for k, v in r.items() if k != "observed"}
            for r in sm["slo"]] == [{k: v for k, v in r.items()
                                     if k != "observed"}
                                    for r in jsm["slo"]]


def test_service_accounting_disabled_is_inert(engines):
    eng, _ = engines
    rec = Capture()
    service = ServeService(eng, recorder=rec, max_wait_s=0.002)
    _serve(service, [_query(0, 2)], extra=lambda i: {})
    assert service.accountant is None and service.fingerprinter is None
    row = [m for m in rec.metrics if m["kind"] == "serve_request"][0]
    assert row["tenant"] == "default"
    assert "workload_class" not in row


def test_swap_engine_flips_to_another_warm_engine(engines):
    eng, _ = engines
    service = ServeService(eng, max_wait_s=0.002)
    other = ServeEngine(ChampionSpec(code=template.seed_policies()
                                     ["best_fit"], score=0.4),
                        port_workload(jax_synthetic(8, 16, seed=0)),
                        envelope=eng.envelope, device="cpu")
    try:
        assert service.swap_engine(other) is eng
        assert service.submit({"pods": _gpu_query(1, 3)}).result(
            timeout=120)["placements"] == \
            other.answer_batch([_gpu_query(1, 3)])[0]["placements"]
        with pytest.raises(TypeError):
            service.swap_engine(ChampionSpec(code="x"))
    finally:
        service.close()
    assert service.summary(record=False)["swaps"] == 1


# -------------------------------------------------------------- HTTP front


def _http_stack(engine, **kw):
    service = ServeService(engine, **kw)
    server = make_http_server(service, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return service, server, f"http://127.0.0.1:{server.server_address[1]}"


def test_http_round_trip_equals_the_library(engines):
    """Three concurrent POST /query share one batch and answer what the
    library answers; GET /healthz and /stats answer; a malformed POST is
    a structured 400."""
    eng, _ = engines
    service, server, base = _http_stack(eng, max_batch=3, max_wait_s=5.0)
    queries = [_query(k, 2) for k in range(3)]
    out = [None] * 3

    def client(k):
        req = urllib.request.Request(
            f"{base}/query",
            data=json.dumps({"id": f"c{k}", "pods": queries[k]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out[k] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            hz = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        bad = urllib.request.Request(
            f"{base}/query", data=b'{"nope": 1}',
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    assert [o["id"] for o in out] == ["c0", "c1", "c2"]
    lib = eng.answer_batch(queries)
    for o, a in zip(out, lib):
        assert o["placements"] == a["placements"]
        assert o["score"] == a["score"]
    assert hz["ok"] and hz["engine_state"] == "normal"
    assert stats["requests"] == 3 and stats["batches"] == 1


# ----------------------------------------------------------- waiting options


def test_waiting_options_raise(engines, tmp_path):
    eng, _ = engines
    from fks_tpu_torch import cli

    wl = port_workload(jax_synthetic(8, 16, seed=0))
    # mesh= runs (tests/test_torch_mesh.py); what is not a Mesh raises
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ServeEngine(eng.champion, wl, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ServeEngine.load("unused", mesh=object())
    with pytest.raises(ValueError, match="fused kernel"):
        ServeEngine(eng.champion, wl, engine="fused", device="cpu")
    # --devices N runs; on the card it takes N CUDA devices and raises
    # when the machine has fewer
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices"):
        cli.main(["serve", "--devices", str(have + 1)])
    # the control plane's options run since it was ported (their runs
    # are tests/test_torch_pipeline.py's): with an empty ledger they stop
    # at "no champion" like any serve, no ValueError naming a queue item
    for argv in (["--follow-ledger"], ["--drain-state", "x.json"]):
        assert cli.main(["serve", "--device", "cpu", "--ledger-dir",
                         str(tmp_path), *argv]) == 2


def test_entry_points_default_to_the_card(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    eng, _ = engines
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(eng.champion, port_workload(jax_synthetic(8, 16, seed=0)))


# ----------------------------------------------------------------- CLI


def test_cli_serve_jsonl_and_selftest(tmp_path, capsys):
    """``python -m fks_tpu_torch.cli serve`` on the CPU: JSONL answers in
    input order, then the selftest with an artifact saved."""
    from fks_tpu_torch import cli

    qfile = tmp_path / "q.jsonl"
    qfile.write_text(
        json.dumps({"id": "a", "pods": _query(0, 2)}) + "\n"
        + json.dumps({"id": "b", "pods": _query(1, 1)}) + "\n")
    rc = cli.main(["serve", "--device", "cpu", "--max-pods", "16",
                   "--max-batch", "2", "--queries", str(qfile),
                   "--audit-every", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    answers = [json.loads(line) for line in out.strip().splitlines()]
    assert [a["id"] for a in answers] == ["a", "b"]
    assert all("score" in a and "placements" in a for a in answers)
    rc = cli.main(["serve", "--device", "cpu", "--max-pods", "8",
                   "--max-batch", "2", "--selftest", "2",
                   "--pods-per-query", "2",
                   "--save-artifact", str(tmp_path / "art")])
    result = json.loads(capsys.readouterr().out)
    assert rc == 0 and result["ok"] and result["max_drift"] == 0.0
    assert (tmp_path / "art" / "artifact.json").exists()


def test_cli_vm_fallback_reports_zero_coverage(tmp_path, capsys):
    """A champion outside the VM vocabulary served with --serve-engine vm
    falls back to the closure engine and selftest says vm_coverage 0."""
    from fks_tpu_torch import cli
    from fks_tpu_torch.funsearch import vm

    code = template.fill_template(
        "gpus = sorted(g.gpu_milli_left for g in node.gpus)\n"
        "    return max(1, gpus[0]) if pod.num_gpu == 0 else 1")
    with pytest.raises(vm.VMUnsupported):
        vm.compile_policy(code, 16, 8)
    champ = tmp_path / "champ.json"
    champ.write_text(json.dumps({"code": code, "score": 0.1}))
    rc = cli.main(["serve", "--device", "cpu", "--champion", str(champ),
                   "--serve-engine", "vm", "--max-pods", "8",
                   "--max-batch", "2", "--selftest", "2",
                   "--pods-per-query", "2"])
    captured = capsys.readouterr()
    result = json.loads(captured.out)
    assert rc == 0 and result["ok"]
    assert result["vm_coverage"] == 0.0 and result["policy_tier"] == "jit"
    assert "falling back" in captured.err


# ------------------------------------------------------------------ pins


def pin_queries(base_pods, count=8, pods_per_query=4):
    """chip_smoke.py phase 12's queries: ``selftest``'s sliding windows
    over the pinned workload's pods."""
    return [base_pods[i:i + pods_per_query] for i in range(count)]


def fks_tpu_serve_pins():
    """fks_tpu's answers on the default cluster (``TraceParser()``) for
    phase 12's queries, the 0.5365 champion and the second champion (the
    0.4430 one, whose placements differ on every query)."""
    from fks_tpu.data import TraceParser as JaxParser
    from fks_tpu.serve import load_champion as jax_load

    wl = JaxParser().parse_workload()
    doc = {"source": "fks_tpu.serve.ServeEngine on CPU JAX, "
                     "TraceParser().parse_workload(), ShapeEnvelope()",
           "champions": list(CHAMPIONS), "answers": {}}
    for name in CHAMPIONS:
        eng = JaxServeEngine(jax_load(str(ROOT / "policies" / "discovered"
                                          / name)), wl)
        queries = pin_queries(eng.base_pods)
        doc["queries"] = queries
        doc["answers"][name] = [
            {k: a[k] for k in ("score", "scheduled", "placements")}
            for a in eng.answer_batch(queries)]
    return doc


@pytest.fixture(scope="module")
def pins():
    return json.loads(PINS.read_text())


def test_pins_hold_on_fks_tpu(pins):
    """The committed pins are still fks_tpu's answers."""
    assert fks_tpu_serve_pins() == pins


def test_pins_hold_on_the_port(pins):
    """The port's ServeEngine on the CPU gives the pinned answers for both
    champions; the VM engine swapped to the second champion too."""
    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.serve import VMServeEngine

    wl = TraceParser().parse_workload()
    first, second = (load_champion(str(ROOT / "policies" / "discovered"
                                       / name)) for name in CHAMPIONS)
    eng = ServeEngine(first, wl, device="cpu")
    assert pin_queries(eng.base_pods) == pins["queries"]
    queries = pins["queries"]

    def same(got, name):
        want = pins["answers"][name]
        assert [{k: a[k] for k in ("score", "scheduled", "placements")}
                for a in got] == want, name

    same(eng.answer_batch(queries), CHAMPIONS[0])
    vm_eng = VMServeEngine(first, wl, device="cpu")
    same(vm_eng.answer_batch(queries), CHAMPIONS[0])
    assert vm_eng.swap_program(second) == first
    same(vm_eng.answer_batch(queries), CHAMPIONS[1])
    assert vm_eng.cold_compiles == 1


def write_pins() -> None:
    """Rewrite tests/fixtures/serve_pins.json from fks_tpu (run by hand
    when phase 12's queries or champions change)."""
    PINS.write_text(json.dumps(fks_tpu_serve_pins(), indent=1) + "\n")


# ------------------------------------------------- telemetry, memory, layout


def test_compile_watcher_counts_graph_captures():
    """The capture counter: every ``graph_capture`` scope reports to each
    installed watcher (one ``compile`` event each); uninstalled watchers
    and the disabled recorder path see nothing."""
    from fks_tpu_torch.obs import telemetry

    rec = Capture()
    with telemetry.CompileWatcher(rec) as w, telemetry.CompileWatcher() as w2:
        for label in ("chunk", "chunk", "probe"):
            with telemetry.graph_capture(label):
                pass
    with telemetry.graph_capture("chunk"):
        pass  # after uninstall
    assert w.backend_compile_count == w2.backend_compile_count == 3
    assert sorted(w.summary()) == ["/torch/cuda/graph/chunk/capture",
                                   "/torch/cuda/graph/probe/capture"]
    assert [k for k, _ in rec.events] == ["compile"] * 3
    assert telemetry.watch_compiles(NullRecorder()).__enter__() is None
    assert isinstance(telemetry.watch_compiles(rec), telemetry.CompileWatcher)
    if not torch.cuda.is_available():
        assert telemetry.device_snapshot() == [{
            "id": 0, "platform": "cpu", "device_kind": "cpu",
            "process_index": 0, "memory_stats": None}]


def test_footprint_and_layout_rows_match_fks_tpu():
    """``record_footprint`` files fks_tpu's row for a priced graph and
    nothing on the CPU; ``record_layout`` files the serve engines' rows
    as fks_tpu's does, deduplicating identical repeats."""
    from fks_tpu.obs import layout as jax_layout
    from fks_tpu.obs import memory as jax_memory
    from fks_tpu.parallel.mesh import occupancy_stats as jax_occupancy
    from fks_tpu_torch.obs import layout, memory
    from fks_tpu_torch.parallel.population import occupancy_stats

    assert memory.MEMORY_COMPONENTS == jax_memory.MEMORY_COMPONENTS
    fp = {"temp_bytes": 10, "argument_bytes": 20, "output_bytes": 0,
          "generated_code_bytes": 0, "total_bytes": 30}
    rec, jrec = Capture(), JaxCapture()
    got = memory.record_footprint("serve_vm", "lanes=2,pods=8",
                                  footprint=fp, recorder=rec, engine="x")
    want = jax_memory.record_footprint("serve_vm", "lanes=2,pods=8",
                                       footprint=fp, recorder=jrec,
                                       engine="x")
    assert got == want and rec.metrics == jrec.metrics
    assert memory.record_footprint("serve_aot", "k", footprint={}) is None
    with memory.capture_footprint("cpu", argument_bytes=5) as out:
        pass
    assert out == {}
    with pytest.raises(ValueError):
        memory.record_footprint("nope", "k", footprint=fp)
    rows, jrows = [], []
    for real, lanes in ((3, 4), (3, 4), (8, 8)):
        rows.append(layout.record_layout(
            "vm_serve", layout.DEFAULT_LAYOUT_KEY, recorder=rec,
            **occupancy_stats(real, lanes)))
        jrows.append(jax_layout.record_layout(
            "vm_serve", "shard[candidates]|vmap[candidates]|seg=0",
            recorder=jrec, **jax_occupancy(real, lanes)))
    assert rows == jrows and rows[1] is None
    with pytest.raises(ValueError):
        layout.record_layout("nope", layout.DEFAULT_LAYOUT_KEY)
    with pytest.raises(ValueError):
        layout.record_layout("serve", "shard[everything]|vmap[]|seg=0")


def test_batch_turn_is_reentrant_and_first_come_first_served():
    """``ServeEngine.exclusive``'s turn: the holder may take it again; a
    thread that lets go and at once asks again queues behind a thread
    already waiting (a promotion's next replay waits for the live batch
    that waited out the last one); a waiter that gives up is passed
    over."""
    import time

    from fks_tpu_torch.serve.artifact import _Turn

    turn = _Turn()
    order = []

    def waiter():
        with turn:
            order.append("waiter")

    def wait_for_tickets(n):
        deadline = time.monotonic() + 30
        while turn._next_ticket < n and time.monotonic() < deadline:
            time.sleep(0.001)
        assert turn._next_ticket == n

    with turn:
        with turn:  # re-entrant
            order.append("holder")
        other = threading.Thread(target=waiter)
        other.start()
        wait_for_tickets(2)
    with turn:  # asked again at once: the waiter goes first
        order.append("holder again")
    other.join(timeout=30)
    assert order == ["holder", "waiter", "holder again"]

    # a waiter interrupted while queued gives its ticket up
    class GiveUp(Exception):
        pass

    def interrupted_wait():
        def boom():
            raise GiveUp
        turn._cond.wait = lambda *a, **k: boom()
        try:
            with turn:
                order.append("never")
        except GiveUp:
            order.append("gave up")

    with turn:
        saved_wait = turn._cond.wait
        quitter = threading.Thread(target=interrupted_wait)
        quitter.start()
        quitter.join(timeout=30)
        turn._cond.wait = saved_wait
        other = threading.Thread(target=waiter)
        other.start()
        wait_for_tickets(6)
    other.join(timeout=30)
    assert order[-2:] == ["gave up", "waiter"] and not other.is_alive()
