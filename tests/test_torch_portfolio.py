"""fks_tpu_torch.portfolio vs fks_tpu.portfolio (tests/test_portfolio.py,
less the FleetController, which waits for pipeline/).

The contract: N resident policies share one set of graphs; per-request
slot selection equals serving each champion alone; swapping one slot under
live traffic is a table copy — no new graph — that never perturbs the
other slots; the router's rule chain is deterministic. On the same
workload and champions the port's answers, its ``portfolio_selftest``
dict and its routing equal fks_tpu's (placements exact, scores within
rtol/atol 2e-6), and a portfolio artifact saved by either package loads
in the other with the same answers. A mesh of logical CPU shards serves
the same answers as one device.
"""
import json
import os
import threading

import pytest
import torch

from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.portfolio import PortfolioEngine as JaxPortfolio
from fks_tpu.portfolio import Router as JaxRouter
from fks_tpu.portfolio import portfolio_selftest as jax_selftest
from fks_tpu.portfolio import vm_coverage_split as jax_split
from fks_tpu.serve import ChampionSpec as JaxChamp
from fks_tpu.serve import ServeEngine as JaxServe
from fks_tpu.serve import ShapeEnvelope as JaxEnvelope
from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.funsearch import template, vm
from fks_tpu_torch.obs.workload import QueryFingerprinter
from fks_tpu_torch.parallel import population_mesh
from fks_tpu_torch.portfolio import (
    FALLBACK, ROUTE_REASONS, PortfolioEngine, PortfolioService, Router,
    portfolio_selftest, vm_coverage_split,
)
from fks_tpu_torch.serve import ChampionSpec, ServeEngine, ShapeEnvelope
from fks_tpu_torch.testing import one_torch_thread

SEED_LOGIC = "score = 1000"
BETTER_LOGIC = ("score = 1000 + (node.cpu_milli_left - pod.cpu_milli) "
                "/ max(1, node.cpu_milli_total)")
UNSUPPORTED_LOGIC = ("gpus = sorted(g.gpu_milli_left for g in node.gpus)\n"
                     "return max(1, gpus[0]) if pod.num_gpu == 0 else 1")
# raw-milli scores: distinct policies (fks_tpu's fixture champions)
LOGICS = (SEED_LOGIC,
          "score = node.cpu_milli_left - pod.cpu_milli",
          "score = node.memory_mib_left - pod.memory_mib",
          "score = pod.cpu_milli - node.cpu_milli_left")
ENV = dict(max_pods=8, min_pod_bucket=8, max_batch=2, max_gpu_milli=1000)


def _champ(logic, score=0.5, source="<test>", cls=ChampionSpec):
    return cls(code=template.fill_template(logic), score=score,
               source=source)


def _champs(cls=ChampionSpec):
    return [_champ(lg, 0.4 + 0.1 * i, f"<c{i}>", cls)
            for i, lg in enumerate(LOGICS)]


def _query(base, i, n=3):
    return [dict(base[(i + j) % len(base)]) for j in range(n)]


def _key(answers):
    return tuple((round(float(a["score"]), 9), repr(a["placements"]))
                 for a in answers)


class RecStub:
    enabled = True

    def __init__(self):
        self.events, self.metrics = [], []

    def event(self, kind, **fields):
        self.events.append({"kind": kind, **fields})

    def metric(self, kind, *a, **fields):
        self.metrics.append({"kind": kind, **fields})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def wl():
    return synthetic_workload(8, 16, seed=0)


@pytest.fixture(scope="module")
def envelope():
    return ShapeEnvelope(**ENV)


@pytest.fixture(scope="module")
def portfolio(wl, envelope):
    eng = PortfolioEngine(_champs(), wl, envelope=envelope, engine="flat",
                          n_slots=5, device="cpu")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def jax_portfolio():
    eng = JaxPortfolio(_champs(JaxChamp), jax_synthetic(8, 16, seed=0),
                       envelope=JaxEnvelope(**ENV), engine="flat",
                       n_slots=5)
    eng.warmup()
    return eng


def _same_answers(got, want):
    for a, b in zip(got, want):
        assert a["placements"] == b["placements"]
        assert a["scheduled"] == b["scheduled"]
        assert a["score"] == pytest.approx(b["score"], rel=2e-6, abs=2e-6)


# ------------------------------------------------------------- units


def test_select_slot_capacity_is_shape_derived(wl):
    n, g = wl.cluster.n_padded, wl.cluster.g_padded
    progs = [vm.pad_capacity(vm.compile_policy(
        template.fill_template(lg), n, g), 256)
        for lg in (SEED_LOGIC, BETTER_LOGIC)]
    one = vm.select_slot(vm.stack_programs(progs), 1)
    assert one.capacity == 256


def test_n_slots_must_cover_champions(wl, envelope):
    with pytest.raises(ValueError, match="n_slots"):
        PortfolioEngine(_champs(), wl, envelope=envelope, n_slots=2,
                        device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        PortfolioEngine([], wl, envelope=envelope, device="cpu")


def test_shadow_for_is_not_the_portfolio_shadow_path(portfolio):
    with pytest.raises(TypeError, match="slots"):
        portfolio.shadow_for(_champ(BETTER_LOGIC))


# ------------------------------------------------------- slot parity


def test_selftest_and_answers_match_fks_tpu(portfolio, jax_portfolio):
    result = portfolio_selftest(portfolio, count=6, pods_per_query=3)
    want = jax_selftest(jax_portfolio, count=6, pods_per_query=3)
    assert result == want
    assert result["ok"] and result["max_drift"] == 0.0
    assert result["mixed_max_drift"] == 0.0 and result["placements_match"]
    base = portfolio.base_pods
    assert base == jax_portfolio.base_pods
    queries = [_query(base, i) for i in range(6)]
    for slots in ([1] * 6, [3] * 6, [i % 5 for i in range(6)]):
        _same_answers(portfolio.answer_batch(queries, slots=slots),
                      jax_portfolio.answer_batch(queries, slots=slots))
    # the resident policies really differ, or routing bugs would hide
    s1 = portfolio.answer_batch(queries, slots=[1] * 6)
    s3 = portfolio.answer_batch(queries, slots=[3] * 6)
    assert _key(s1) != _key(s3)


def test_slot_validation(portfolio):
    base = portfolio.base_pods
    with pytest.raises(ValueError, match="outside portfolio"):
        portfolio.answer_batch([_query(base, 0)], slots=[99])
    with pytest.raises(ValueError, match="slots for"):
        portfolio.answer_batch([_query(base, 0)], slots=[0, 1])
    with pytest.raises(ValueError, match="outside portfolio"):
        portfolio.swap_slot(5, _champ(SEED_LOGIC))


def test_swap_slot_returns_rollback_handle(wl, envelope):
    a = _champ(LOGICS[1], 0.4, "<a>")
    b = _champ(LOGICS[3], 0.9, "<b>")
    rec = RecStub()
    eng = PortfolioEngine([a, b], wl, envelope=envelope, engine="flat",
                          n_slots=3, recorder=rec, device="cpu")
    eng.warmup()
    base = eng.base_pods
    queries = [_query(base, 7), _query(base, 11)]
    before = _key(eng.answer_batch(queries, slots=[0, 0]))
    other = _key(eng.answer_batch(queries, slots=[1, 1]))
    assert before != other
    graphs = len(eng._graphs)
    old = eng.swap_slot(0, b)
    assert old.source == "<a>"  # the rollback handle
    assert _key(eng.answer_batch(queries, slots=[0, 0])) == other
    assert eng.champion.source == "<b>"  # slot 0 is the default champion
    eng.swap_slot(0, old)
    assert _key(eng.answer_batch(queries, slots=[0, 0])) == before
    assert len(eng._graphs) == graphs  # swaps build no graph
    assert eng.slot_swaps == [2, 0, 0]
    swaps = [e for e in rec.events if e["kind"] == "slot_swap"]
    assert [e["slot"] for e in swaps] == [0, 0]
    assert swaps[1]["transpile_cache"] == "hit"
    # swap_program maps to the default slot
    assert eng.swap_program(b).source == "<a>"
    assert eng.last_slot_swapped == 0


# ----------------------------------------------------- persistence


def test_save_load_roundtrip_across_packages(tmp_path, portfolio,
                                             jax_portfolio):
    q = _query(portfolio.base_pods, 1)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "fks")
    portfolio.save(mine)
    jax_portfolio.save(theirs)
    doc = json.loads(open(os.path.join(mine, "artifact.json")).read())
    assert doc["portfolio"]["n_slots"] == 5
    assert doc == json.loads(
        open(os.path.join(theirs, "artifact.json")).read())
    for path in (mine, theirs):
        loaded = ServeEngine.load(path, device="cpu")
        assert isinstance(loaded, PortfolioEngine)
        assert [c.source for c in loaded.slot_champions] == \
            [c.source for c in portfolio.slot_champions]
        for s in range(3):
            assert _key(loaded.answer_batch([q], slots=[s])) == \
                _key(portfolio.answer_batch([q], slots=[s]))
    # the port's artifact loads in fks_tpu as its portfolio engine
    jloaded = JaxServe.load(mine)
    assert isinstance(jloaded, JaxPortfolio)
    _same_answers(jloaded.answer_batch([q], slots=[2]),
                  portfolio.answer_batch([q], slots=[2]))


# ---------------------------------------------------------- router


def test_router_rule_precedence_matches_fks_tpu():
    base_pods = [{"cpu_milli": 100, "memory_mib": 200}] * 3
    cls = QueryFingerprinter().classify(base_pods)
    kw = dict(pins={"vip": 1}, affinity={cls: 2}, ab_split={0: 0.5, 3: 0.5})
    r, jr = Router(4, **kw), JaxRouter(4, **kw)
    assert r.route("r1", "vip", base_pods) == (1, "pin")
    assert r.route("r2", "other", base_pods) == (2, "affinity")
    odd = [{"cpu_milli": 999999, "memory_mib": 1}] * 3
    slot, reason = r.route("r3", "other", odd)
    assert reason == "ab" and slot in (0, 3)
    for rid, tenant, pods in (("r1", "vip", base_pods),
                              ("r2", "other", base_pods),
                              ("r3", "other", odd)):
        assert jr.route(rid, tenant, pods) == Router(4, **kw).route(
            rid, tenant, pods)
    assert r.routed["pin"] == r.routed["affinity"] == r.routed["ab"] == 1


def test_router_ab_is_deterministic_and_fks_tpus():
    r, jr = Router(4, ab_split={0: 0.5, 3: 0.5}), \
        JaxRouter(4, ab_split={0: 0.5, 3: 0.5})
    pods = [{"cpu_milli": 1, "memory_mib": 1}]
    first = [r.route(f"req-{i}", "t", pods)[0] for i in range(64)]
    again = [r.route(f"req-{i}", "t", pods)[0] for i in range(64)]
    assert first == again and set(first) == {0, 3}
    assert first == [jr.route(f"req-{i}", "t", pods)[0] for i in range(64)]


def test_router_fallback_reason_and_validation():
    r = Router(2, pins={"legacy": FALLBACK})
    assert r.route("r1", "legacy", []) == (FALLBACK, "fallback")
    with pytest.raises(ValueError):
        Router(2, pins={"bad": 7})
    with pytest.raises(ValueError):
        Router(2, ab_split={0: 0.0})
    with pytest.raises(ValueError):
        Router(2, default_slot=2)
    from fks_tpu.portfolio import ROUTE_REASONS as JAX_REASONS
    assert ROUTE_REASONS == JAX_REASONS


def test_vm_coverage_split_matches_fks_tpu(wl):
    n, g = wl.cluster.n_padded, wl.cluster.g_padded
    resident, fallback = vm_coverage_split(
        [_champ(SEED_LOGIC), _champ(UNSUPPORTED_LOGIC)], n, g)
    jres, jfb = jax_split([_champ(SEED_LOGIC, cls=JaxChamp),
                           _champ(UNSUPPORTED_LOGIC, cls=JaxChamp)], n, g)
    assert [c.code for c in resident] == [c.code for c in jres]
    assert [c.code for c in fallback] == [c.code for c in jfb]
    assert len(resident) == 1 and len(fallback) == 1


# --------------------------------------------------------- service


def test_service_routes_and_records(portfolio):
    rec = RecStub()
    router = Router(portfolio.n_slots, pins={"vip": 1},
                    ab_split={0: 0.5, 2: 0.5})
    svc = PortfolioService(portfolio, router=router, recorder=rec,
                           max_wait_s=0.002)
    base = portfolio.base_pods
    try:
        futs = [svc.submit({"pods": _query(base, i), "id": f"q{i}",
                            "tenant": "vip" if i % 2 else "t"})
                for i in range(6)]
        answers = [f.result(timeout=300) for f in futs]
    finally:
        svc.close()
    expect = Router(portfolio.n_slots, pins={"vip": 1},
                    ab_split={0: 0.5, 2: 0.5})
    for i, a in enumerate(answers):
        slot, _ = expect.route(f"q{i}", "vip" if i % 2 else "t",
                               _query(base, i))
        assert a["slot"] == slot
        assert _key([a]) == _key(portfolio.answer_batch(
            [_query(base, i)], slots=[slot]))
    routes = [m for m in rec.metrics if m["kind"] == "portfolio_route"]
    assert len(routes) == 6
    assert {m["reason"] for m in routes} == {"pin", "ab"}
    summ = svc.summary(record=False)
    assert summ["portfolio"]["n_slots"] == portfolio.n_slots
    assert sum(summ["portfolio"]["slot_requests"]) >= 6
    assert summ["portfolio"]["routes"] == {"pin": 3, "ab": 3}


def test_service_query_slot_override(portfolio):
    svc = PortfolioService(portfolio, max_wait_s=0.002)
    try:
        ans = svc.submit({"pods": _query(portfolio.base_pods, 0),
                          "slot": 2}).result(timeout=300)
        with pytest.raises(ValueError, match="outside portfolio"):
            svc.submit({"pods": _query(portfolio.base_pods, 0),
                        "slot": 9})
    finally:
        svc.close()
    assert ans["slot"] == 2
    assert svc.router.routed["query"] == 1


def test_service_fallback_engine(wl, envelope, portfolio):
    fallback = ServeEngine(_champ(BETTER_LOGIC), wl, envelope=envelope,
                           engine="flat", device="cpu")
    router = Router(portfolio.n_slots, pins={"legacy": FALLBACK})
    svc = PortfolioService(portfolio, router=router,
                           fallback_engine=fallback, max_wait_s=0.002)
    base = portfolio.base_pods
    try:
        f1 = svc.submit({"pods": _query(base, 0), "tenant": "legacy"})
        f2 = svc.submit({"pods": _query(base, 1), "tenant": "normal"})
        a1, a2 = f1.result(timeout=300), f2.result(timeout=300)
    finally:
        svc.close()
    assert a1["slot"] == FALLBACK and a2["slot"] == 0
    assert svc.fallback_served == 1
    assert _key([a1]) == _key(fallback.answer_batch([_query(base, 0)]))
    # without a fallback engine the route degrades to the default slot
    svc = PortfolioService(portfolio, router=router, max_wait_s=0.002)
    try:
        a3 = svc.submit({"pods": _query(base, 0),
                         "tenant": "legacy"}).result(timeout=300)
    finally:
        svc.close()
    assert a3["slot"] == 0


# -------------------------------------------- swaps under live traffic


def test_concurrent_slot_swap_never_perturbs_other_slots(wl, envelope):
    champs = [_champ(LOGICS[1], 0.4, "<a>"), _champ(LOGICS[3], 0.9, "<b>")]
    eng = PortfolioEngine(champs, wl, envelope=envelope, engine="flat",
                          n_slots=3, device="cpu")
    eng.warmup()
    swap, under = 0, 1
    base = eng.base_pods
    queries = [_query(base, 7), _query(base, 11)]
    expected = _key(eng.answer_batch(queries, slots=[under, under]))
    legal = {}
    for i, c in enumerate(champs):
        eng.swap_slot(swap, c)
        legal[i] = _key(eng.answer_batch(queries, slots=[swap, swap]))
    assert legal[0] != legal[1]
    graphs = len(eng._graphs)
    errors, torn, served = [], [], []
    stop = threading.Event()

    def hammer():
        try:
            while not stop.is_set():
                got = _key(eng.answer_batch(queries, slots=[under, under]))
                served.append(1)
                if got != expected:
                    torn.append(got)
        except Exception as e:  # pragma: no cover - failure diagnostics
            errors.append(repr(e))

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for i in range(12):
            eng.swap_slot(swap, champs[(i + 1) % 2])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    assert not errors and not torn and served
    assert eng.slot_swaps[swap] >= 12
    assert len(eng._graphs) == graphs


def test_concurrent_service_futures_exactly_once(wl, envelope):
    champs = [_champ(SEED_LOGIC, 0.4, "<a>"), _champ(BETTER_LOGIC, 0.9,
                                                     "<b>")]
    eng = PortfolioEngine(champs, wl, envelope=envelope, engine="flat",
                          n_slots=3, device="cpu")
    eng.warmup()
    svc = PortfolioService(eng, router=Router(3, pins={"t": 1}),
                           max_wait_s=0.002)
    base = eng.base_pods
    try:
        futs = [svc.submit({"pods": _query(base, i), "tenant": "t"})
                for i in range(8)]
        for i in range(6):
            eng.swap_slot(0, champs[(i + 1) % 2])
        answers = [f.result(timeout=300) for f in futs]
    finally:
        svc.close()
    assert len(answers) == 8
    assert all(a["slot"] == 1 and a["score"] is not None for a in answers)


# ------------------------------------------------------ mesh and CLI


def test_portfolio_on_a_mesh_matches_one_device(portfolio, wl, envelope):
    eng = PortfolioEngine(_champs(), wl, envelope=envelope, engine="flat",
                          n_slots=5, mesh=population_mesh(["cpu"] * 4))
    result = portfolio_selftest(eng, count=6, pods_per_query=3)
    assert result["ok"] and result["max_drift"] == 0.0
    base = eng.base_pods
    queries = [_query(base, i) for i in range(6)]
    slots = [(2 * i) % 5 for i in range(6)]
    got = eng.answer_batch(queries, slots=slots)
    assert _key(got) == _key(portfolio.answer_batch(queries, slots=slots))
    assert {a["bucket_lanes"] for a in got} == {8}  # 2 lanes x 4 shards
    graphs = len(eng._graphs)
    old = eng.swap_slot(2, _champ(BETTER_LOGIC))
    eng.swap_slot(2, old)
    assert _key(eng.answer_batch(queries, slots=slots)) == _key(got)
    assert len(eng._graphs) == graphs


def test_cli_portfolio_selftest(capsys):
    from fks_tpu_torch import cli

    assert cli.main(["portfolio", "--cpu", "--devices", "2", "--engine",
                     "flat", "--selftest", "2", "--max-pods", "16"]) == 0
    out = capsys.readouterr().out
    result = json.loads(out[out.index("{"):])
    assert result["ok"] and result["max_drift"] == 0.0
    assert result["swap"]["compiles"] == 0 and not result["swap"]["errors"]
    assert result["n_slots"] == 5
