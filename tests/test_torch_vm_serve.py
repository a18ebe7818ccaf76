"""The port's VM-native serving (``VMServeEngine``) against fks_tpu's, on
the CPU.

fks_tpu's tests/test_vm_serve.py fixture in both packages:
``synthetic_workload(8, 16, seed=0)``, ``ShapeEnvelope(max_pods=8,
min_pod_bucket=8, max_batch=2)``, the flat engine. Answers: placements and
scheduled counts identical, scores within ``SCORE_TOL`` (2e-6, the port's
float32 engine bar; observed equal). The champion is a static input of
the graphs, so a swap rebuilds nothing: ``cold_compiles`` stays put and
the swapped engine answers as a fresh engine on the new champion, and as
fks_tpu's swapped engine does.
"""
import threading

import numpy as np
import pytest

from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.serve import ChampionSpec as JaxChampionSpec
from fks_tpu.serve import ShapeEnvelope as JaxShapeEnvelope
from fks_tpu.serve import VMServeEngine as JaxVMServeEngine
from fks_tpu_torch.funsearch import template, vm
from fks_tpu_torch.obs.recorder import NullRecorder
from fks_tpu_torch.obs.telemetry import CompileWatcher
from fks_tpu_torch.serve import (
    ChampionSpec, ServeEngine, ServeService, ShapeEnvelope, VMServeEngine,
    pack_program_tables, unpack_program_tables,
)
from fks_tpu_torch.serve.batcher import to_tensor
from fks_tpu_torch.sim.engine import graph_key
from fks_tpu_torch.testing import one_torch_thread, port_workload

SCORE_TOL = 2e-6
SEED_LOGIC = "score = 1000"
BETTER_LOGIC = ("score = 1000 + (node.cpu_milli_left - pod.cpu_milli) "
                "// 100")
EVEN_BETTER_LOGIC = ("score = 2000 + (node.memory_mib_left - "
                     "pod.memory_mib) // 1000")
UNSUPPORTED_LOGIC = ("gpus = sorted(g.gpu_milli_left for g in node.gpus)\n"
                     "    return max(1, gpus[0]) if pod.num_gpu == 0 "
                     "else 1")


class Rec(NullRecorder):
    enabled = True

    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append({"kind": kind, **fields})


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _champ(logic, score=0.5, source="<test>", cls=ChampionSpec):
    return cls(code=template.fill_template(logic), score=score,
               source=source)


def _query(i, n=3):
    return [{"cpu_milli": 10 + 7 * i + j, "memory_mib": 50 + 11 * j,
             "num_gpu": (i + j) % 2, "gpu_milli": 300 * ((i + j) % 3),
             "creation_time": j, "duration_time": 30 + i}
            for j in range(n)]


@pytest.fixture(scope="module")
def jwl():
    return jax_synthetic(8, 16, seed=0)


@pytest.fixture(scope="module")
def wl(jwl):
    return port_workload(jwl)


def _env(cls=ShapeEnvelope):
    return cls(max_pods=8, min_pod_bucket=8, max_batch=2,
               max_gpu_milli=1000)


def _vm(logic, wl, **kw):
    return VMServeEngine(_champ(logic, **kw), wl, envelope=_env(),
                         engine="flat", device="cpu")


def _jvm(logic, jwl, **kw):
    return JaxVMServeEngine(_champ(logic, cls=JaxChampionSpec, **kw), jwl,
                            envelope=_env(JaxShapeEnvelope), engine="flat")


def assert_answers_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["placements"] == b["placements"]
        assert a["scheduled"] == b["scheduled"]
        assert abs(a["score"] - b["score"]) <= SCORE_TOL


def test_pack_program_tables_round_trip():
    prog = vm.compile_policy(template.fill_template(BETTER_LOGIC), 8, 2)
    packed = pack_program_tables(prog)
    assert packed[0].shape == (4, prog.capacity)  # ONE op-table buffer
    assert packed[0].dtype == np.int32 and packed[3].shape == (2,)
    back = unpack_program_tables(tuple(to_tensor(x) for x in packed))
    for a, b in zip(prog, back):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pack_portfolio_tables_round_trip():
    """N programs ride one stacked wire tuple; unpacking gives the stacked
    program ``vm.select_slot`` gathers from."""
    from fks_tpu_torch.serve.batcher import (
        pack_portfolio_tables, unpack_portfolio_tables,
    )

    progs = [vm.pad_capacity(vm.compile_policy(
        template.fill_template(logic), 8, 2), 128)
        for logic in (SEED_LOGIC, BETTER_LOGIC, EVEN_BETTER_LOGIC)]
    packed = pack_portfolio_tables(progs)
    assert packed[0].shape == (3, 4, 128) and packed[3].shape == (3, 2)
    stacked = unpack_portfolio_tables(tuple(to_tensor(x) for x in packed))
    for slot, prog in enumerate(progs):
        for a, b in zip(vm.select_slot(stacked, slot), prog):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_vm_engine_binds_champion_as_data(wl, jwl):
    eng, jeng = _vm(BETTER_LOGIC, wl), _jvm(BETTER_LOGIC, jwl)
    assert eng.engine_kind == "vm" and eng.policy_tier == "vm"
    assert eng.program_capacity == jeng.program_capacity
    assert eng.program_capacity >= int(eng.params.n_ops)
    with pytest.raises(vm.VMUnsupported):
        _vm(UNSUPPORTED_LOGIC, wl)


def test_vm_answers_match_fks_tpu_and_the_closure_engine(wl, jwl):
    eng, jeng = _vm(BETTER_LOGIC, wl), _jvm(BETTER_LOGIC, jwl)
    aot = ServeEngine(_champ(BETTER_LOGIC), wl, envelope=_env(),
                      engine="flat", device="cpu")
    queries = [_query(i, 1 + i % 8) for i in range(5)]
    got = eng.answer_batch(queries)
    assert_answers_match(got, jeng.answer_batch(queries))
    assert_answers_match(got, aot.answer_batch(queries))
    logic = "score = 3 * node.cpu_milli_left - 2 * pod.cpu_milli"
    a = ServeEngine(_champ(logic), wl, envelope=_env(), engine="flat",
                    device="cpu")
    b = _vm(logic, wl)
    for pa, pb in zip(a.answer_batch(queries[:3]),
                      b.answer_batch(queries[:3])):
        assert pa["score"] == pb["score"]  # integer contract: exact
        assert pa["placements"] == pb["placements"]


def test_swap_program_captures_nothing_and_matches(wl, jwl):
    """Swap, re-answer, roll back: no new bucket graph, the answers of a
    fresh engine on the new champion, and fks_tpu's swapped answers."""
    rec = Rec()
    eng = VMServeEngine(_champ(SEED_LOGIC, 0.4, source="<old>"), wl,
                        envelope=_env(), engine="flat", device="cpu",
                        recorder=rec)
    jeng = _jvm(SEED_LOGIC, jwl, score=0.4, source="<old>")
    queries = [_query(40), _query(41, 5)]
    before = eng.answer_batch(queries)
    built = eng.cold_compiles
    with CompileWatcher() as w:
        old = eng.swap_program(_champ(BETTER_LOGIC, 0.9, source="<new>"))
        swapped = eng.answer_batch(queries)
    assert w.backend_compile_count == 0 and eng.cold_compiles == built
    assert old.source == "<old>" and eng.champion.source == "<new>"
    jeng.swap_program(_champ(BETTER_LOGIC, 0.9, cls=JaxChampionSpec))
    assert_answers_match(swapped, jeng.answer_batch(queries))
    assert_answers_match(swapped, _vm(BETTER_LOGIC, wl).answer_batch(queries))
    assert eng.vm_swaps == 1 and eng.vm_swap_h2d_bytes > 0
    bd = eng.last_swap_breakdown
    assert bd["capacity"] == eng.program_capacity and bd["h2d_bytes"] > 0
    eng.swap_program(old)  # rolling back is another swap_program
    assert_answers_match(eng.answer_batch(queries), before)
    assert [e["outcome"] for e in rec.events if e["kind"] == "vm_swap"] \
        == ["swapped", "swapped"]


def test_graphs_keyed_by_program_shape(wl):
    """Graphs are keyed by the pod bucket and ``graph_key``: another
    capacity bucket's programs never replay a graph of other buffers."""
    small = VMServeEngine(_champ(SEED_LOGIC), wl, envelope=_env(),
                          engine="flat", device="cpu", program_capacity=256)
    big = VMServeEngine(_champ(SEED_LOGIC), wl, envelope=_env(),
                        engine="flat", device="cpu", program_capacity=512)
    small.warmup(lane_buckets=[1])
    big.warmup(lane_buckets=[1])
    (ks,), (kb,) = small._graphs, big._graphs
    assert ks == (8,) + graph_key(1, small._graph_program())
    assert ks != kb and kb[1:] == graph_key(1, big._graph_program())
    q = [_query(3)]
    assert small.answer_batch(q)[0]["placements"] == \
        big.answer_batch(q)[0]["placements"]


def test_transpile_cache_makes_reswap_warm(wl, jwl):
    """The miss/hit sequence of fks_tpu's host-side transpile cache."""
    out = []
    for eng, cls in ((_vm(SEED_LOGIC, wl, score=0.4), ChampionSpec),
                     (_jvm(SEED_LOGIC, jwl, score=0.4), JaxChampionSpec)):
        seq = []
        for logic in (BETTER_LOGIC, BETTER_LOGIC, SEED_LOGIC):
            eng.swap_program(_champ(logic, 0.9, cls=cls))
            bd = eng.last_swap_breakdown
            seq.append((bd["transpile_cache"], bd["transpile_cache_hits"],
                        bd["transpile_cache_misses"]))
        out.append(seq)
    assert out[0] == out[1] == [("miss", 0, 1), ("hit", 1, 1),
                                ("hit", 2, 1)]


def test_unsupported_is_never_cached(wl):
    eng = _vm(SEED_LOGIC, wl)
    bad = _champ(UNSUPPORTED_LOGIC, 0.9)
    for _ in range(2):
        with pytest.raises(vm.VMUnsupported):
            eng.swap_program(bad)
    assert eng.transpile_cache_misses == 0 and eng.transpile_cache_hits == 0


def test_shadow_shares_graphs_and_keeps_its_own_champion(wl):
    """A shadow view replays the incumbent's graphs with its own tables;
    the incumbent's next batch finds its own tables again, and promoting
    the shadowed champion is a warm swap."""
    eng = _vm(SEED_LOGIC, wl, score=0.4)
    queries = [_query(50, 4), _query(51, 2)]
    inc = eng.answer_batch(queries)
    cand = _champ(BETTER_LOGIC, 0.9, source="<cand>")
    shadow = eng.shadow_for(cand)
    built = eng.cold_compiles
    assert_answers_match(shadow.answer_batch(queries),
                         _vm(BETTER_LOGIC, wl).answer_batch(queries))
    assert_answers_match(eng.answer_batch(queries), inc)
    assert eng.cold_compiles == built and shadow._graphs is eng._graphs
    eng.swap_program(cand)
    assert eng.last_swap_breakdown["transpile_cache"] == "hit"


def test_overlapped_transpile_warms_the_next_swap(wl):
    eng = _vm(SEED_LOGIC, wl)
    cand = _champ(EVEN_BETTER_LOGIC, 0.9)
    eng.begin_overlapped_transpile(cand).join(timeout=60)
    eng.swap_program(cand)
    bd = eng.last_swap_breakdown
    assert bd["transpile_cache"] == "hit" and bd["transpile_overlapped"]
    eng.swap_program(_champ(SEED_LOGIC))
    assert not eng.last_swap_breakdown["transpile_overlapped"]


def test_service_swap_engine_routes_championspec(wl):
    eng = _vm(SEED_LOGIC, wl, score=0.4, source="<old>")
    service = ServeService(eng, max_wait_s=0.002)
    try:
        old = service.swap_engine(_champ(BETTER_LOGIC, 0.9))
        assert isinstance(old, ChampionSpec) and old.source == "<old>"
        assert service.engine is eng and service.swaps == 1
        summary = service.summary()
        assert summary["engine_kind"] == "vm"
        assert summary["program_capacity"] == eng.program_capacity
        assert summary["vm_swaps"] == 1 and summary["vm_swap_h2d_bytes"] > 0
        plain = ServeEngine(_champ(SEED_LOGIC), wl, envelope=_env(),
                            engine="flat", device="cpu")
        service.swap_engine(plain)
        with pytest.raises(TypeError):
            service.swap_engine(_champ(BETTER_LOGIC, 0.9))
    finally:
        service.close()


def test_vm_artifacts_round_trip_and_cross_over(tmp_path, wl, jwl):
    """The port's VM artifact loads as a VMServeEngine, and so does
    fks_tpu's; both answer as the engine that saved it."""
    queries = [_query(80), _query(81)]
    eng = _vm(BETTER_LOGIC, wl)
    eng.save(str(tmp_path / "port"))
    jeng = _jvm(BETTER_LOGIC, jwl)
    jeng.save(str(tmp_path / "jax"))
    for d, src in (("port", eng), ("jax", jeng)):
        loaded = ServeEngine.load(str(tmp_path / d), device="cpu")
        assert isinstance(loaded, VMServeEngine)
        assert loaded.program_capacity == src.program_capacity
        assert_answers_match(loaded.answer_batch(queries),
                             src.answer_batch(queries))


def test_concurrent_swap_never_tears_a_batch(wl):
    """``swap_program`` racing ``answer_batch`` threads: every answer set
    is one champion's, never a torn mix."""
    champs = [_champ("score = node.cpu_milli_left - pod.cpu_milli",
                     0.4, source="<a>"),
              _champ("score = pod.cpu_milli - node.cpu_milli_left",
                     0.9, source="<b>")]
    eng = VMServeEngine(champs[0], wl, envelope=_env(), engine="flat",
                        device="cpu")
    queries = [_query(7), _query(11)]
    refs = [VMServeEngine(c, wl, envelope=_env(), engine="flat",
                          device="cpu").answer_batch(queries)
            for c in champs]
    assert refs[0][0]["placements"] != refs[1][0]["placements"]
    seen, errors = [], []

    def serve():
        try:
            for _ in range(4):
                seen.append(eng.answer_batch(queries))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=serve) for _ in range(2)]
    for t in threads:
        t.start()
    for i in range(4):
        eng.swap_program(champs[(i + 1) % 2])
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(seen) == 8
    for ans in seen:
        assert any(all(a["placements"] == r["placements"]
                       for a, r in zip(ans, ref)) for ref in refs)
