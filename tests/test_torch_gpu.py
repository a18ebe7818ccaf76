"""The fused CUDA kernel against its plain PyTorch version, the exact
engine's captured CUDA graphs against its CPU run, the policies' scores
and the scenario-suite path (trace batching, faults, the decision trace)
on the card against the CPU.

Marked ``gpu``: these need a CUDA card and skip without one. Run them on
the GPU machine with

    python -m pytest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The file imports only torch, so it runs where JAX is not installed. The
code-candidate tier (the funsearch VM against the transpiled policy), the
large-cluster tier (the prefilter, packed state, the segmented runner),
the code evaluator's graph per capacity bucket and the graph-timed
auto-prefilter probe are held here too, with the parametric score
kernel (csrc/param_score.cu) and the serve engines on the card. The
mesh cases run on logical shards of one card; serving across several
cards (every replay on its card's serving stream) needs two or more and
skips with fewer.
"""
import gc
import json
import pathlib

import pytest
import torch

from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.obs import tracing
from fks_tpu_torch.parallel import make_population_eval
from fks_tpu_torch.scenarios import get_suite, make_suite_eval
from fks_tpu_torch.sim import engine, fused
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    PARAM_SCORE_NODES, assert_result_matches, contended_workload,
    golden_micro_workload, param_score_cases, random_policy_views,
    result_fields, roomy_workload, tied_workload,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def assert_raw_equal(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["roomy", "contended", "tied"])
def test_kernel_matches_plain_version(cuda, case):
    if case == "roomy":
        wl, cfg, noise = roomy_workload(), SimConfig(track_ctime=False), 0.2
    elif case == "tied":
        wl, cfg, noise = tied_workload(), SimConfig(track_ctime=False), 0.5
    else:
        wl = contended_workload()
        cfg, noise = SimConfig(track_ctime=False, max_steps=4 * 96), 0.5
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = parametric.init_population(gen, 13, noise=noise)
    run = fused.make_fused_population_run(wl, cfg, device=cuda)
    before = fused.fused_sim.launches
    got = fused.fused_sim(run.plan, params)
    torch.cuda.synchronize()
    assert fused.fused_sim.launches == before + 1
    assert_raw_equal(got, fused.fused_sim_plain(run.plan, params))
    res = run(params)
    assert res.policy_score.shape == (13,)
    assert bool(torch.isfinite(res.policy_score).all())


def test_wrapper_rejects_bad_params(cuda):
    run = fused.make_fused_population_run(roomy_workload(), SimConfig(),
                                          device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused.fused_sim(run.plan, torch.zeros((4, 16), dtype=torch.float64,
                                              device=cuda))
    with pytest.raises(ValueError, match="float32"):
        fused.fused_sim(run.plan, torch.zeros((4, 15), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_sim(run.plan, torch.zeros((16, 4), device=cuda).t())


@pytest.mark.parametrize("case", ["golden_micro", "roomy"])
def test_exact_engine_on_card_matches_cpu(cuda, case):
    """best_fit in float64 through the exact engine: replayed CUDA graphs
    on the card, the eager loop on the CPU; integers exact, floats within
    the 2e-6 bar (reduction order may differ between the devices)."""
    wl = golden_micro_workload() if case == "golden_micro" else \
        roomy_workload()
    cfg = SimConfig(score_dtype=torch.float64)
    got = engine.simulate(wl, zoo.best_fit(torch.float64), cfg, device=cuda)
    want = engine.simulate(wl, zoo.best_fit(torch.float64), cfg,
                           device="cpu")
    assert got.policy_score.device.type == "cuda"
    assert_result_matches(got, result_fields(want))
    assert torch.equal(got.pod_ctime.cpu(), want.pod_ctime)


def test_exact_population_graph_is_reused_and_matches_cpu(cuda):
    """The population runner captures its graph at the first call and
    replays it at the next: both calls, with other allocations and a
    garbage collection in between, equal the CPU's eager runs."""
    wl, cfg = contended_workload(), SimConfig(max_steps=4 * 96)
    gen = torch.Generator(device=cuda).manual_seed(5)
    first = parametric.init_population(gen, 8, noise=0.5)
    second = parametric.init_population(gen, 8, noise=0.5)
    evaluate = make_population_eval(wl, cfg=cfg, device=cuda)
    got = [evaluate(first)]
    gc.collect()
    junk = [torch.randn(1 << 20, device=cuda) for _ in range(8)]
    got.append(evaluate(second))
    del junk
    assert len(evaluate.run.graphs) == 1
    cpu = make_population_eval(wl, cfg=cfg, device="cpu")
    for res, params in zip(got, (first, second)):
        assert_result_matches(res, result_fields(cpu(params.cpu())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_policy_scores_on_card_match_cpu(cuda, dtype):
    """Every zoo policy (funsearch_4800's ``** 2.5`` and ``** 0.6``
    included) and the parametric score give the CPU's integer scores on
    the card; the CPU's are held to fks_tpu by tests/test_torch_zoo.py."""
    pod, nodes, w = random_policy_views(7)
    card = (type(pod)(*(x.to(cuda) for x in pod)),
            type(nodes)(*(x.to(cuda) for x in nodes)))
    policies = {name: make(dtype) for name, make in {
        **zoo.ZOO, **zoo.BASELINE_FACTORIES,
        "micro_best_fit": zoo.micro_best_fit}.items()}
    for name, policy in policies.items():
        assert torch.equal(policy(*card).cpu(), policy(pod, nodes)), name
    got = parametric.score(w.to(cuda), *card, dtype=dtype).cpu()
    assert torch.equal(got, parametric.score(w, pod, nodes, dtype=dtype))


@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_suite_eval_on_card_matches_cpu(cuda, eng):
    """smoke3 (a fault lane included) at pop 4 through captured graphs,
    called twice (the second call replays the first call's graph), equals
    the CPU's eager runs; the decision trace of the fault lane too."""
    suite = get_suite("smoke3", synthetic_workload(4, 24, seed=3))
    gen = torch.Generator(device=cuda).manual_seed(9)
    pops = [parametric.init_population(gen, 4, noise=0.3) for _ in range(2)]
    evaluate = make_suite_eval(suite, population=True, engine=eng,
                               device=cuda)
    got = [evaluate(p) for p in pops]
    assert len(evaluate.graphs) == 1
    cpu = make_suite_eval(suite, population=True, engine=eng, device="cpu")
    for res, params in zip(got, pops):
        assert_result_matches(res, result_fields(cpu(params.cpu())))
    wl = suite.workloads[2]
    rows = [tracing.extract_trace(tracing.replay(
        wl, eng, parametric.score, pops[0][1].to(dev), device=dev))
        for dev in (cuda, "cpu")]
    assert rows[0] == rows[1]
    assert sum(r["kind"] in ("NODE_DOWN", "NODE_UP") for r in rows[0]) == 2


def _on(dev, nt):
    return type(nt)(*(x.to(dev) for x in nt))


def test_vm_on_card_equals_transpiled(cuda):
    """The funsearch VM's integer scores on the card equal the transpiled
    policy's on the card and on the CPU, for the two seeds and a
    champion, in float64 and float32; the CPU's are held to fks_tpu by
    tests/test_torch_vm.py and tests/test_torch_transpiler.py."""
    from fks_tpu_torch.funsearch import template, transpiler, vm

    champion = pathlib.Path(__file__).resolve().parent.parent / (
        "policies/discovered/funsearch_20260801_045536_score0.5365.json")
    codes = list(template.seed_policies().values()) + [
        json.loads(champion.read_text())["code"]]
    pod, nodes, _ = random_policy_views(4, lanes=64, gpu_heavy=True)
    card = (_on(cuda, pod), _on(cuda, nodes))
    for dtype in (torch.float64, torch.float32):
        for code in codes:
            want = transpiler.transpile(code, dtype=dtype)(pod, nodes)
            prog = vm.compile_policy(code, 16, 8, dtype=dtype)
            got = vm.score_static(_on(cuda, prog), *card).cpu()
            assert torch.equal(got, want)
            assert torch.equal(transpiler.transpile(code, dtype=dtype)(
                *card).cpu(), want)


def test_code_replay_on_card_matches_cpu(cuda):
    """A candidate replayed on the VM through ``policy_params(code=)``
    (a CPU program, moved to the card by the replay) traces the CPU's
    rows and scores the CPU's fitness."""
    from fks_tpu_torch.funsearch import template

    wl = synthetic_workload(3, 40, seed=0)
    fn, prog = tracing.policy_params(
        wl, code=template.seed_policies()["best_fit"], capacity=256)
    got, want = (tracing.replay(wl, "exact", fn, prog, device=dev)
                 for dev in (cuda, "cpu"))
    assert tracing.extract_trace(got) == tracing.extract_trace(want)
    assert float(got.policy_score) == float(want.policy_score)


@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_vm_suite_eval_on_card_matches_cpu(cuda, eng):
    """A stacked program population through the suite (trace-batch) path
    on the card: its captured graph holds one VM step
    (``vm.score_static.graph_steps``), and its results equal the CPU's."""
    from fks_tpu_torch.funsearch import template, vm

    suite = get_suite("smoke3", synthetic_workload(4, 24, seed=3))
    c = suite.workloads[0].cluster
    stacked = vm.stack_programs([
        vm.compile_policy(code, c.n_padded, c.g_padded)
        for code in template.seed_policies().values()])
    evaluate = make_suite_eval(suite, vm.score_static, population=True,
                               engine=eng, device=cuda)
    got = evaluate(stacked)
    assert [chunk.steps for chunk in evaluate.graphs.values()] == [1]
    want = make_suite_eval(suite, vm.score_static, population=True,
                           engine=eng, device="cpu")(stacked)
    assert_result_matches(got, result_fields(want), rtol=0, atol=0)

@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_prefilter_on_card_matches_cpu(cuda, eng):
    """node_prefilter_k (with state_pack, which the exact engine ignores)
    through captured graphs equals the CPU's run and the dense sweep, on
    a faulted smoke3 lane."""
    from fks_tpu_torch.sim import get_engine

    suite = get_suite("smoke3", synthetic_workload(4, 24, seed=3))
    wl = suite.workloads[2]
    mod = get_engine(eng)
    policy = zoo.ZOO["first_fit"]()
    cfg = SimConfig(node_prefilter_k=2, state_pack=True)
    got = mod.simulate(wl, policy, cfg, device=cuda)
    assert_result_matches(got, result_fields(
        mod.simulate(wl, policy, cfg, device="cpu")), rtol=0, atol=0)
    dense = mod.simulate(wl, policy, SimConfig(), device=cuda)
    assert torch.equal(got.assigned_node, dense.assigned_node)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_segmented_on_card_equals_unsegmented(cuda, double_buffer):
    """The segmented runner (graph replays, pinned flags behind events)
    equals the unsegmented runner on the card, twice in a row (the second
    run reuses the captured graph), with the prefilter and packing on."""
    from fks_tpu_torch.sim import flat

    wl = synthetic_workload(16, 96, seed=4).to(cuda)
    cfg = SimConfig(track_ctime=False, node_prefilter_k=4, state_pack=True)
    params = parametric.seed_weights("first_fit")[None].repeat(3, 1).to(cuda)
    base = flat.make_population_run_fn(wl, parametric.score, SimConfig(
        track_ctime=False))(params, flat.initial_state(wl, SimConfig(
            track_ctime=False)))
    run = flat.make_segmented_population_run(
        wl, parametric.score, cfg, seg_steps=40,
        double_buffer=double_buffer)
    for _ in range(2):
        seg = run(params, flat.initial_state(wl, cfg))
        assert_result_matches(seg, result_fields(base), rtol=0, atol=0)
    assert len(run.graphs) == 1


def _champions(n):
    root = pathlib.Path(__file__).resolve().parent.parent
    paths = sorted((root / "policies" / "discovered").glob("funsearch_*.json"))
    codes = [json.loads(p.read_text()).get("code") for p in paths]
    return [c for c in codes if c][:n]


def test_code_evaluator_captures_a_graph_per_capacity_bucket(cuda):
    """Two batched evaluations whose stacks fall in different capacity
    buckets (the seeds: 256; two champions: 512) each capture a graph of
    their own — no program is copied into another bucket's graph — and
    give the CPU's scores; so does the one-candidate tier."""
    from fks_tpu_torch.funsearch import CodeEvaluator, template

    wl = synthetic_workload(4, 24, seed=3)
    cfg = SimConfig(score_dtype=torch.float64)
    batches = [list(template.seed_policies().values()), _champions(2)]
    card = CodeEvaluator(wl, cfg)
    assert card.device.type == "cuda" and card.vm_batch
    cpu = CodeEvaluator(wl, cfg, device="cpu")
    wants = [[r.score for r in cpu.evaluate(codes)] for codes in batches]
    for codes, want in zip(batches + batches, wants + wants):
        # the second pass copies into the captured graphs and replays
        assert [r.score for r in card.evaluate(codes)] == want
        assert card.last_eval_stats["vm_batch_lanes"] == len(codes)
    caps = sorted(key[1][0][-1] for graphs in card._vm_pop_run.graphs
                  for key in graphs)
    assert caps == [256, 512] and card.vm_batch_fallbacks == 0
    assert card.vm_batch_count == 4
    for code in (batches[0][0], batches[1][0]):
        assert card.evaluate_one(code).score == cpu.evaluate_one(code).score
    assert sorted(key[1][0][-1] for key in card._vm_run.graphs) == [256, 512]


def test_probe_times_graph_replays(cuda):
    """``probe_policy_cost`` on the card times replays of a captured graph
    of the policy call, and the auto-prefilter turns on for the VM at
    N = 1,000 and stays off for the parametric policy (one launch of its
    kernel), as fks_tpu's decisions do."""
    from fks_tpu_torch.funsearch import template, vm

    n, g = 1000, 8
    prog = vm.compile_policy(template.seed_policies()["first_fit"], n, g,
                             capacity=256)
    cost = engine.probe_policy_cost(vm.score_static, prog, n, g,
                                    device=cuda)
    assert cost > engine.PREFILTER_COST_THRESHOLD_S
    assert engine.resolve_auto_prefilter(vm.score_static, prog, n, g,
                                         device=cuda) == 64
    first_fit = parametric.seed_weights("first_fit")
    cost = engine.probe_policy_cost(parametric.score, first_fit, n, g,
                                    device=cuda)
    assert 0 < cost <= engine.PREFILTER_COST_THRESHOLD_S
    assert engine.resolve_auto_prefilter(parametric.score, first_fit, n, g,
                                         device=cuda) == 0


@pytest.mark.parametrize("n", PARAM_SCORE_NODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_param_score_kernel_equals_plain_version(cuda, n, dtype):
    """csrc/param_score.cu against ``parametric.score_plain`` on the same
    card views and on the CPU: per-lane and shared weights, CPU and GPU
    pods, shared and per-lane node tables, and the cases of
    ``testing.param_score_cases`` (L in 1, 3, 256; G in 1, 8, 32;
    scattered masks, milli totals other than 1,000, unfit pods, strided
    views); one launch per call, counted."""
    for seed, heavy in ((0, False), (1, True)):
        pod, nodes, w = random_policy_views(seed, lanes=64, n=n,
                                            gpu_heavy=heavy)
        cp = type(pod)(*(x.to(cuda) for x in pod))
        cn = type(nodes)(*(x.to(cuda) for x in nodes))
        lane_nodes = type(nodes)(*(
            x.expand((64,) + tuple(x.shape)).contiguous()
            if x.shape[0] != 64 else x for x in cn))
        for weights in (w.to(cuda), w[5].to(cuda)):
            before = parametric.score.launches
            got = parametric.score(weights, cp, cn, dtype=dtype)
            assert parametric.score.launches == before + 1
            want = parametric.score_plain(weights, cp, cn, dtype=dtype)
            assert torch.equal(got, want)
            assert torch.equal(parametric.score(weights, cp, lane_nodes,
                                                dtype=dtype), want)
    for label, pod, nodes, w in param_score_cases(n):
        cp = type(pod)(*(x.to(cuda) for x in pod))
        cn = type(nodes)(*(x.to(cuda) for x in nodes))
        got = parametric.score(w.to(cuda), cp, cn, dtype=dtype)
        want = parametric.score_plain(w, pod, nodes, dtype=dtype)
        assert torch.equal(got.cpu(), want), label
        assert torch.equal(got, parametric.score_plain(w.to(cuda), cp, cn,
                                                       dtype=dtype)), label


def test_param_score_captures_in_a_graph(cuda):
    """The launch goes on the current stream, so it captures inside a CUDA
    graph, and a replay reads what was last written into the views."""
    pod, nodes, w = random_policy_views(2, lanes=16)
    cp = type(pod)(*(x.to(cuda) for x in pod))
    cn = type(nodes)(*(x.to(cuda) for x in nodes))
    w = w.to(cuda)
    parametric.score(w, cp, cn)  # build and warm up outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = parametric.score(w, cp, cn)
    pod2, nodes2, w2 = random_policy_views(9, lanes=16)
    for dst, src in zip((*cp, *cn, w), (*pod2, *nodes2, w2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), parametric.score_plain(w2, pod2, nodes2))


def _serve_setup(device):
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.serve import ChampionSpec, ShapeEnvelope

    code = template.fill_template(
        "score = 1000 + (node.cpu_milli_left - pod.cpu_milli) // 100")
    return (ChampionSpec(code=code, score=0.5),
            synthetic_workload(8, 16, seed=0),
            ShapeEnvelope(max_pods=16, min_pod_bucket=4, max_batch=4))


def _serve_queries():
    return [[{"cpu_milli": 10 + 7 * i + j, "memory_mib": 50 + 11 * j,
              "num_gpu": (i + j) % 2, "gpu_milli": 300 * ((i + j) % 3),
              "creation_time": j, "duration_time": 30 + i}
             for j in range(1 + i % 9)] for i in range(7)]


@pytest.mark.parametrize("kind", ["aot", "vm"])
def test_serve_answers_on_card_match_cpu(cuda, kind):
    """Both serve engines on the card answer as on the CPU (placements
    exact, scores within the engines' 2e-6), batched and unbatched."""
    from fks_tpu_torch.serve import ServeEngine, VMServeEngine

    cls = VMServeEngine if kind == "vm" else ServeEngine
    champ, wl, env = _serve_setup(cuda)
    card = cls(champ, wl, envelope=env, device=cuda)
    cpu = cls(champ, wl, envelope=env, device="cpu")
    queries = _serve_queries()
    for got, want in zip(card.answer_batch(queries),
                         cpu.answer_batch(queries)):
        assert got["placements"] == want["placements"]
        assert got["scheduled"] == want["scheduled"]
        assert abs(got["score"] - want["score"]) <= 2e-6
    ref = card.reference_answer(queries[3])
    assert ref["placements"] == cpu.reference_answer(queries[3])[
        "placements"]


def test_serve_warm_path_and_swap_capture_nothing(cuda):
    """After ``warmup`` a VM engine answers and swaps champions of its
    capacity bucket with zero graph captures, and the swapped engine
    answers as a fresh one."""
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.obs.telemetry import CompileWatcher
    from fks_tpu_torch.serve import ChampionSpec, VMServeEngine

    champ, wl, env = _serve_setup(cuda)
    eng = VMServeEngine(champ, wl, envelope=env, device=cuda)
    with CompileWatcher() as w:
        graphs = eng.warmup(lane_buckets=[1, 2, 4], pod_buckets=[4, 16])
    assert w.backend_compile_count == graphs == 6
    other = ChampionSpec(code=template.fill_template(
        "score = 2000 + (node.memory_mib_left - pod.memory_mib) // 1000"))
    queries = _serve_queries()
    with CompileWatcher() as w:
        eng.answer_batch(queries)
        eng.swap_program(other)
        swapped = eng.answer_batch(queries)
    assert w.backend_compile_count == 0
    fresh = VMServeEngine(other, wl, envelope=env, device=cuda)
    for a, b in zip(swapped, fresh.answer_batch(queries)):
        assert a["placements"] == b["placements"] and a["score"] == b["score"]


# ------------------------------------------------------ mesh, portfolio


@pytest.mark.parametrize("engine", ["exact", "fused"])
def test_sharded_eval_on_card_matches_unsharded(cuda, engine):
    """4 logical shards of the card give the unsharded eval's every
    field, and one launch of the fused kernel per shard."""
    from fks_tpu_torch.parallel import (
        make_sharded_eval, pad_population, population_mesh,
    )
    from fks_tpu_torch.parallel.mesh import top_k_real

    wl = contended_workload() if engine == "fused" else roomy_workload()
    cfg = SimConfig(track_ctime=False, max_steps=4 * 96) \
        if engine == "fused" else SimConfig(track_ctime=False)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    pop, real = pad_population(parametric.init_population(gen, 10,
                                                          noise=0.4), 4)
    want = make_population_eval(wl, cfg=cfg, engine=engine,
                                device=cuda)(pop)
    ev = make_sharded_eval(wl, population_mesh([cuda] * 4), cfg=cfg,
                           engine=engine, elite_k=3)
    fused.fused_sim.launches = 0
    scores, idx, _ = ev(pop, real)
    if engine == "fused":
        assert fused.fused_sim.launches == 4
    assert torch.equal(scores, want.policy_score)
    assert torch.equal(idx, top_k_real(want.policy_score, real, 3)[1])
    assert_result_matches(ev.results(pop), result_fields(want), rtol=0,
                          atol=0)


def test_sharded_serving_on_card_matches_cpu(cuda):
    """A VM engine on 2 logical shards of the card answers as the CPU
    engine, captures one graph per shard, and swaps with zero captures."""
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.obs.telemetry import CompileWatcher
    from fks_tpu_torch.parallel import population_mesh
    from fks_tpu_torch.serve import ChampionSpec, VMServeEngine

    champ, wl, env = _serve_setup(cuda)
    eng = VMServeEngine(champ, wl, envelope=env,
                        mesh=population_mesh([cuda] * 2))
    cpu = VMServeEngine(champ, wl, envelope=env, device="cpu")
    queries = _serve_queries()
    with CompileWatcher() as w:
        got = eng.answer_batch(queries)
    assert w.backend_compile_count == 2 * len(eng._graphs)
    for a, b in zip(got, cpu.answer_batch(queries)):
        assert a["placements"] == b["placements"]
        assert abs(a["score"] - b["score"]) <= 2e-6
    other = ChampionSpec(code=template.fill_template(
        "score = 2000 + (node.memory_mib_left - pod.memory_mib) // 1000"))
    with CompileWatcher() as w:
        eng.swap_program(other)
        swapped = eng.answer_batch(queries)
    assert w.backend_compile_count == 0
    fresh = VMServeEngine(other, wl, envelope=env, device="cpu")
    for a, b in zip(swapped, fresh.answer_batch(queries)):
        assert a["placements"] == b["placements"]


def test_portfolio_on_card_selftest_and_swap(cuda):
    """The portfolio on the card: the parity sweep holds with drift 0 and
    a slot swap captures nothing."""
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.obs.telemetry import CompileWatcher
    from fks_tpu_torch.portfolio import PortfolioEngine, portfolio_selftest
    from fks_tpu_torch.serve import ChampionSpec

    _, wl, env = _serve_setup(cuda)
    champs = [ChampionSpec(code=template.fill_template(lg), source=str(i))
              for i, lg in enumerate((
                  "score = 1000",
                  "score = node.cpu_milli_left - pod.cpu_milli",
                  "score = pod.cpu_milli - node.cpu_milli_left"))]
    eng = PortfolioEngine(champs, wl, envelope=env, n_slots=4, device=cuda)
    st = portfolio_selftest(eng, count=4, pods_per_query=3)
    assert st["ok"] and st["max_drift"] == 0.0
    queries = _serve_queries()[:4]
    eng.answer_batch(queries, slots=[1, 2, 3, 0])
    with CompileWatcher() as w:
        old = eng.swap_slot(1, champs[2])
        swapped = eng.answer_batch(queries, slots=[1] * 4)
        eng.swap_slot(1, old)
    assert w.backend_compile_count == 0
    assert swapped == eng.answer_batch(queries, slots=[2] * 4)


def _replay_streams(monkeypatch):
    """Record the current stream of each ``GraphedChunk`` replay's device
    as (device, stream) pairs."""
    seen = []
    real = engine.GraphedChunk.replay

    def spy(chunk):
        seen.append((chunk.device, torch.cuda.current_stream(chunk.device)))
        real(chunk)

    monkeypatch.setattr(engine.GraphedChunk, "replay", spy)
    return seen


def test_lane_jobs_stay_on_the_stream_they_were_started_on(cuda,
                                                           monkeypatch):
    """A population job started on one stream and drained while another
    stream is current replays (and reads its flags) on its own stream,
    and ends in the state of a job run on the default stream."""
    wl = roomy_workload().to(cuda)
    cfg = SimConfig(track_ctime=False)
    run = engine.make_population_run_fn(wl, parametric.score, cfg)
    state0 = engine.initial_state(wl, cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    pop = parametric.init_population(gen, 4, noise=0.3)
    want = run(pop, state0)
    seen = _replay_streams(monkeypatch)
    own, foreign = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    with torch.cuda.stream(own):
        job = run.start(pop, state0)
    with torch.cuda.stream(foreign):
        engine.drain([job])
    with torch.cuda.stream(own):
        got = run.finish(job)
    torch.cuda.synchronize()
    assert seen and all(stream == own for _, stream in seen)
    assert_result_matches(got, result_fields(want), rtol=0, atol=0)


def test_serve_batches_replay_on_the_engines_streams(cuda, monkeypatch):
    """``answer_batch`` called while a foreign stream is current runs
    every replay of a sharded engine (2 logical shards) on the engine's
    stream for that device, and answers as on the default stream."""
    from fks_tpu_torch.parallel import population_mesh
    from fks_tpu_torch.serve import ServeEngine

    champ, wl, env = _serve_setup(cuda)
    eng = ServeEngine(champ, wl, envelope=env,
                      mesh=population_mesh([cuda] * 2))
    queries = _serve_queries()
    want = eng.answer_batch(queries)
    seen = _replay_streams(monkeypatch)
    with torch.cuda.stream(torch.cuda.Stream(cuda)):
        got = eng.answer_batch(queries)
    assert seen and all(stream == eng._streams[dev] for dev, stream in seen)
    assert got == want


def test_serving_across_cards_matches_one_card(cuda, monkeypatch):
    """On a mesh of every card, with a foreign stream current on each,
    the AOT, VM and portfolio engines replay on each card's engine stream
    and answer as one card does, before and after a swap."""
    import contextlib

    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.parallel import population_mesh
    from fks_tpu_torch.parallel.mesh import cuda_devices
    from fks_tpu_torch.portfolio import PortfolioEngine
    from fks_tpu_torch.serve import ChampionSpec, ServeEngine, VMServeEngine

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    cards = cuda_devices()
    mesh = population_mesh(cards)
    champ, wl, env = _serve_setup(cuda)
    other = ChampionSpec(code=template.fill_template(
        "score = 2000 + (node.memory_mib_left - pod.memory_mib) // 1000"))
    queries = _serve_queries() * 2
    seen = _replay_streams(monkeypatch)

    def foreign():
        stack = contextlib.ExitStack()
        for d in cards:
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(d)))
        return stack

    def held(eng, one, **kw):
        seen.clear()
        with foreign():
            got = eng.answer_batch(queries, **kw)
        assert {dev for dev, _ in seen} == set(cards)
        assert all(stream == eng._streams[dev] for dev, stream in seen)
        assert got == [dict(a, bucket_lanes=b["bucket_lanes"])
                       for a, b in zip(one.answer_batch(queries, **kw), got)]

    for cls in (ServeEngine, VMServeEngine):
        held(cls(champ, wl, envelope=env, mesh=mesh),
             cls(champ, wl, envelope=env, device=cuda))
    many = VMServeEngine(champ, wl, envelope=env, mesh=mesh)
    one = VMServeEngine(champ, wl, envelope=env, device=cuda)
    for eng in (many, one):
        eng.answer_batch(queries)
        eng.swap_program(other)
    held(many, one)
    champs = [champ, other, ChampionSpec(code=template.fill_template(
        "score = pod.cpu_milli - node.cpu_milli_left"))]
    many = PortfolioEngine(champs, wl, envelope=env, n_slots=4, mesh=mesh)
    one = PortfolioEngine(champs, wl, envelope=env, n_slots=4, device=cuda)
    slots = [i % 3 for i in range(len(queries))]
    held(many, one, slots=slots)
    for eng in (many, one):
        eng.swap_slot(1, champs[2])
    held(many, one, slots=slots)


def test_sharded_eval_across_cards_matches_one_card(cuda):
    """``make_sharded_eval`` (exact engine) on a mesh of every card
    captures each shard's graph on its own card and gives the one-card
    eval's every field."""
    from fks_tpu_torch.parallel import (
        make_sharded_eval, pad_population, population_mesh,
    )
    from fks_tpu_torch.parallel.mesh import cuda_devices

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    wl, cfg = roomy_workload(), SimConfig(track_ctime=False)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    pop, real = pad_population(parametric.init_population(gen, 10,
                                                          noise=0.4),
                               torch.cuda.device_count())
    want = make_population_eval(wl, cfg=cfg, device=cuda)(pop)
    ev = make_sharded_eval(wl, population_mesh(cuda_devices()), cfg=cfg,
                           elite_k=3)
    scores, _, _ = ev(pop, real)
    assert torch.equal(scores, want.policy_score)
    assert_result_matches(ev.results(pop), result_fields(want), rtol=0,
                          atol=0)


# ------------------------------------------------------- control plane


def test_promotion_through_the_aot_path_while_serving(cuda, tmp_path):
    """``follow_ledger`` promotes a candidate through the AOT path — its
    shadow ladder and exact references captured on the poll thread while
    a client thread keeps querying the incumbent through the batcher: no
    query fails, every capture was the shadow's (none on the serving
    path; an invalidated capture raises, and the attempt would end
    REJECTED), and the promoted engine answers as the CPU does."""
    import threading
    import time

    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.obs.telemetry import CompileWatcher
    from fks_tpu_torch.pipeline import (
        PromotionConfig, PromotionController, follow_ledger, write_champion,
    )
    from fks_tpu_torch.serve import ChampionSpec, ServeEngine, ServeService

    champ, wl, env = _serve_setup(cuda)
    inc = ServeEngine(ChampionSpec(code=template.fill_template(
        "score = 1000"), score=0.4), wl, envelope=env, device=cuda)
    inc.warmup()
    service = ServeService(inc, max_wait_s=0.002)
    queries = _serve_queries()
    errors, answered, stop = [], [0], threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            try:
                ans = service.submit(
                    {"pods": queries[i % len(queries)]}).result(timeout=300)
                assert ans["scheduled"] >= 0
            except Exception as e:  # noqa: BLE001 — the test's verdict
                errors.append(f"{type(e).__name__}: {e}")
                return
            answered[0] += 1
            i += 1

    def wait_for(cond, seconds=600):
        deadline = time.monotonic() + seconds
        while not cond() and not errors and time.monotonic() < deadline:
            time.sleep(0.02)

    ctrl = PromotionController(service, wl, ledger_dir=str(tmp_path),
                               config=PromotionConfig(shadow_queries=4))
    with CompileWatcher() as w:
        thread = threading.Thread(target=client)
        thread.start()
        try:
            wait_for(lambda: answered[0] >= 8)
            stop_poll, poller = follow_ledger(ctrl, interval=0.05)
            write_champion(str(tmp_path), champ.code, 0.9)
            wait_for(lambda: service.swaps > 0)
            after = answered[0]
            wait_for(lambda: answered[0] >= after + 16)
            stop_poll.set()
            poller.join(timeout=300)
        finally:
            stop.set()
            thread.join(timeout=300)
    service.close()
    assert not errors, errors
    assert [r["state"] for r in ctrl.log.records] == [
        "PENDING", "SHADOW", "PROMOTED"]
    assert ctrl.log.records[-1]["engine_kind"] == "aot"
    assert service.engine is not inc and service.engine.champion.score == 0.9
    assert w.count_in("shadow") > 0
    assert w.count_in("") == 0, w.summary()
    cpu = ServeEngine(ChampionSpec(code=champ.code, score=0.9), wl,
                      envelope=env, device="cpu")
    for got, want in zip(service.engine.answer_batch(queries),
                         cpu.answer_batch(queries)):
        assert got["placements"] == want["placements"]
        assert abs(got["score"] - want["score"]) <= 2e-6


def test_sigterm_drain_with_a_batch_in_flight(cuda, tmp_path):
    """SIGTERM while the card works through queued batches: the drain
    completes every Future with the answer the CPU gives, sheds nothing,
    and persists a state that a new service preloads."""
    import os
    import signal
    import threading

    from fks_tpu_torch.resilience import DrainCoordinator, load_serve_state
    from fks_tpu_torch.serve import ServeEngine, ServeService

    champ, wl, env = _serve_setup(cuda)
    eng = ServeEngine(champ, wl, envelope=env, device=cuda)
    eng.warmup()
    service = ServeService(eng, max_wait_s=0.002)
    queries = _serve_queries() * 3
    futs = [service.submit({"id": f"q{i}", "pods": q})
            for i, q in enumerate(queries)]
    state = str(tmp_path / "state.json")
    dc = DrainCoordinator(service, state_path=state, grace_s=300.0)
    if threading.current_thread() is threading.main_thread():
        assert dc.install()
        try:
            os.kill(os.getpid(), signal.SIGTERM)
        finally:
            dc.uninstall()
    else:
        dc.handle_signal()
    assert dc.requested and all(f.done() for f in futs)
    assert dc.report["stuck"] is False and dc.report["shed"] == 0
    cpu = ServeEngine(champ, wl, envelope=env, device="cpu")
    for fut, want in zip(futs, cpu.answer_batch(queries)):
        got = fut.result()
        assert got["placements"] == want["placements"]
        assert abs(got["score"] - want["score"]) <= 2e-6
    saved = load_serve_state(state)
    assert saved["requests_served"] == len(queries)
    again = ServeService(eng, max_wait_s=0.002)
    try:
        assert again.preload_replay(saved["replay"]) == len(queries)
    finally:
        again.close()


def _cli(argv):
    """(exit code, stdout) of the port's ``cli.main(argv)``."""
    import contextlib
    import io

    from fks_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_cli_scale_fused_launches_the_kernel_once(cuda):
    before = fused.fused_sim.launches
    rc, out = _cli(["scale", "--engine", "fused", "--nodes-count", "16",
                    "--pods-count", "300", "--pop", "8", "--seed", "3"])
    torch.cuda.synchronize()
    assert rc == 0 and fused.fused_sim.launches == before + 1
    got = json.loads(out)
    gen = torch.Generator(device=cuda).manual_seed(3)
    pop = parametric.init_population(gen, 8, noise=0.1)
    res = make_population_eval(synthetic_workload(16, 300, seed=3),
                               engine="fused", device=cuda)(pop)
    assert got["score_min"] == round(float(res.policy_score.min()), 4)
    assert got["score_max"] == round(float(res.policy_score.max()), 4)
    assert got["mode"] == "vmap on 1 device" or torch.cuda.device_count() > 1


def test_cli_mem_sample_reports_device_watermarks(cuda):
    rc, out = _cli(["mem", "--sample"])
    rec = json.loads(out)
    assert rc == 0 and len(rec["devices"]) == torch.cuda.device_count()
    for row in rec["devices"]:
        assert row["platform"] == "gpu"
        assert row["bytes_limit"] == torch.cuda.get_device_properties(
            row["id"]).total_memory
        assert 0 <= row["bytes_in_use"] <= row["peak_bytes_in_use"]


def test_cli_mem_drill_vm_swap_leak_on_card(cuda):
    rc, out = _cli(["mem", "--drill", "vm_swap_leak", "--swaps", "4",
                    "--batches", "8"])
    res = json.loads(out)
    assert rc == 0 and res["ok"], res
    assert res["drift_count"] == 0 and res["drift_bytes"] == 0


def test_cli_evolve_profile_on_card_attributes_95pct(cuda, tmp_path,
                                                     monkeypatch):
    from fks_tpu_torch import cli

    monkeypatch.setattr(cli, "_parse_workload",
                        lambda args: synthetic_workload(8, 12, seed=0))
    run_dir = tmp_path / "run"
    rc, _ = _cli(["evolve", "--fake-llm", "--generations", "2",
                  "--profile", "--run-dir", str(run_dir)])
    assert rc == 0
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    prof = [r for r in rows if r["kind"] == "device_profile"]
    total = [r for r in prof if r["stage"] == "__total__"]
    assert len(total) == 1 and total[0]["attributed_fraction"] >= 0.95
    assert {"setup", "seed", "codegen", "rank", "ledger",
            "device-eval"} <= {r["stage"] for r in prof}
    # the batched tier's first launch of each bucket priced its graphs
    fps = [r for r in rows if r["kind"] == "memory_footprint"]
    assert fps and all(r["component"] == "evolve" for r in fps)
