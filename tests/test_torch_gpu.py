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
auto-prefilter probe are held here too.
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
    assert_result_matches, contended_workload, golden_micro_workload,
    random_policy_views, result_fields, roomy_workload, tied_workload,
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
    caps = sorted(key[1][0][-1] for key in card._vm_pop_run.graphs)
    assert caps == [256, 512] and card.vm_batch_fallbacks == 0
    assert card.vm_batch_count == 4
    for code in (batches[0][0], batches[1][0]):
        assert card.evaluate_one(code).score == cpu.evaluate_one(code).score
    assert sorted(key[1][0][-1] for key in card._vm_run.graphs) == [256, 512]


def test_probe_times_graph_replays(cuda):
    """``probe_policy_cost`` on the card times replays of a captured graph
    of the policy call, and the auto-prefilter turns on for the VM at
    N = 1,000, as fks_tpu's decision does."""
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
    assert engine.probe_policy_cost(parametric.score, first_fit, n, g,
                                    device=cuda) > 0
