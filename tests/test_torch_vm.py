"""fks_tpu_torch.funsearch.vm vs fks_tpu's.

(i) Programs fks_tpu lowered, carried across with
    ``convert.vm_program_from_numpy``, score on the port's executor
    exactly as fks_tpu's ``vm.score`` does.
(ii) The port's own lowering accepts the whole corpus fks_tpu lowers (the
    two seeds, 30 FakeLLM(seed=3) candidates, the 13 champions); its
    scores equal the port's transpiled policy and fks_tpu's VM, in float64
    and float32 (against the transpiled tier); constant-pool overflow and
    sorted() raise ``VMUnsupported``; signed zero survives the pool.
(iii) ``pad_capacity``, ``stack_programs``, ``select_slot``,
    ``capacity_bucket`` and ``bucket_lanes`` match fks_tpu's.
(iv) A stacked code population through both engines equals fks_tpu's
    ``make_population_run_fn(wl, vm.score_static, cfg)``, and through a
    scenario suite each candidate's row equals it alone.
(v) The phase-9 pins (tests/fixtures/vm_prefix512_pins.json, the first
    512 pods of the default trace): fks_tpu's VM population equals them
    (slow: about two minutes of XLA on the CPU), and so does the port's
    transpiled tier for the first_fit seed and the 0.5365 champion (the
    port's eager VM over some 1,000 steps is held on the card instead).
(vi) ``render_code`` strings and ``policy_params(code=)`` match fks_tpu.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.funsearch import vm as jvm
from fks_tpu.funsearch.backend import CodeEvaluator as JaxCodeEvaluator
from fks_tpu.models import parametric as jparametric
from fks_tpu.obs import tracing as jtracing
from fks_tpu.sim import engine as jengine
from fks_tpu.sim import flat as jflat
from fks_tpu_torch.convert import vm_program_from_numpy
from fks_tpu_torch.data import TraceParser
from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.funsearch import template, transpiler, vm
from fks_tpu_torch.funsearch.backend import CodeEvaluator
from fks_tpu_torch.models import parametric
from fks_tpu_torch.obs import tracing
from fks_tpu_torch.sim import get_engine
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, port_workload, result_fields,
)
from tests.test_torch_scale import jax_make_workload_prefix
from tests.test_torch_policies import port_views, random_views
from tests.test_torch_transpiler import (
    champions, fake_llm_candidates, jax_scores,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINS = json.loads((ROOT / "tests" / "fixtures"
                   / "vm_prefix512_pins.json").read_text())
N, G = 16, 8
LANES = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def corpus():
    return (list(template.seed_policies().values()) + fake_llm_candidates()
            + champions())


def draw(seed):
    """``LANES`` lanes of a random-views draw, as numpy and port views."""
    view, pod, _ = random_views(seed, gpu_heavy=seed % 2 == 1)
    view = {k: v[:LANES] if k in ("cpu_left", "mem_left", "gpu_left", "gml")
            else v for k, v in view.items()}
    pod = {k: v[:LANES] for k, v in pod.items()}
    return view, pod, port_views(view, pod)


def from_fks(prog):
    return vm_program_from_numpy([np.asarray(x) for x in prog])


def jax_vm_scores(prog, view, pod):
    return jax_scores(lambda p, n: jvm.score(prog, p, n), view, pod)


# ------------------------------------------------ (i) fks_tpu's programs

@pytest.mark.parametrize("part", range(3))
def test_fks_tpu_programs_run_unchanged(part):
    codes = corpus()[part::3][::4]
    view, pod, (pv, nodes) = draw(part)
    for code in codes:
        jprog = jvm.compile_policy(code, N, G, capacity=512)
        prog = from_fks(jprog)
        assert prog.capacity == 512 and prog.dtype == torch.float64
        want = jax_vm_scores(jprog, view, pod)
        np.testing.assert_array_equal(vm.score(prog, pv, nodes).numpy(),
                                      want)
        # (ii) the port's own lowering of the same source: same scores
        mine = vm.compile_policy(code, N, G)
        np.testing.assert_array_equal(vm.score(mine, pv, nodes).numpy(),
                                      want)


def test_vm_program_from_numpy_forms():
    jprog = jvm.compile_policy(template.seed_policies()["best_fit"], N, G)
    leaves = {k: np.asarray(v) for k, v in jprog._asdict().items()}
    a = vm_program_from_numpy(leaves)
    b = vm_program_from_numpy(list(leaves.values()), dtype=torch.float32)
    assert a.opcode.dtype == torch.int32 and a.imm.dtype == torch.float64
    assert b.consts.dtype == torch.float32
    for x, y in zip(a, b):
        assert torch.equal(x.to(y.dtype), y)
    with pytest.raises(ValueError, match="expected 8"):
        vm_program_from_numpy(list(leaves.values())[:3])


# --------------------------------------------------- (ii) own lowering

def test_own_lowering_accepts_the_corpus():
    """Every candidate fks_tpu lowers, the port lowers too (fks_tpu needs
    capacity 512 for the champions, 256 for the rest)."""
    for code in corpus():
        prog = vm.compile_policy(code, N, G)
        assert int(prog.n_ops) <= prog.capacity <= 512


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_own_lowering_equals_transpiled(dtype):
    """Each candidate on its lanes of a stacked program (lane l runs
    candidate l % 45): the VM's scores equal the transpiled policy's."""
    codes = corpus()
    progs = vm.stack_programs([vm.compile_policy(c, N, G, dtype=dtype)
                               for c in codes], capacity=512)
    for seed in (2, 3):
        _, _, (pv, nodes) = draw(seed)
        which = torch.arange(LANES) % len(codes)
        got = vm.score_static(vm.select_slot(progs, which), pv, nodes)
        for i, code in enumerate(codes):
            rows = which == i
            if not bool(rows.any()):
                continue
            want = transpiler.transpile(code, dtype=dtype)(pv, nodes)[rows]
            assert torch.equal(got[rows], want), i


def test_const_pool_overflow_and_sorted_are_unsupported():
    terms = " + ".join(f"node.cpu_milli_left * {i + 1}.5" for i in range(40))
    code = template.fill_template(f"score = {terms}")
    with pytest.raises(jvm.VMUnsupported, match="constants"):
        jvm.compile_policy(code, N, G)
    with pytest.raises(vm.VMUnsupported, match="constants"):
        vm.compile_policy(code, N, G)
    hard = template.fill_template(
        "gpus = sorted(g.gpu_milli_left for g in node.gpus)\n"
        "    score = max(1, gpus[0]) if pod.num_gpu == 0 else 1")
    transpiler.transpile(hard)  # transpilable, but not VM-able
    with pytest.raises(vm.VMUnsupported):
        vm.compile_policy(hard, N, G)


@pytest.mark.parametrize("logic", [
    "score = node.cpu_milli_left // max(1, pod.cpu_milli) "
    "+ node.memory_mib_left % 7 - (pod.cpu_milli - 9000) // 7",
    "score = (-node.gpu_left) % 3 + node.gpu_left ** 3 "
    "+ 2 ** pod.num_gpu + abs(pod.cpu_milli - 4000) // 3",
    "score = math.sqrt(1 + node.cpu_milli_left) * math.log(2 + pod.num_gpu)"
    " + math.exp(pod.num_gpu) + min(5, node.gpu_left) * 0.5",
])
def test_integer_division_and_math_lower_exactly(logic):
    """Python's ``//``, ``%`` and ``**`` on integers and the math
    functions, beyond the corpus: the VM equals the transpiled policy."""
    code = template.fill_template(logic)
    prog = vm.compile_policy(code, N, G)
    for seed in (6, 7):
        _, _, (pv, nodes) = draw(seed)
        assert torch.equal(vm.score(prog, pv, nodes),
                           transpiler.transpile(code)(pv, nodes))


def test_signed_zero_survives_the_pool():
    code = template.fill_template(
        "a = pod.num_gpu * -0.0\n"
        "    b = pod.num_gpu * 0.0\n"
        "    score = (100.0 if 1.0 / a < 0 else 200.0) "
        "+ (10.0 if 1.0 / b < 0 else 20.0)")
    prog = vm.compile_policy(code, N, G)
    pool = prog.consts[: int((prog.consts != 0).sum()) + 2].tolist()
    assert any(str(v) == "-0.0" for v in prog.consts.tolist())
    view, pod, (pv, nodes) = draw(4)
    want = transpiler.transpile(code)(pv, nodes)
    assert torch.equal(vm.score(prog, pv, nodes), want)
    jprog = jvm.compile_policy(code, N, G)
    np.testing.assert_array_equal(want.numpy(),
                                  jax_vm_scores(jprog, view, pod))
    assert pool  # the pool holds the literals


# ---------------------------------------------- (iii) table plumbing

def test_capacity_bucket_and_bucket_lanes():
    for n in (0, 1, 63, 64, 65, 200, 343, 512, 513):
        assert vm.capacity_bucket(n) == jvm.capacity_bucket(n)
    for n in (0, 1, 2, 3, 15, 16, 17, 45):
        for m in (1, 2, 3, 8):
            assert vm.bucket_lanes(n, m) == jvm.bucket_lanes(n, m)


def test_pad_stack_select_match_fks_tpu():
    codes = list(template.seed_policies().values()) + fake_llm_candidates(3)
    jprogs = [jvm.compile_policy(c, N, G) for c in codes]
    progs = [from_fks(p) for p in jprogs]
    jst, st = jvm.stack_programs(jprogs), vm.stack_programs(progs)
    for x, y in zip(st, jst):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for slot in (0, 3):
        for x, y in zip(vm.select_slot(st, slot), jvm.select_slot(jst, slot)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for cap in (256, 1024):
        for x, y in zip(vm.pad_capacity(progs[0], cap),
                        jvm.pad_capacity(jprogs[0], cap)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    with pytest.raises(vm.VMUnsupported, match="too long"):
        vm.pad_capacity(progs[0], 64)
    with pytest.raises(ValueError):
        vm.stack_programs([])
    # padding is semantically neutral: score over the live ops equals
    # score_static over twice the capacity
    _, _, (pv, nodes) = draw(5)
    padded = vm.pad_capacity(progs[1], 2 * progs[1].capacity)
    assert torch.equal(vm.score(progs[1], pv, nodes),
                       vm.score_static(padded, pv, nodes))


# ---------------------------------------------- (iv) the population path

@pytest.mark.parametrize("name,jmod", [("exact", jengine), ("flat", jflat)])
def test_stacked_population_matches_fks_tpu(name, jmod):
    """Four code candidates (the seeds and two FakeLLM candidates) as one
    stacked population on a contended workload: every field equals
    fks_tpu's VM population, and each lane equals its candidate alone
    through the transpiled tier."""
    codes = (list(template.seed_policies().values())
             + fake_llm_candidates(8)[5:7])
    jwl = jax_synthetic(3, 40, seed=0)
    wl = synthetic_workload(3, 40, seed=0)
    n, g = wl.cluster.n_padded, wl.cluster.g_padded
    stacked = vm.stack_programs([vm.compile_policy(c, n, g) for c in codes],
                                capacity=256)
    mod = get_engine(name)
    cfg = SimConfig(score_dtype=torch.float64)
    got = mod.make_population_run_fn(wl, vm.score_static, cfg)(
        stacked, mod.initial_state(wl, cfg))
    jst = jvm.stack_programs([jvm.compile_policy(c, n, g) for c in codes],
                             capacity=256)
    jcfg = jengine.SimConfig(score_dtype=jnp.float64)
    ref = jax.jit(jmod.make_population_run_fn(jwl, jvm.score_static, jcfg))(
        jst, jmod.initial_state(jwl, jcfg))
    assert_result_matches(got, result_fields(ref), rtol=1e-9, atol=1e-9)
    assert len(set(got.policy_score.tolist())) > 1  # the lanes differ
    for lane in (0, 3):
        alone = mod.simulate(wl, transpiler.transpile(codes[lane]), cfg,
                             device="cpu")
        assert float(alone.policy_score) == float(got.policy_score[lane])
        assert torch.equal(alone.assigned_node, got.assigned_node[lane])


def test_stacked_programs_over_a_scenario_suite():
    """A stacked program population through the suite (trace-batch) path:
    candidate c's row of the [C, T] result equals candidate c alone on
    the transpiled tier, fault scenario included."""
    from fks_tpu_torch.scenarios import get_suite, make_suite_eval

    suite = get_suite("smoke3", synthetic_workload(4, 24, seed=3))
    wl = suite.workloads[0]
    codes = list(template.seed_policies().values())
    stacked = vm.stack_programs([
        vm.compile_policy(c, wl.cluster.n_padded, wl.cluster.g_padded)
        for c in codes])
    got = make_suite_eval(suite, vm.score_static, population=True,
                          device="cpu")(stacked)
    assert got.policy_score.shape == (2, 3)
    for c, code in enumerate(codes):
        policy = transpiler.transpile(code)
        alone = make_suite_eval(suite, lambda _p, pod, nodes, f=policy:
                                f(pod, nodes), device="cpu")(None)
        assert torch.equal(got.policy_score[c], alone.policy_score)
        assert torch.equal(got.assigned_node[c], alone.assigned_node)


@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_bound_step_carries_the_policys_graph_steps(eng):
    """``engine.bind_step``, through which every runner builds its step,
    hands the policy's ``graph_steps`` to the step, which ``GraphedChunk``
    reads: one VM step per captured graph, ``SYNC_EVERY`` otherwise."""
    from fks_tpu_torch.sim import engine

    mod = get_engine(eng)
    wl = synthetic_workload(3, 8, seed=0)
    cfg = SimConfig()
    kt, max_steps = mod.loop_tables(wl, cfg)
    prog = vm.compile_policy(template.seed_policies()["first_fit"],
                             wl.cluster.n_padded, wl.cluster.g_padded)
    for policy, params, steps in (
            (vm.score_static, prog, 1),
            (parametric.score, parametric.seed_weights("first_fit"),
             engine.SYNC_EVERY)):
        step = engine.bind_step(mod.build_step, wl, policy, params, cfg, kt,
                                max_steps)
        assert step.params is params
        assert engine.graph_steps(step) == steps


# ------------------------------------------------ (v) the phase-9 pins

def pin_codes():
    return (list(template.seed_policies().values())
            + [json.loads((ROOT / "policies" / "discovered" / f)
                          .read_text())["code"]
               for f in PINS["lanes"][2:-1]])


def test_pins_fixture_describes_phase_9():
    assert PINS["pods"] == 512 and PINS["capacity"] == 512
    assert len(PINS["lanes"]) == vm.bucket_lanes(15) == 16
    assert PINS["lanes"][-1] == PINS["lanes"][-2]
    for eng in ("exact", "flat"):
        assert PINS[eng]["scheduled_pods"] == [512] * 16
    wl = TraceParser().parse_workload(max_pods=512)
    assert wl.num_pods == 512 and wl.cluster.n_padded == N
    assert wl.cluster.g_padded == G


@pytest.mark.parametrize("name,lane", [
    ("exact", 0), ("exact", "champion"), ("flat", "champion")])
def test_pins_hold_on_the_transpiled_tier(name, lane):
    codes = pin_codes()
    if lane == "champion":
        lane = PINS["lanes"].index(
            "funsearch_20260801_045536_score0.5365.json")
    wl = TraceParser().parse_workload(max_pods=512)
    cfg = SimConfig(score_dtype=torch.float64)
    res = get_engine(name).simulate(wl, transpiler.transpile(codes[lane]),
                                    cfg, device="cpu")
    pin = PINS[name]
    assert abs(float(res.policy_score) - pin["policy_score"][lane]) <= 1e-9
    assert int(res.scheduled_pods) == pin["scheduled_pods"][lane]
    assert int(res.events_processed) == pin["events_processed"][lane]


@pytest.mark.slow
@pytest.mark.parametrize("name,jmod", [("exact", jengine), ("flat", jflat)])
def test_pins_hold_on_fks_tpu_vm_population(name, jmod):
    """fks_tpu's VM population (capacity 512, 16 lanes, float64) on the
    512-pod prefix reproduces the pins; about 70 s per engine on the
    CPU."""
    jwl = jax_make_workload_prefix(512)
    progs = [jvm.compile_policy(c, N, G, capacity=512) for c in pin_codes()]
    progs += [progs[-1]] * (jvm.bucket_lanes(len(progs)) - len(progs))
    st = jvm.stack_programs(progs, capacity=512)
    cfg = jengine.SimConfig(score_dtype=jnp.float64)
    res = jax.jit(jmod.make_population_run_fn(jwl, jvm.score_static, cfg))(
        st, jmod.initial_state(jwl, cfg))
    pin = PINS[name]
    np.testing.assert_allclose(np.asarray(res.policy_score),
                               pin["policy_score"], rtol=0, atol=1e-9)
    assert np.asarray(res.scheduled_pods).tolist() == pin["scheduled_pods"]
    assert np.asarray(res.events_processed).tolist() == \
        pin["events_processed"]


# -------------------------------- (vi) render_code and policy_params

def test_render_code_matches_fks_tpu():
    rng = np.random.default_rng(0)
    for _ in range(12):
        w = (rng.standard_normal(16) * rng.integers(0, 2, 16)).astype(
            np.float32)
        assert parametric.render_code(torch.from_numpy(w)) == \
            jparametric.render_code(w)
    for name in parametric.SEED_NAMES:
        w = parametric.seed_weights(name)
        assert parametric.render_code(w) == \
            jparametric.render_code(np.asarray(w))
    assert parametric.render_code(torch.zeros(16)) == \
        jparametric.render_code(np.zeros(16, np.float32))


def test_policy_params_code_replays_like_fks_tpu(micro_workload):
    """``policy_params(code=)`` is ``(vm.score, program)``; a replay of it
    equals fks_tpu's replay of its own ``policy_params(code=)``, and
    ``candidate_trace_diff`` (the VM search tier against the transpiled
    exact reference) finds what fks_tpu's finds."""
    code = template.seed_policies()["best_fit"]
    wl = port_workload(micro_workload)
    fn, prog = tracing.policy_params(wl, code=code, capacity=256)
    assert fn is vm.score and prog.capacity == 256
    jfn, jprog = jtracing.policy_params(micro_workload, code=code,
                                        capacity=256)
    got = tracing.replay(wl, "exact", fn, prog, device="cpu")
    ref = jtracing.replay(micro_workload, "exact", jfn, jprog)
    assert_result_matches(got, result_fields(ref))
    assert tracing.extract_trace(got) == jtracing.extract_trace(ref)
    diff = tracing.candidate_trace_diff(CodeEvaluator(wl, device="cpu"),
                                        code)
    jdiff = jtracing.candidate_trace_diff(JaxCodeEvaluator(micro_workload),
                                          code)
    assert diff["engines"] == jdiff["engines"]
    assert diff["divergent"] is jdiff["divergent"] is False
    assert diff["steps"] == jdiff["steps"]
