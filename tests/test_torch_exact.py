"""fks_tpu_torch's exact heap engine vs the golden fixtures and fks_tpu.

- Golden fixtures, as fks_tpu's own tests hold its exact engine:
  ``golden_micro`` exactly (tests/test_engine_micro.py), ``golden_default``
  best_fit in float64 with integers exact and floats within 1e-9
  (tests/test_engine_parity.py; the other four policies run with the slow
  tier), and ``golden_fuzz`` per field (tests/test_differential.py): a
  12-case subset in the fast tier, one case at a time, all 48 in the slow
  tier; ``golden_alt_traces`` in the slow tier.
- fks_tpu's ``make_population_eval(engine="exact")`` against the port's on
  the roomy and contended workloads: integers exact, floats within
  rtol/atol 2e-6.
- The watchdog, probe_score and validate_invariants flags on both engines
  against fks_tpu's, and the repairs: ``SimConfig(cond_policy=True)``
  changes nothing, entry points need ``device="cpu"`` without a card.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.models import parametric as jpar
from fks_tpu.models import zoo as jzoo
from fks_tpu.parallel import make_population_eval as jax_population_eval
from fks_tpu.sim import engine as jengine
from fks_tpu.sim import flat as jflat
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.data import TraceParser, make_workload
from fks_tpu_torch.models import zoo
from fks_tpu_torch.parallel import make_population_eval
from fks_tpu_torch.sim import engine, flat, get_engine
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.sim.guards import FLAG_INF, FLAG_NAN
from fks_tpu_torch.testing import (
    assert_golden_micro, assert_golden_parity, assert_result_matches,
    golden_micro_workload, one_torch_thread, port_workload, result_fields,
)
from tests.test_engine_micro import bits_to_indices
from tests.test_engine_micro import micro_workload as fks_micro_workload
from tests.test_engine_parity import check_parity
from tests.test_fused import _contended, _roomy
from tests.test_torch_synthetic import assert_same_workload

F64 = SimConfig(score_dtype=torch.float64)
FUZZ = pathlib.Path(__file__).parent / "fixtures" / "golden_fuzz.json"
FUZZ_POLICIES = ("first_fit", "best_fit", "funsearch_4901")
FAST_FUZZ = range(0, 48, 4)  # 12 of the 48 cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


# ---------------------------------------------------------- golden parity

def test_micro_matches_reference(golden_micro):
    wl = golden_micro_workload()
    assert_same_workload(wl, fks_micro_workload())
    res = engine.simulate(wl, zoo.micro_best_fit(torch.float64), F64,
                          device="cpu")
    assert_golden_micro(res, golden_micro, wl)
    n_pods = wl.num_pods
    assert [bits_to_indices(b) for b in res.assigned_gpus[:n_pods]] \
        == golden_micro["assigned_gpus"]


@pytest.fixture(scope="module")
def port_default_workload():
    return TraceParser().parse_workload()


DEFAULT_POLICIES = [pytest.param("first_fit", marks=pytest.mark.slow),
                    "best_fit",
                    pytest.param("funsearch_4901", marks=pytest.mark.slow),
                    pytest.param("funsearch_4816", marks=pytest.mark.slow),
                    pytest.param("funsearch_4800", marks=pytest.mark.slow)]


@pytest.mark.parametrize("name", DEFAULT_POLICIES)
def test_default_trace_parity(name, port_default_workload, golden_default):
    res = engine.simulate(port_default_workload,
                          zoo.ZOO[name](torch.float64), F64, device="cpu")
    ref = golden_default["policies"][name]
    check_parity(res, ref, port_default_workload)
    assert_golden_parity(res, ref, port_default_workload)
    assert int(res.events_processed) == ref["events_processed"]
    if name == "best_fit":
        assert round(float(res.policy_score), 6) == 0.446548
        assert (int(res.events_processed), int(res.num_snapshots),
                int(res.num_fragmentation_events)) == (16383, 40, 79)


@pytest.mark.slow
@pytest.mark.parametrize("pod_file,name", [
    ("openb_pod_list_gpushare40.csv", "best_fit"),
    ("openb_pod_list_gpuspec33.csv", "first_fit"),
    ("openb_pod_list_cpu250.csv", "best_fit"),
])
def test_alt_trace_parity(pod_file, name, golden_alt):
    wl = TraceParser().parse_workload(pod_file=pod_file)
    res = engine.simulate(wl, zoo.ZOO[name](torch.float64), F64,
                          device="cpu")
    check_parity(res, golden_alt[pod_file][name], wl)
    assert_golden_parity(res, golden_alt[pod_file][name], wl)


def fuzz_case(i):
    with open(FUZZ) as f:
        return json.load(f)["cases"][i]


def fuzz_mismatches(case, name):
    """Divergences of one golden_fuzz case from the reference, per field
    (tests/test_differential.py's comparison)."""
    wl = make_workload(case["nodes"], [dict(p) for p in case["pods"]],
                       pad_nodes_to=8, pad_gpus_to=4, pad_pods_to=40)
    cfg = SimConfig(score_dtype=torch.float64, wait_hist_size=1002)
    res = engine.simulate(wl, zoo.ZOO[name](torch.float64), cfg,
                          device="cpu")
    want = case["results"][name]
    if want["aborted"]:
        return [] if bool(res.failed) else [("aborted", False, True)]
    n, p = len(case["nodes"]), len(case["pods"])
    bad = []
    for key, tol in [("policy_score", 1e-9), ("num_snapshots", 0),
                     ("num_fragmentation_events", 0), ("events_processed", 0),
                     ("max_nodes", 0), ("scheduled_pods", 0),
                     ("gpu_fragmentation_score", 1e-9),
                     ("avg_cpu_utilization", 1e-9),
                     ("avg_memory_utilization", 1e-9),
                     ("avg_gpu_count_utilization", 1e-9),
                     ("avg_gpu_memory_utilization", 1e-9)]:
        got = float(getattr(res, key))
        if abs(got - want[key]) > tol:
            bad.append((key, got, want[key]))
    got = {
        "assignments": res.assigned_node[:p].tolist(),
        "assigned_gpus": [bits_to_indices(b) for b in res.assigned_gpus[:p]],
        "final_creation_time": res.pod_ctime[:p].tolist(),
        "final_cpu_left": res.cpu_left[:n].tolist(),
        "final_mem_left": res.mem_left[:n].tolist(),
        "final_gpu_left": res.gpu_left[:n].tolist(),
        "final_gpu_milli_left": [row[:len(w)] for row, w in zip(
            res.gpu_milli_left[:n].tolist(), want["final_gpu_milli_left"])],
    }
    bad += [(k, v, want[k]) for k, v in got.items() if v != want[k]]
    return bad


@pytest.mark.parametrize("name", FUZZ_POLICIES)
@pytest.mark.parametrize("i", FAST_FUZZ)
def test_fuzz_subset_matches_reference(i, name):
    assert not fuzz_mismatches(fuzz_case(i), name)


@pytest.mark.slow
@pytest.mark.parametrize("name", FUZZ_POLICIES)
def test_fuzz_all_cases_match_reference(name):
    bad = [(i, m) for i in range(48) for m in fuzz_mismatches(fuzz_case(i),
                                                             name)]
    assert not bad, bad[:10]


def test_fuzz_subset_exercises_retries_and_aborts():
    """The fast subset keeps the hard paths: retries (mutated creation
    times) and zero-score runs."""
    retry = zero = False
    for i in FAST_FUZZ:
        case = fuzz_case(i)
        orig = [p["creation_time"] for p in case["pods"]]
        for name in FUZZ_POLICIES:
            r = case["results"][name]
            if r["aborted"]:
                continue
            retry |= r["final_creation_time"] != orig
            zero |= r["policy_score"] == 0
    assert retry and zero


# -------------------------------------------------- population vs fks_tpu

def jax_population(key, pop, noise):
    return np.array(jpar.init_population(jax.random.PRNGKey(key), pop,
                                         noise=noise), np.float32)


@pytest.mark.parametrize("case", ["roomy", "contended"])
def test_population_eval_exact_matches(case):
    if case == "roomy":
        jwl, params, cfg = _roomy(), jax_population(2, 6, 0.2), {}
    else:
        jwl, params = _contended(), jax_population(9, 8, 0.5)
        cfg = dict(max_steps=4 * 96)
    ref = jax_population_eval(jwl, cfg=JaxConfig(**cfg))(params)
    res = make_population_eval(port_workload(jwl), cfg=SimConfig(**cfg),
                               device="cpu")(params)
    assert_result_matches(res, result_fields(ref))
    np.testing.assert_array_equal(res.pod_ctime.numpy(),
                                  np.asarray(ref.pod_ctime))
    if case == "contended":
        assert int(np.asarray(ref.num_fragmentation_events).sum()) > 0
        assert bool(np.asarray(ref.truncated).any())


@pytest.mark.parametrize("name", ["first_fit", "best_fit", "funsearch_4816"])
def test_first_fit_allocator_simulate_matches(name):
    """Single-policy runs with the first-fit GPU allocator (float32)."""
    jwl = _contended()
    cfg = dict(max_steps=4 * 96, gpu_allocator="first_fit")
    ref = jengine.simulate(jwl, jzoo.ZOO[name](), JaxConfig(**cfg))
    res = engine.simulate(port_workload(jwl), zoo.ZOO[name](),
                          SimConfig(**cfg), device="cpu")
    assert res.policy_score.shape == ()
    assert_result_matches(res, result_fields(ref))


# ------------------------------------------------- flags on both engines

def float_first_fit(pod, nodes):
    return torch.where(zoo.feasible_mask(pod, nodes), 1000.0, 0.0)


def poison_policy(p, pod, nodes):
    """Per-lane param: 0 -> clean float first fit, 1 -> all-NaN, 2 -> all
    Inf (tests/test_watchdog.py's ``_poison_policy``)."""
    base = float_first_fit(pod, nodes)
    bad = torch.where(p >= 1.5, torch.inf, torch.nan)[:, None]
    return torch.where(p[:, None] >= 0.5, bad.expand_as(base), base)


def jax_poison_policy(p, pod, nodes):
    base = jnp.where(jzoo.feasible_mask(pod, nodes), 1000.0, 0.0)
    bad = jnp.where(p >= 1.5, jnp.inf, jnp.nan).astype(base.dtype)
    return jnp.where(p >= 0.5, bad, base)


def engines(name):
    return {"exact": (engine, jengine), "flat": (flat, jflat)}[name]


@pytest.mark.parametrize("mod", ["exact", "flat"])
def test_watchdog_flags_lanes_like_fks_tpu(mod, micro_workload):
    port, ref_mod = engines(mod)
    cfg = dict(watchdog=True)
    params = np.array([0.0, 1.0, 0.0, 2.0])
    ref = jax.jit(ref_mod.make_population_run_fn(
        micro_workload, jax_poison_policy, JaxConfig(**cfg)))(
        params, ref_mod.initial_state(micro_workload, JaxConfig(**cfg)))
    wl = port_workload(micro_workload)
    res = port.make_population_run_fn(wl, poison_policy, SimConfig(**cfg))(
        torch.from_numpy(params), port.initial_state(wl, SimConfig(**cfg)))
    assert_result_matches(res, result_fields(ref))
    flags = res.numeric_flags.tolist()
    assert flags == np.asarray(ref.numeric_flags).tolist()
    assert flags[1] & FLAG_NAN and flags[3] & FLAG_INF
    assert flags[0] == flags[2] == 0
    assert bool(torch.isfinite(res.policy_score).all())


@pytest.mark.parametrize("mod", ["exact", "flat"])
def test_watchdog_clean_run_is_unchanged(mod, micro_workload):
    port, _ = engines(mod)
    wl = port_workload(micro_workload)
    off = port.simulate(wl, float_first_fit, SimConfig(), device="cpu")
    on = port.simulate(wl, float_first_fit, SimConfig(watchdog=True),
                       device="cpu")
    assert_result_matches(on, result_fields(off), rtol=0, atol=0)
    assert int(on.numeric_flags) == 0


@pytest.mark.parametrize("mod", ["exact", "flat"])
def test_probe_score_matches_fks_tpu(mod):
    """A prefix cut by the step budget still scores under probe_score."""
    port, ref_mod = engines(mod)
    jwl = _contended()
    params = jax_population(5, 6, 0.3)
    cfg = dict(max_steps=120, probe_score=True)
    ref = ref_mod.make_population_run_fn(jwl, jpar.score, JaxConfig(**cfg))(
        params, ref_mod.initial_state(jwl, JaxConfig(**cfg)))
    wl = port_workload(jwl)
    res = port.make_population_run_fn(
        wl, lambda p, pod, nodes: zoo_param(p, pod, nodes),
        SimConfig(**cfg))(torch.from_numpy(params),
                          port.initial_state(wl, SimConfig(**cfg)))
    assert_result_matches(res, result_fields(ref))
    assert bool(res.truncated.all()) and bool((res.policy_score > 0).all())


def zoo_param(p, pod, nodes):
    from fks_tpu_torch.models import parametric
    return parametric.score(p, pod, nodes)


@pytest.mark.parametrize("mod", ["exact", "flat"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_invariant_audit_matches_fks_tpu(mod, corrupt, micro_workload):
    """Zero violations on a correct run; on a hand-corrupted state (a node
    owing more CPU than it has) the same per-step count as fks_tpu."""
    port, ref_mod = engines(mod)
    jcfg = JaxConfig(score_dtype=jnp.float64, validate_invariants=True)
    cfg = SimConfig(score_dtype=torch.float64, validate_invariants=True)
    jstate = ref_mod.initial_state(micro_workload, jcfg)
    wl = port_workload(micro_workload)
    state = port.initial_state(wl, cfg)
    if corrupt:
        jstate = jstate._replace(cpu_left=jstate.cpu_left.at[0].add(-999))
        state.cpu_left[:, 0] -= 999
    ref = ref_mod.make_run_fn(micro_workload,
                              jzoo.micro_best_fit(jnp.float64), jcfg)(jstate)
    res = port.make_run_fn(wl, zoo.micro_best_fit(torch.float64), cfg)(
        state).lane(0)
    assert int(res.invariant_violations) == int(ref.invariant_violations)
    assert (int(res.invariant_violations) > 0) == corrupt
    assert_result_matches(res, result_fields(ref))


def test_invariant_audit_contended_population():
    """The audit over a retry-heavy population run: zero violations in
    every lane, every other field as with the audit off."""
    jwl = _contended()
    wl = port_workload(jwl)
    params = torch.from_numpy(jax_population(4, 4, 0.5))
    out = {}
    for on in (False, True):
        cfg = SimConfig(max_steps=4 * 96, validate_invariants=on)
        out[on] = make_population_eval(wl, cfg=cfg, device="cpu")(params)
    assert out[True].invariant_violations.tolist() == [0, 0, 0, 0]
    assert_result_matches(out[True], result_fields(out[False]), rtol=0,
                          atol=0)


# ------------------------------------------------------------- repairs

@pytest.mark.parametrize("mod", ["exact", "flat"])
def test_cond_policy_is_accepted_and_changes_nothing(mod):
    port, _ = engines(mod)
    wl = port_workload(_contended())
    a = port.simulate(wl, zoo.best_fit(), SimConfig(max_steps=4 * 96),
                      device="cpu")
    b = port.simulate(wl, zoo.best_fit(),
                      SimConfig(max_steps=4 * 96, cond_policy=True),
                      device="cpu")
    assert_result_matches(b, result_fields(a), rtol=0, atol=0)


@pytest.mark.parametrize("mod", ["exact", "flat"])
def test_simulate_needs_a_card_unless_asked_for_the_cpu(mod, monkeypatch):
    port, _ = engines(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = port_workload(_roomy())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.simulate(wl, zoo.best_fit())
    res = port.simulate(wl, zoo.best_fit(), device="cpu")
    assert res.policy_score.device.type == "cpu"


@pytest.mark.parametrize("flag", [
    dict(node_prefilter_k=2), dict(state_pack=True),
    dict(state_pack=True, decision_trace=True)])
def test_unported_flags_raise_in_exact_engine(flag):
    """The large-cluster knobs, once rejected here, now run (state_pack is
    accepted and ignored, as in fks_tpu): each equals fks_tpu's exact run
    with the same flags, and only a negative k raises."""
    wl = port_workload(_roomy())
    res = engine.simulate(wl, zoo.best_fit(), SimConfig(**flag),
                          device="cpu")
    ref = jengine.simulate(_roomy(), jzoo.best_fit(), JaxConfig(**flag))
    assert_result_matches(res, result_fields(ref))
    with pytest.raises(ValueError, match="node_prefilter_k must be >= 0"):
        engine.initial_state(wl, SimConfig(node_prefilter_k=-1))


def test_get_engine():
    assert get_engine("exact") is engine and get_engine("flat") is flat
    with pytest.raises(ValueError, match="fused kernel is not a general"):
        get_engine("fused")
    with pytest.raises(ValueError, match="unknown engine"):
        get_engine("heap")


def test_chunk_replays_on_one_state_match_the_eager_loop():
    """What a CUDA graph replay repeats — ``run_chunk`` on one fixed state
    object, which the step partly updates in place — gives the eager
    loop's result (rehearsed here on the CPU)."""
    wl = port_workload(_contended())
    cfg = SimConfig(max_steps=4 * 96)
    params = torch.from_numpy(jax_population(6, 5, 0.5))
    ktable, max_steps = engine.loop_tables(wl, cfg)
    step = engine.build_step(
        wl, lambda pod, nodes: zoo_param(params, pod, nodes), cfg, ktable,
        max_steps)
    want = engine.finalize(wl, cfg, engine.run_batched_lanes(
        step, engine.initial_state(wl, cfg, lanes=5), max_steps))
    state = engine.initial_state(wl, cfg, lanes=5)
    leaves = list(engine._tensor_leaves(state))
    while bool(engine.lane_active(state, max_steps).any()):
        engine.run_chunk(step, state)
    assert all(a is b for a, b in zip(leaves, engine._tensor_leaves(state)))
    assert_result_matches(engine.finalize(wl, cfg, state), result_fields(want),
                          rtol=0, atol=0)
    np.testing.assert_array_equal(state.pod_ctime.numpy(),
                                  want.pod_ctime.numpy())
