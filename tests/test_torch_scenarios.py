"""fks_tpu_torch.scenarios vs fks_tpu.scenarios.

- The generator's arrays equal fks_tpu's byte for byte (``FULL_SPEC`` of
  tests/test_scenarios.py and the golden fixture's spec), and so do the
  suite registry, the shared fault padding and each suite's description.
- Cordon semantics in both engines (tests/test_scenarios.py:158-198):
  a downed node takes no new pod during its window, placements come back
  after NODE_UP, running pods are not evicted.
- ``golden_scenario_fault.json``'s pins in both engines x both policies:
  score within 1e-5, counts, the per-CREATE assignment vector and the
  fault rows exact.
- ``make_suite_eval`` on ``smoke3`` over ``synthetic_workload(4, 24,
  seed=3)``: one candidate and a pop-4 ``[C, T]`` matrix equal to
  fks_tpu's (ints exact, floats within rtol/atol 2e-6), in both engines,
  and each candidate's row equal to its own one-candidate eval.
- ``aggregate`` and ``RobustConfig`` against fks_tpu's; the rejections
  (fused engine, a sharded suite eval without a mesh, the unported
  flags).
- Slow: ``default8`` on the full default trace for the 0.5365 champion
  against fks_tpu's exact engine.
"""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.models import parametric as jpar
from fks_tpu.scenarios import RobustConfig as JaxRobust
from fks_tpu.scenarios import ScenarioSpec as JaxSpec
from fks_tpu.scenarios import aggregate as jax_aggregate
from fks_tpu.scenarios import get_suite as jax_get_suite
from fks_tpu.scenarios import list_suites as jax_list_suites
from fks_tpu.scenarios import make_suite_eval as jax_suite_eval
from fks_tpu.scenarios import perturb_workload as jax_perturb
from fks_tpu_torch.data import make_workload
from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.obs import tracing
from fks_tpu_torch.ops.heap import KIND_NODE_DOWN, KIND_NODE_UP
from fks_tpu_torch.scenarios import (
    SUITE_VERSION, RobustConfig, ScenarioSpec, aggregate, get_suite,
    list_suites, make_fault_events, make_sharded_suite_eval, make_suite_eval,
    perturb_workload,
)
from fks_tpu_torch.sim import engine, flat, fused
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, result_fields,
)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FULL = dict(name="all", seed=5, arrival_jitter_frac=0.02, demand_scale=1.1,
            gpu_milli_scale=0.9, pod_mix_swap_frac=0.3, fault_nodes=2)
GOLDEN = json.loads((FIXTURES / "golden_scenario_fault.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def assert_same_arrays(got, want):
    """Every array of a port workload equals fks_tpu's, dtype included."""
    for part in ("cluster", "pods"):
        for f in dataclasses.fields(getattr(got, part)):
            a = getattr(getattr(got, part), f.name)
            if not isinstance(a, torch.Tensor):
                continue
            b = np.asarray(getattr(getattr(want, part), f.name))
            assert a.numpy().dtype == b.dtype and np.array_equal(
                a.numpy(), b), f"{part}.{f.name}"
    assert (got.faults is None) == (want.faults is None)
    if got.faults is not None:
        for k in ("time", "node", "kind", "mask"):
            b = np.asarray(getattr(want.faults, k))
            a = getattr(got.faults, k).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def assign_rows(rows):
    return [[r["pod"], r["node"]] for r in rows if r["kind"] == "CREATE"]


# ------------------------------------------------------------- generator

@pytest.mark.parametrize("case", ["full", "golden", "identity"])
def test_generator_arrays_match_fks_tpu(case):
    if case == "golden":
        shape, spec = GOLDEN["workload"], GOLDEN["spec"]
    else:
        shape = dict(num_nodes=4, num_pods=24, seed=3)
        spec = FULL if case == "full" else dict(name="base")
    got = perturb_workload(synthetic_workload(**shape), ScenarioSpec(**spec))
    want = jax_perturb(jax_synthetic(**shape), JaxSpec(**spec))
    assert_same_arrays(got, want)
    if case == "identity":
        assert got.faults is None
    if case == "golden":
        m = got.faults.mask
        assert [{"time": int(t), "node": int(n), "kind": int(k)}
                for t, n, k in zip(got.faults.time[m], got.faults.node[m],
                                   got.faults.kind[m])] \
            == GOLDEN["fault_timeline"]


def test_generator_rules():
    fe = make_fault_events([(50, 1, KIND_NODE_UP), (10, 1, KIND_NODE_DOWN)],
                           pad_to=4)
    assert fe.time.tolist() == [10, 50, 2**31 - 1, 2**31 - 1]
    assert fe.mask.tolist() == [True, True, False, False]
    assert fe.f_padded == 4 and fe.num_events == 2
    assert make_fault_events([]) is None
    with pytest.raises(ValueError, match="not NODE_DOWN/NODE_UP"):
        make_fault_events([(5, 0, 99)])
    faulted = perturb_workload(synthetic_workload(2, 8, seed=0),
                               ScenarioSpec(name="f", fault_nodes=1))
    with pytest.raises(ValueError, match="already carries fault events"):
        perturb_workload(faulted, ScenarioSpec(name="g"))


# ----------------------------------------------------------------- suite

def test_suite_registry_and_padding():
    assert list_suites() == jax_list_suites() and SUITE_VERSION == 1
    with pytest.raises(ValueError, match="unknown scenario suite"):
        get_suite("nope", synthetic_workload(2, 8, seed=0))
    base = dict(num_nodes=4, num_pods=24, seed=3)
    got = get_suite("default8", synthetic_workload(**base))
    want = jax_get_suite("default8", jax_synthetic(**base))
    assert got.describe() == want.describe() and got.names == want.names
    assert {w.faults.f_padded for w in got.workloads} == {got.fault_pad}
    for a, b in zip(got.workloads, want.workloads):
        assert_same_arrays(a, b)


# ------------------------------------------------------- cordon semantics

def _cordon_workload():
    """tests/test_scenarios.py::_cordon_workload: 2 identical CPU nodes,
    3 pods that all prefer node 0 under first_fit; node 0 is cordoned
    during pod 1's arrival only."""
    nodes = [{"node_id": f"n{i}", "cpu_milli": 4000, "memory_mib": 8000,
              "gpus": []} for i in range(2)]
    pods = [{"pod_id": f"p{i}", "cpu_milli": 500, "memory_mib": 500,
             "num_gpu": 0, "gpu_milli": 0, "creation_time": t,
             "duration_time": 500}
            for i, t in enumerate([0, 20, 60])]
    wl = make_workload(nodes, pods, pad_nodes_to=2, pad_gpus_to=1,
                       pad_pods_to=4)
    faults = make_fault_events([(15, 0, KIND_NODE_DOWN),
                                (50, 0, KIND_NODE_UP)])
    return wl, dataclasses.replace(wl, faults=faults)


def _replay(wl, eng, policy):
    res = tracing.replay(wl, eng, lambda _p, pod, nodes: policy(pod, nodes),
                         None, device="cpu")
    rows = tracing.extract_trace(res)
    return res, rows, assign_rows(rows)


@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_cordon_reroutes_recovers_and_does_not_evict(eng):
    clean, faulted = _cordon_workload()
    assert _replay(clean, eng, zoo.first_fit())[2] == [[0, 0], [1, 0], [2, 0]]
    res, rows, assign = _replay(faulted, eng, zoo.first_fit())
    # pod 1 arrives inside node 0's [15, 50) window and goes to node 1
    assert assign == [[0, 0], [1, 1], [2, 0]]
    assert int(res.scheduled_pods) == 3 and int(res.events_processed) == 6
    kinds = [r["kind"] for r in rows]
    assert kinds.count("NODE_DOWN") == 1 and kinds.count("NODE_UP") == 1
    assert kinds.index("NODE_DOWN") < kinds.index("NODE_UP")
    # pod 0 keeps running on the downed node: its cpu stays committed
    down = next(r for r in rows if r["kind"] == "NODE_DOWN")
    assert down["free_cpu"] == 2 * 4000 - 500
    assert down["pod"] == -1 and down["node"] == 0 and down["score"] == 0


# --------------------------------------------------------- golden fixture

@pytest.mark.parametrize("eng", ["exact", "flat"])
@pytest.mark.parametrize("policy", ["first_fit", "best_fit"])
def test_golden_fault_pin(eng, policy):
    pin = GOLDEN["policies"][policy]
    wl = perturb_workload(synthetic_workload(**GOLDEN["workload"]),
                          ScenarioSpec(**GOLDEN["spec"]))
    res, rows, assign = _replay(wl, eng, zoo.ZOO[policy]())
    assert abs(float(res.policy_score) - pin["policy_score"]) <= 1e-5
    assert int(res.scheduled_pods) == pin["scheduled_pods"]
    assert int(res.events_processed) == pin["events_processed"]
    assert assign == pin["assignments"]
    assert sum(r["kind"] in ("NODE_DOWN", "NODE_UP")
               for r in rows) == pin["fault_rows"]


# ------------------------------------------------------------- suite eval

@pytest.fixture(scope="module")
def smoke3():
    base = dict(num_nodes=4, num_pods=24, seed=3)
    return (get_suite("smoke3", synthetic_workload(**base)),
            jax_get_suite("smoke3", jax_synthetic(**base)))


@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_suite_eval_matches_fks_tpu(smoke3, eng):
    suite, jsuite = smoke3
    one = parametric.seed_weights("best_fit")
    pop = np.array(jpar.init_population(jax.random.PRNGKey(0), 4, noise=0.3),
                   np.float32)
    ref1 = jax_suite_eval(jsuite, engine=eng)(np.asarray(one))
    refp = jax_suite_eval(jsuite, population=True, engine=eng)(pop)
    single = make_suite_eval(suite, engine=eng, device="cpu")
    res1 = single(one)
    resp = make_suite_eval(suite, population=True, engine=eng,
                           device="cpu")(torch.from_numpy(pop))
    assert res1.policy_score.shape == (3,)
    assert resp.policy_score.shape == (4, 3)
    assert_result_matches(res1, result_fields(ref1))
    assert_result_matches(resp, result_fields(refp))
    np.testing.assert_array_equal(resp.pod_ctime.numpy(),
                                  np.asarray(refp.pod_ctime))
    # lane isolation: each candidate's row is its own one-candidate eval
    want = result_fields(resp)
    for c in range(4):
        assert_result_matches(single(torch.from_numpy(pop[c])),
                              {k: v[c] for k, v in want.items()},
                              rtol=0, atol=0)
    # the fault lane really carried faults
    assert suite.names[2] == "fault1" and suite.workloads[2].faults.num_events


# ------------------------------------------------------------ aggregation

@pytest.mark.parametrize("rc", [
    dict(aggregation="mean"), dict(aggregation="min"),
    dict(aggregation="cvar", cvar_alpha=0.5),
    dict(aggregation="cvar", cvar_alpha=1e-6),
    dict(aggregation="mean", weights=(1.0, 0.0, 0.0, 1.0))])
def test_aggregate_matches_fks_tpu(rc):
    s = np.random.default_rng(4).random((5, 4)).astype(np.float32)
    got = aggregate(torch.from_numpy(s), RobustConfig(**rc))
    want = np.asarray(jax_aggregate(s, JaxRobust(**rc)))
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    assert RobustConfig(**rc).describe() == JaxRobust(**rc).describe()


def test_robust_config_validation():
    with pytest.raises(ValueError, match="unknown aggregation"):
        RobustConfig("median")
    with pytest.raises(ValueError, match="not in"):
        RobustConfig("cvar", cvar_alpha=0.0)
    with pytest.raises(ValueError, match="weights only apply"):
        RobustConfig("min", weights=(1.0, 2.0))
    with pytest.raises(ValueError, match="weights for"):
        aggregate(torch.ones(3), RobustConfig("mean", weights=(1.0, 2.0)))
    assert float(aggregate([1.0, 4.0, 2.0, 3.0],
                           RobustConfig("cvar", cvar_alpha=0.5))) == 1.5


# ------------------------------------------------------------- rejections

def test_rejections(smoke3):
    suite, _ = smoke3
    with pytest.raises(ValueError, match="fused"):
        make_suite_eval(suite, engine="fused", device="cpu")
    with pytest.raises(ValueError, match="fault-injected workloads"):
        fused.make_fused_population_run(suite.workloads[2], device="cpu")
    with pytest.raises(ValueError, match="decision trace is not supported"):
        fused.make_fused_population_run(
            suite.workloads[0], SimConfig(decision_trace=True), device="cpu")
    # the sharded suite eval runs (tests/test_torch_mesh.py); what is not
    # a Mesh raises
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        make_sharded_suite_eval(suite, object())
    for flag in (dict(node_prefilter_k=2), dict(state_pack=True)):
        # the scale knobs run on fault workloads in both engines; the
        # fused kernel still refuses them
        for mod in (engine, flat):
            mod.initial_state(suite.workloads[2], SimConfig(**flag))
        with pytest.raises(ValueError, match="large-cluster scale tier"):
            fused.make_fused_population_run(
                synthetic_workload(4, 24, seed=3), SimConfig(**flag),
                device="cpu")


# ------------------------------------------------- the full default trace

@pytest.mark.slow
def test_default8_full_trace_champion_matches_fks_tpu():
    """default8 on the full default OpenB trace (16 nodes x 8,152 pods)
    for the 0.5365 champion, exact engine: the port's eight results equal
    fks_tpu's."""
    from fks_tpu.data import TraceParser as JaxParser
    from fks_tpu_torch.convert import load_champion_weights
    from fks_tpu_torch.data import TraceParser

    champ = (pathlib.Path(__file__).parent.parent / "policies" / "discovered"
             / "funsearch_20260801_045536_score0.5365.json")
    w = load_champion_weights(champ)
    ref = jax_suite_eval(jax_get_suite("default8",
                                       JaxParser().parse_workload()))(
        w.numpy())
    res = make_suite_eval(get_suite("default8", TraceParser().parse_workload()),
                          device="cpu")(w)
    assert_result_matches(res, result_fields(ref))
