"""fks_tpu_torch flat engine vs fks_tpu's flat engine, small workloads.

Same workloads and populations (drawn with JAX's generator, handed over as
numpy) through ``fks_tpu.sim.flat.make_population_run_fn`` and the port's:
integer observables exact, float accumulators within rtol/atol 2e-6
(fks_tpu's own fused-vs-flat bar, tests/test_fused.py:37-45). The full
default trace is in test_torch_flat_default.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fks_tpu.data.build import make_workload as jax_make_workload
from fks_tpu.models import parametric as jpar
from fks_tpu.models import zoo as jzoo
from fks_tpu.sim import flat as jflat
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.ops.heap import KIND_NODE_DOWN, KIND_NODE_UP
from fks_tpu_torch.sim import flat
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, port_workload, result_fields,
)
from tests.test_fused import _contended, _roomy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def jax_population(key, pop, noise):
    return np.array(jpar.init_population(jax.random.PRNGKey(key), pop,
                                         noise=noise), np.float32)


def run_both(jwl, params, **cfg):
    ref = jflat.make_population_run_fn(jwl, jpar.score, JaxConfig(**cfg))(
        params, jflat.initial_state(jwl, JaxConfig(**cfg)))
    wl = port_workload(jwl)
    res = flat.make_population_run_fn(wl, parametric.score, SimConfig(**cfg))(
        torch.from_numpy(params), flat.initial_state(wl, SimConfig(**cfg)))
    return res, result_fields(ref), ref


def test_micro_population_matches(micro_workload):
    params = jax_population(0, 8, 0.3)
    res, ref, raw = run_both(micro_workload, params)
    assert_result_matches(res, ref)
    np.testing.assert_array_equal(res.pod_ctime.numpy(),
                                  np.asarray(raw.pod_ctime))


def test_roomy_population_matches():
    res, ref, _ = run_both(_roomy(), jax_population(0, 8, 0.2),
                           track_ctime=False)
    assert int(ref["truncated"].sum()) == 0
    assert_result_matches(res, ref)


def test_contended_population_matches():
    """Retries, fragmentation events, silent drops and step-budget
    truncation, event for event; track_ctime on (retry-mutated times)."""
    res, ref, raw = run_both(_contended(), jax_population(3, 8, 0.5),
                             max_steps=4 * 96)
    assert int(ref["num_fragmentation_events"].sum()) > 0
    assert bool(ref["truncated"].any())
    assert_result_matches(res, ref)
    np.testing.assert_array_equal(res.pod_ctime.numpy(),
                                  np.asarray(raw.pod_ctime))


def test_population_not_multiple_of_eight():
    res, ref, _ = run_both(_contended(), jax_population(5, 5, 0.3),
                           track_ctime=False, max_steps=4 * 96)
    assert res.policy_score.shape == (5,)
    assert_result_matches(res, ref)


def test_first_fit_allocator_matches():
    res, ref, _ = run_both(_contended(), jax_population(6, 6, 0.3),
                           gpu_allocator="first_fit", track_ctime=False,
                           max_steps=4 * 96)
    assert_result_matches(res, ref)


def test_unpacked_aux_matches():
    """node_bits + G > 31: GPU bits live beside aux (aux_gpus)."""
    rng = np.random.default_rng(9)
    nodes = [{"node_id": f"n{i}", "cpu_milli": 32000, "memory_mib": 64000,
              "gpus": [1000] * int(rng.integers(20, 31))} for i in range(5)]
    pods = [{"pod_id": f"p{i:03d}", "cpu_milli": int(rng.integers(100, 4000)),
             "memory_mib": int(rng.integers(100, 8000)),
             "num_gpu": int(rng.integers(0, 12)),
             "gpu_milli": int(rng.integers(50, 1000)),
             "creation_time": int(rng.integers(0, 200)),
             "duration_time": int(rng.integers(5, 150))} for i in range(60)]
    jwl = jax_make_workload(nodes, pods, pad_nodes_to=8, pad_gpus_to=30,
                            pad_pods_to=64)
    assert not flat._packable(8, 30)
    res, ref, _ = run_both(jwl, jax_population(7, 4, 0.3))
    assert_result_matches(res, ref)
    assert int(ref["assigned_gpus"].max()) >= 1 << 20  # high GPU bits used


@pytest.mark.parametrize("name", ["best_fit", "first_fit"])
def test_zoo_simulate_matches(name):
    jwl = _contended()
    cfg = dict(max_steps=4 * 96)
    ref = jflat.simulate(jwl, jzoo.ZOO[name](), JaxConfig(**cfg))
    res = flat.simulate(port_workload(jwl), zoo.ZOO[name](), SimConfig(**cfg),
                        device="cpu")
    assert res.policy_score.shape == ()
    assert_result_matches(res, result_fields(ref))


@pytest.mark.parametrize("flag", [
    dict(node_prefilter_k=2), dict(state_pack=True),
    dict(state_pack=True, decision_trace=True)])
def test_unported_flags_raise(flag):
    """The large-cluster knobs, once rejected here, now run: each equals
    fks_tpu's flat run with the same flags, and only a negative k raises
    (tests/test_torch_scale.py holds the knobs in full)."""
    wl = port_workload(_roomy())
    res = flat.simulate(wl, zoo.best_fit(), SimConfig(**flag), device="cpu")
    ref = jflat.simulate(_roomy(), jzoo.best_fit(), JaxConfig(**flag))
    assert_result_matches(res, result_fields(ref))
    with pytest.raises(ValueError, match="node_prefilter_k must be >= 0"):
        flat.initial_state(wl, SimConfig(node_prefilter_k=-1))


@pytest.mark.parametrize("flag", [
    dict(watchdog=True), dict(probe_score=True),
    dict(validate_invariants=True)])
def test_ported_flags_keep_clean_results(flag):
    """The watchdog, probe scoring and the audit, once rejected, now run
    and leave a clean full run as it was (tests/test_torch_exact.py holds
    each flag against fks_tpu on both engines)."""
    wl = port_workload(_roomy())
    base = flat.simulate(wl, zoo.best_fit(), SimConfig(), device="cpu")
    res = flat.simulate(wl, zoo.best_fit(), SimConfig(**flag), device="cpu")
    assert not bool(base.truncated) and float(base.policy_score) > 0
    assert_result_matches(res, result_fields(base), rtol=0, atol=0)
    assert int(res.numeric_flags) == 0


@pytest.mark.parametrize("workload", ["contended", "roomy-first-fit"])
def test_every_branch_step_matches_skipping_step(workload, monkeypatch):
    """The CUDA form of the step (every optional branch runs, no host
    check) gives the CPU form's results, rehearsed here on the CPU."""
    if workload == "contended":
        jwl, cfg = _contended(), SimConfig(max_steps=4 * 96)
    else:
        jwl, cfg = _roomy(), SimConfig(gpu_allocator="first_fit")
    wl = port_workload(jwl)
    params = torch.from_numpy(jax_population(11, 6, 0.5))
    run = flat.make_population_run_fn(wl, parametric.score, cfg)
    want = run(params, flat.initial_state(wl, cfg))
    monkeypatch.setattr(flat, "runs_every_branch", lambda dev: True)
    got = run(params, flat.initial_state(wl, cfg))
    assert_result_matches(got, result_fields(want), rtol=0, atol=0)
    np.testing.assert_array_equal(got.pod_ctime.numpy(),
                                  want.pod_ctime.numpy())


def test_fault_workloads_raise():
    """Fault timelines run in the flat engine now; the fused kernel still
    refuses them, as fks_tpu's does."""
    from fks_tpu_torch.scenarios import make_fault_events
    from fks_tpu_torch.sim import fused

    faults = make_fault_events([(10, 1, KIND_NODE_DOWN), (50, 1, KIND_NODE_UP)])
    wl = dataclasses.replace(port_workload(_roomy()), faults=faults)
    assert flat.initial_state(wl, SimConfig()).fault_time.shape == (1, 2)
    with pytest.raises(ValueError, match="fault-injected"):
        fused.make_fused_population_run(wl, SimConfig(), device="cpu")


def test_pop_tie_rule_is_first_slot():
    """Equal event times pop in slot (tie-rank) order: torch.min's first
    index, the reference's pod-id tie rule."""
    ev = torch.tensor([[5, 3, 3, 9, 3], [2, 2, 2, 2, 2]], dtype=torch.int32)
    t, idx = torch.min(ev, dim=1, keepdim=True)
    assert idx[:, 0].tolist() == [1, 0]
    scores = torch.tensor([[0, 7, 7, 2], [4, 4, 4, 4]], dtype=torch.int32)
    assert scores.argmax(dim=1).tolist() == [1, 0]
