"""fks_tpu_torch.parallel.traces vs fks_tpu.parallel.traces.

- ``stack_traces``' shape and fault-pad checks, with fks_tpu's messages.
- Trace batching on a bucket of synthetic workloads whose clusters differ
  (tests/test_multi_trace.py:75-130), in both engines: one candidate
  ([T]) and a population ([C, T]) equal to fks_tpu's
  ``make_trace_batch_eval`` (ints exact, floats within rtol/atol 2e-6),
  and every lane equal to its trace run alone, exactly.
- Per-lane capacity tables: every zoo policy and ``parametric.score`` give
  the same integer scores whether a view's totals and masks are shared
  ``[N]`` or per lane ``[L, N]``.
"""
import jax
import numpy as np
import pytest
import torch

from fks_tpu.data import synthetic as jsyn
from fks_tpu.models import parametric as jpar
from fks_tpu.parallel.traces import make_trace_batch_eval as jax_batch_eval
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.parallel import make_trace_batch_eval, stack_traces
from fks_tpu_torch.scenarios import ScenarioSpec, perturb_workload
from fks_tpu_torch.sim import get_engine
from fks_tpu_torch.sim.engine import SimConfig, lane_cluster
from fks_tpu_torch.sim.types import NodeView
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, result_fields,
)
from tests.test_torch_policies import port_views, random_views

SMALL = dict(horizon=5000, pad_to=(8, 8, 64))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def small(seed):
    return synthetic_workload(6, 40, seed=seed, **SMALL)


def test_stack_traces_checks():
    cfg = SimConfig()
    with pytest.raises(ValueError, match="no workloads"):
        stack_traces([], cfg)
    a = synthetic_workload(4, 20, seed=0, pad_to=(8, 8, 32))
    b = synthetic_workload(4, 20, seed=1, pad_to=(16, 8, 32))
    with pytest.raises(ValueError, match="multiple padded shapes"):
        stack_traces([a, b], cfg)
    faulted = perturb_workload(a, ScenarioSpec("f", fault_nodes=1))
    with pytest.raises(ValueError, match="mix fault-event padding"):
        stack_traces([a, faulted], cfg, "flat")
    wl, kt, state0, max_steps = stack_traces(
        [a, synthetic_workload(4, 12, seed=2, pad_to=(8, 8, 32))], cfg)
    assert wl.pods.cpu.shape == (2, 32) and state0.lanes == 2
    assert max_steps == 8 * 20
    # the shorter of the two snapshot tables is padded with the sentinel
    assert kt.shape[0] == 2
    assert (kt == 2**31 - 1).any(dim=1).tolist().count(True) == 1


@pytest.fixture(scope="module")
def bucket():
    seeds = (0, 1, 2)
    return ([small(s) for s in seeds],
            [jsyn.synthetic_workload(6, 40, seed=s, **SMALL) for s in seeds])


@pytest.mark.parametrize("eng", ["exact", "flat"])
def test_trace_batch_matches_fks_tpu(bucket, eng):
    wls, jwls = bucket
    cfg = SimConfig()
    # the three clusters differ, so every lane reads its own [L, N] tables
    stacked = stack_traces(wls, cfg, eng)[0]
    assert lane_cluster(stacked.cluster, torch.arange(3)).cpu_total.dim() == 2
    one = parametric.seed_weights("best_fit")
    pop = np.array(jpar.init_population(jax.random.PRNGKey(2), 3, noise=0.3),
                   np.float32)
    ref1 = jax_batch_eval(jwls, cfg=JaxConfig(), engine=eng)(np.asarray(one))
    refp = jax_batch_eval(jwls, cfg=JaxConfig(), population=True,
                          engine=eng)(pop)
    res1 = make_trace_batch_eval(wls, cfg=cfg, engine=eng, device="cpu")(one)
    resp = make_trace_batch_eval(wls, cfg=cfg, population=True, engine=eng,
                                 device="cpu")(torch.from_numpy(pop))
    assert resp.policy_score.shape == (3, 3)
    assert_result_matches(res1, result_fields(ref1))
    assert_result_matches(resp, result_fields(refp))
    # every lane equals its trace run alone
    mod = get_engine(eng)
    for t, wl in enumerate(wls):
        alone = mod.make_param_run_fn(wl, parametric.score, cfg)(
            one, mod.initial_state(wl, cfg))
        assert_result_matches(alone, {k: v[t:t + 1] for k, v in
                                      result_fields(res1).items()},
                              rtol=0, atol=0)


def test_same_cluster_traces_share_one_table():
    base = small(0)
    wls = [base, perturb_workload(base, ScenarioSpec("j", seed=1,
                                                     demand_scale=1.2))]
    stacked = stack_traces(wls, SimConfig())[0]
    c = lane_cluster(stacked.cluster, torch.tensor([0, 1, 0, 1]))
    assert c.cpu_total.shape == (8,) and c.gpu_mask.shape == (8, 8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["first_fit", "best_fit", "worst_fit",
                                  "gpu_aware", "utilization_based",
                                  "micro_best_fit", "funsearch_4901",
                                  "funsearch_4816", "funsearch_4800",
                                  "parametric"])
def test_policies_score_per_lane_tables_alike(name, dtype):
    view, pod, w = random_views(3)
    pv, shared = port_views(view, pod)
    lanes = shared.cpu_milli_left.shape[0]
    tabs = NodeView(
        shared.cpu_milli_left, shared.cpu_milli_total.expand(lanes, -1),
        shared.memory_mib_left, shared.memory_mib_total.expand(lanes, -1),
        shared.gpu_left, shared.num_gpus.expand(lanes, -1),
        shared.gpu_milli_left,
        *(x.expand((lanes,) + tuple(x.shape)) for x in (
            shared.gpu_milli_total, shared.gpu_mem_total, shared.gpu_mask)),
        shared.node_mask.expand(lanes, -1))
    d = getattr(torch, dtype)
    if name == "parametric":
        def policy(p, n):
            return parametric.score(torch.from_numpy(w), p, n, dtype=d)
    else:
        policy = getattr(zoo, name)(d)
    want = policy(pv, shared)
    got = policy(pv, tabs)
    assert got.shape == want.shape == (lanes, shared.node_mask.shape[0])
    assert torch.equal(got, want)
    assert int((want > 1).sum()) > 100
