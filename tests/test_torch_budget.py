"""The port's eval-budget rungs against fks_tpu's, on the CPU.

``BudgetConfig`` validation and survivor arithmetic, ``probe_sim_config``,
the evaluator's wiring, the mesh-free padding and occupancy helpers, and
``BudgetedSuiteEval.run`` itself: FakeLLM candidates through the smoke3
probe rung and the default8 full rung on the micro workload, the same
survivors, probe scores, rung records (seconds aside) and per-candidate
results as fks_tpu's ladder.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.funsearch import budget as jbudget
from fks_tpu.funsearch import vm as jvm
from fks_tpu.parallel import mesh as jmesh
from fks_tpu.scenarios import RobustConfig as JaxRobust
from fks_tpu.scenarios import get_suite as jax_get_suite
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.funsearch import CodeEvaluator, vm
from fks_tpu_torch.funsearch.budget import (
    BudgetConfig, BudgetedSuiteEval, probe_sim_config,
)
from fks_tpu_torch.parallel import occupancy_stats, pad_population, pad_stats
from fks_tpu_torch.scenarios import RobustConfig, get_suite
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import one_torch_thread, port_workload
from tests.test_budget import _vm_codes, micro_workload


@pytest.mark.parametrize("kw,match", [
    (dict(schedule="bandit"), "unknown budget schedule"),
    (dict(schedule="halving", eta=1), "eta must be >= 2"),
    (dict(schedule="halving", probe_steps=-1), "probe_steps must be >= 0"),
    (dict(schedule="halving", min_survivors=0), "min_survivors must be")])
def test_config_validation_equals_fks_tpu(kw, match):
    for cls in (BudgetConfig, jbudget.BudgetConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_survivors_and_probe_config_equal_fks_tpu():
    for eta in (2, 3, 4):
        for floor in (1, 3):
            b = BudgetConfig(schedule="halving", eta=eta,
                             min_survivors=floor)
            jb = jbudget.BudgetConfig(schedule="halving", eta=eta,
                                      min_survivors=floor)
            assert [b.survivors(n) for n in range(1, 70)] == \
                [jb.survivors(n) for n in range(1, 70)]
            assert b.describe() == jb.describe()
    cfg = SimConfig(max_steps=512, track_ctime=False)
    p = probe_sim_config(cfg, BudgetConfig(schedule="halving",
                                           probe_steps=128))
    assert p.probe_score and p.max_steps == 128 and not p.track_ctime
    p0 = probe_sim_config(cfg, BudgetConfig(schedule="halving"))
    assert p0.probe_score and p0.max_steps == 512 and not cfg.probe_score


def test_padding_and_occupancy_equal_fks_tpu():
    progs = vm.stack_programs([vm.compile_policy(
        "def priority_function(pod, node):\n    return 1\n", 4, 4)] * 3)
    padded, real = pad_population(progs, 8)
    assert real == 3 and padded.opcode.shape[0] == 8
    assert torch.equal(padded.opcode[7], progs.opcode[2])
    w = torch.arange(10.0).reshape(5, 2)
    pw, _ = pad_population(w, 4)
    jw, _ = jmesh.pad_population(jnp.asarray(w.numpy()), 4)
    assert np.array_equal(pw.numpy(), np.asarray(jw))
    for real_count, shards in ((3, 4), (8, 8), (0, 2), (5, 1)):
        assert pad_stats(real_count, shards) == \
            jmesh.pad_stats(real_count, shards)
        assert occupancy_stats(real_count, shards, 8, 3) == \
            jmesh.occupancy_stats(real_count, shards, 8, 3)


def test_evaluator_wiring():
    wl = port_workload(micro_workload())
    with pytest.raises(ValueError, match="requires suite mode"):
        CodeEvaluator(wl, budget=BudgetConfig(schedule="halving"),
                      device="cpu")
    suite = get_suite("smoke3", wl)
    off = CodeEvaluator(wl, suite=suite, budget=BudgetConfig(), device="cpu")
    assert off.budget is None and not off._budget_active(8)
    assert not off.vm_batch  # the CPU scores candidates one by one
    on = CodeEvaluator(wl, suite=suite,
                       budget=BudgetConfig(schedule="halving"), device="cpu")
    assert on.vm_batch  # the rung ladder is a batched construct
    assert on._budget_active(4) and not on._budget_active(1)


def test_ladder_equals_fks_tpu():
    jwl = micro_workload()
    wl = port_workload(jwl)
    codes = _vm_codes(jwl, 5)
    budget = BudgetConfig(schedule="halving", probe_suite="smoke3")
    cfg = SimConfig(score_dtype=torch.float64)
    full = CodeEvaluator(wl, cfg, suite=get_suite("default8", wl),
                         robust=RobustConfig(), budget=budget, device="cpu")
    ladder = BudgetedSuiteEval(
        wl, cfg, budget, RobustConfig(),
        full_runner=lambda s: full._vm_pop_runner()(s, full.state0),
        device="cpu")
    jfull_suite = jax_get_suite("default8", jwl)
    jcfg = JaxConfig(score_dtype=jnp.float64)
    from fks_tpu.scenarios.robust import make_suite_eval as jmake
    jfull = jmake(jfull_suite, jvm.score_static, jcfg, population=True)
    jladder = jbudget.BudgetedSuiteEval(
        jwl, jcfg, jbudget.BudgetConfig(schedule="halving",
                                        probe_suite="smoke3"),
        JaxRobust(), full_runner=jfull)
    c = wl.cluster
    with one_torch_thread():
        got = ladder.run([vm.compile_policy(x, c.n_padded, c.g_padded)
                          for x in codes])
    want = jladder.run([jvm.compile_policy(x, c.n_padded, c.g_padded)
                        for x in codes])
    assert got.survivor_indices == want.survivor_indices
    assert got.pruned == want.pruned and any(got.pruned)
    np.testing.assert_allclose(got.probe_scores, want.probe_scores,
                               rtol=0, atol=1e-12)

    def rung(r):
        return {k: v for k, v in dataclasses.asdict(r).items()
                if k != "device_seconds"}

    assert [rung(r) for r in got.rungs] == [rung(r) for r in want.rungs]
    for res, ref in zip(got.results, want.results):
        for f in ("scheduled_pods", "events_processed", "failed",
                  "truncated"):
            assert np.array_equal(getattr(res, f).numpy(),
                                  np.asarray(getattr(ref, f))), f
        np.testing.assert_allclose(res.policy_score.numpy(),
                                   np.asarray(ref.policy_score),
                                   rtol=0, atol=1e-12)
