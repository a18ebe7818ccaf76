"""fks_tpu_torch population fitness and parametric evolution vs fks_tpu.

``make_population_eval`` on the CPU, flat and fused engines, matches
fks_tpu's (jit-compiled flat; the fused engine in fks_tpu's interpret
mode); ``ParametricEvolution`` keeps its elites in the leading slots and
never lowers its best score.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from fks_tpu.models import parametric as jpar
from fks_tpu.parallel import make_population_eval as jax_population_eval
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.funsearch.device_evolution import (
    ParametricEvolution, next_generation,
)
from fks_tpu_torch.models import parametric
from fks_tpu_torch.parallel import fitness, make_population_eval
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, port_workload, result_fields,
    roomy_workload,
)
from tests.test_fused import _contended, _roomy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("engine", ["flat", "fused"])
def test_population_eval_matches(engine):
    jwl = _roomy()
    params = np.array(jpar.init_population(jax.random.PRNGKey(4), 6,
                                           noise=0.2), np.float32)
    ref = jax_population_eval(jwl, cfg=JaxConfig(track_ctime=False),
                              engine=engine)(params)
    res = make_population_eval(port_workload(jwl),
                               cfg=SimConfig(track_ctime=False),
                               engine=engine, device="cpu")(params)
    assert_result_matches(res, result_fields(ref))
    np.testing.assert_array_equal(fitness(res).numpy(),
                                  res.policy_score.numpy())


def test_population_eval_flat_contended_matches():
    jwl = _contended()
    params = np.array(jpar.init_population(jax.random.PRNGKey(8), 8,
                                           noise=0.5), np.float32)
    cfg = dict(track_ctime=False, max_steps=4 * 96)
    ref = jax_population_eval(jwl, cfg=JaxConfig(**cfg), engine="flat")(params)
    res = make_population_eval(port_workload(jwl), cfg=SimConfig(**cfg),
                               engine="flat", device="cpu")(params)
    assert_result_matches(res, result_fields(ref))


def test_engine_choices():
    wl = roomy_workload()
    with pytest.raises(ValueError, match="parametric"):
        make_population_eval(wl, param_policy=lambda p, a, b: 0,
                             engine="fused", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        make_population_eval(wl, engine="heap", device="cpu")
    # exact runs, and is the default, as in fks_tpu
    params = torch.stack([parametric.seed_weights(n)
                          for n in parametric.SEED_NAMES])
    exact = make_population_eval(wl, engine="exact", device="cpu")(params)
    default = make_population_eval(wl, device="cpu")(params)
    assert_result_matches(default, result_fields(exact), rtol=0, atol=0)
    assert exact.policy_score.shape == (4,)
    assert bool((exact.policy_score > 0).all())
    for fn in (make_population_eval, ParametricEvolution):
        assert inspect.signature(fn).parameters["engine"].default == "exact"


def test_next_generation_keeps_elites_in_leading_slots():
    params = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    scores = torch.tensor([0.1, 0.9, 0.3, 0.9, 0.0, 0.5])
    new, elite_scores = next_generation(
        params, scores, 3, lambda elites: torch.full((6, 4), -1.0))
    assert elite_scores.tolist() == pytest.approx([0.9, 0.9, 0.5])
    np.testing.assert_array_equal(new[:3].numpy(), params[[1, 3, 5]].numpy())
    assert (new[3:] == -1).all()


@pytest.mark.parametrize("engine", ["flat", "fused"])
def test_parametric_evolution_two_generations(engine):
    pe = ParametricEvolution(port_workload(_contended()), pop_size=8,
                             elite_k=3, cfg=SimConfig(track_ctime=False,
                                                      max_steps=4 * 96),
                             engine=engine, seed=1, device="cpu")
    before = pe.params.clone()
    scores = pe.eval(before).policy_score
    first = pe.run(1)
    order = torch.sort(scores, descending=True, stable=True).indices[:3]
    np.testing.assert_array_equal(pe.params[:3].numpy(),
                                  before[order].numpy())
    second = pe.run(1)
    assert pe.generation == 2 and len(pe.history) == 2
    assert second.best_score >= first.best_score
    assert pe.best_score == max(h.best_score for h in pe.history)
    assert pe.best_params.shape == (16,)
    np.testing.assert_array_equal(pe.params[:4].numpy()[0],
                                  pe.best_params.numpy())


def test_parametric_evolution_needs_a_generation():
    pe = ParametricEvolution(roomy_workload(), pop_size=4, device="cpu")
    with pytest.raises(ValueError, match="run"):
        pe.best_params  # noqa: B018
    assert pe.params.shape == (4, 16)
    np.testing.assert_array_equal(
        pe.params.numpy(),
        torch.stack([parametric.seed_weights(n)
                     for n in parametric.SEED_NAMES]).numpy())
