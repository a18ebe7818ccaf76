"""The fused CUDA kernel against its plain PyTorch version, and the exact
engine's captured CUDA graphs against its CPU run, on the card.

Marked ``gpu``: these need a CUDA card and skip without one. Run them on
the GPU machine with

    python -m pytest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The file imports only torch, so it runs where JAX is not installed.
"""
import gc

import pytest
import torch

from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.parallel import make_population_eval
from fks_tpu_torch.sim import engine, fused
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, contended_workload, golden_micro_workload,
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
