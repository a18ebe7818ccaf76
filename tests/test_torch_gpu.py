"""The fused CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``: these need a CUDA card and skip without one. Run them on
the GPU machine with

    python -m pytest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The file imports only torch, so it runs where JAX is not installed.
"""
import pytest
import torch

from fks_tpu_torch.models import parametric
from fks_tpu_torch.sim import fused
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import contended_workload, roomy_workload

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


@pytest.mark.parametrize("case", ["roomy", "contended"])
def test_kernel_matches_plain_version(cuda, case):
    if case == "roomy":
        wl, cfg, noise = roomy_workload(), SimConfig(track_ctime=False), 0.2
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
