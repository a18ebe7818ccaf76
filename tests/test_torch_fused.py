"""fks_tpu_torch fused engine (on the CPU: the kernel's plain version) vs
fks_tpu's flat engine, the kernel's specification.

``make_fused_population_run(device="cpu")`` runs ``fused_sim``'s plain
PyTorch version; the CUDA kernel itself is held against that version on
the card (tests/test_torch_gpu.py, chip_smoke.py). The full default trace
is in test_torch_fused_default.py.
"""
import jax
import numpy as np
import pytest
import torch

from fks_tpu.models import parametric as jpar
from fks_tpu.sim import flat as jflat
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.data.build import make_workload
from fks_tpu_torch.sim import fused
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


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")


def run_both(jwl, key, pop, noise, **cfg):
    params = np.array(jpar.init_population(jax.random.PRNGKey(key), pop,
                                           noise=noise), np.float32)
    ref = jflat.make_population_run_fn(jwl, jpar.score, JaxConfig(**cfg))(
        params, jflat.initial_state(jwl, JaxConfig(**cfg)))
    run = fused.make_fused_population_run(port_workload(jwl),
                                          SimConfig(**cfg), device="cpu")
    return run(torch.from_numpy(params)), result_fields(ref)


def test_micro_population_matches(micro_workload):
    res, ref = run_both(micro_workload, 0, 8, 0.3, track_ctime=False)
    assert_result_matches(res, ref)


def test_roomy_population_matches():
    res, ref = run_both(_roomy(), 0, 8, 0.2, track_ctime=False)
    assert int(ref["truncated"].sum()) == 0
    assert_result_matches(res, ref)


def test_contended_population_matches():
    """Retries, fragmentation, silent drops and truncation."""
    res, ref = run_both(_contended(), 3, 8, 0.5, track_ctime=False,
                        max_steps=4 * 96)
    assert int(ref["num_fragmentation_events"].sum()) > 0
    assert bool(ref["truncated"].any())
    assert_result_matches(res, ref)


def test_population_not_multiple_of_eight():
    res, ref = run_both(_roomy(), 1, 5, 0.2, track_ctime=False)
    assert res.policy_score.shape == (5,)
    assert_result_matches(res, ref)


def test_plain_raw_outputs_layout():
    """The plain version returns the kernel's raw output tuple; the CPU
    path launches no kernel."""
    run = fused.make_fused_population_run(roomy_workload(),
                                          SimConfig(track_ctime=False),
                                          device="cpu")
    plan = run.plan
    params = torch.from_numpy(np.array(
        jpar.init_population(jax.random.PRNGKey(2), 3), np.float32))
    before = fused.fused_sim.launches
    aux, cpu, mem, gpu, gmil, acci, accf = fused.fused_sim(plan, params)
    assert fused.fused_sim.launches == before
    assert aux.shape == (3, plan.q) and aux.dtype == torch.int32
    assert cpu.shape == mem.shape == gpu.shape == (3, plan.n)
    assert gmil.shape == (3, plan.n, plan.g)
    assert acci.shape == (3, 8) and acci.dtype == torch.int32
    assert accf.shape == (3, 8) and accf.dtype == torch.float32
    assert (acci[:, 0] == 0).all() and (acci[:, 2] == 96).all()
    assert (aux[:, 48:] == -1).all()  # padding slots stay fresh


def test_builder_rejects_unsupported_configs():
    wl = roomy_workload()
    with pytest.raises(ValueError, match="best_fit"):
        fused.make_fused_population_run(
            wl, SimConfig(gpu_allocator="first_fit"), device="cpu")
    with pytest.raises(ValueError, match="audit"):
        fused.make_fused_population_run(
            wl, SimConfig(validate_invariants=True), device="cpu")
    for flag in (dict(decision_trace=True), dict(probe_score=True),
                 dict(node_prefilter_k=2), dict(state_pack=True),
                 dict(watchdog=True)):
        with pytest.raises(ValueError, match="fused|ported"):
            fused.make_fused_population_run(wl, SimConfig(**flag),
                                            device="cpu")


def test_unpacked_shapes_rejected():
    nodes = [{"node_id": f"n{i}", "cpu_milli": 1000, "memory_mib": 1000,
              "gpus": [1000] * 30} for i in range(5)]
    pods = [{"pod_id": "p0", "cpu_milli": 1, "memory_mib": 1, "num_gpu": 0,
             "gpu_milli": 0, "creation_time": 0, "duration_time": 1}]
    wl = make_workload(nodes, pods, pad_nodes_to=8)
    with pytest.raises(ValueError, match="packed aux"):
        fused.make_fused_population_run(wl, SimConfig(), device="cpu")


def test_shared_memory_guard_rejects_scale_shapes():
    """Per-lane state over a block's 227 KB raises and names the flat
    engine (the port's form of fks_tpu's VMEM guard)."""
    nodes = [{"node_id": "n0", "cpu_milli": 1000, "memory_mib": 1000,
              "gpus": [1000]}]
    pods = [{"pod_id": f"p{i:05d}", "cpu_milli": 1, "memory_mib": 1,
             "num_gpu": 0, "gpu_milli": 0, "creation_time": i,
             "duration_time": 1} for i in range(30_000)]
    wl = make_workload(nodes, pods)
    assert fused.smem_bytes(30_080, 1, 1, 1001) > fused.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared-memory.*engine='flat'"):
        fused.make_fused_population_run(wl, SimConfig(), device="cpu")


def test_default_trace_fits_shared_memory(default_workload):
    per_lane = fused.smem_bytes(8192, 16, 8, 1002)
    assert per_lane < 72 * 1024  # ~70 KiB: three lanes per SM
    assert 3 * per_lane <= 228 * 1024


def test_cuda_without_card_raises(no_card):
    wl = roomy_workload()
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.make_fused_population_run(wl, SimConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.make_fused_population_run(wl, SimConfig())  # default: cuda
