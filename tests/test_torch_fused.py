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

from fks_tpu.data.build import make_workload as jax_make_workload
from fks_tpu.models import parametric as jpar
from fks_tpu.sim import flat as jflat
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.data.build import make_workload
from fks_tpu_torch.sim import fused
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, port_workload, result_fields,
    roomy_workload, tied_workload, tied_workload_specs,
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


def test_tied_workload_matches():
    """Equal creation times across chunk boundaries of the kernel's queue
    (Q = 1,024, 32 chunks) and retries that land on times other slots
    hold: the port's fused run equals fks_tpu's flat engine."""
    nodes, pods, pad = tied_workload_specs()
    res, ref = run_both(jax_make_workload(nodes, pods, **pad), 4, 4, 0.5,
                        track_ctime=False)
    assert_result_matches(res, ref)
    assert fused.make_fused_population_run(
        tied_workload(), SimConfig(), device="cpu").plan.q == 1024
    # each failed placement is a retry or a drop, and a dropped pod ends
    # unplaced: more failures than unplaced pods means retries happened
    unplaced = (ref["assigned_node"] < 0).sum(axis=1)
    assert (ref["num_fragmentation_events"] > unplaced).all()


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


def test_builder_rejects_shapes_past_kernel_limits():
    """The kernel's register bitmap covers 4,096 waiting-histogram buckets,
    and its GPU keys and fragmentation sums need bounded GPU milli."""
    with pytest.raises(ValueError, match="histogram.*engine='flat'"):
        fused.make_fused_population_run(
            roomy_workload(), SimConfig(wait_hist_size=5000), device="cpu")
    fused.make_fused_population_run(
        roomy_workload(), SimConfig(wait_hist_size=4096), device="cpu")
    nodes = [{"node_id": "n0", "cpu_milli": 1000, "memory_mib": 1000,
              "gpus": [2**26]}]
    pods = [{"pod_id": "p0", "cpu_milli": 1, "memory_mib": 1, "num_gpu": 0,
             "gpu_milli": 0, "creation_time": 0, "duration_time": 1}]
    with pytest.raises(ValueError, match="GPU milli.*engine='flat'"):
        fused.make_fused_population_run(make_workload(nodes, pods),
                                        SimConfig(), device="cpu")


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


def layout_ints(q, n, g, hist):
    """The kernel's shared-memory layout, int32 by int32: ev and aux; two
    chunk-minimum arrays of 32 x run (run = chunks per thread, rounded up);
    eight words per node; three GPU grids whose rows hold G rounded up to
    8, plus one; the waiting histogram."""
    chunks = q // 32
    run = (chunks + 31) // 32
    row = (g + 7) // 8 * 8 + 1
    return 2 * q + 2 * 32 * run + 8 * n + 3 * n * row + hist


def test_default_trace_fits_shared_memory(default_workload):
    per_lane = fused.smem_bytes(8192, 16, 8, 1002)
    # 64 KiB queue + 2 KiB chunk minima + node rows and histogram
    assert per_lane == 4 * (16384 + 512 + 128 + 432 + 1002) == 73_832
    assert 3 * per_lane <= 228 * 1024  # three lanes per SM


@pytest.mark.parametrize("q", [1024, 9088, 9472])
def test_smem_bytes_matches_layout(q):
    """Q = 9,088 and 9,472 (the multigpu50 and cpu250 traces) have 284 and
    296 chunks: not a multiple of 32, so threads own run = 9 and 10 chunks
    and the tail of the chunk-minimum arrays is padding."""
    assert fused.smem_bytes(q, 16, 8, 1002) == 4 * layout_ints(q, 16, 8, 1002)
    assert fused.smem_bytes(q, 4, 2, 1001) == 4 * layout_ints(q, 4, 2, 1001)


def test_cuda_without_card_raises(no_card):
    wl = roomy_workload()
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.make_fused_population_run(wl, SimConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.make_fused_population_run(wl, SimConfig())  # default: cuda
