"""The flat engine's kernel step on the CPU: which configurations
``sim.flat.build_step`` gives the kernel step (``sim.flat_step``,
``csrc/flat_step.cu``), and the kernels' plain versions (``pop_plain``,
``commit_plain``, what the wrappers run for a CPU state) held bit for bit
to the PyTorch step, the state after every advance of the population
runner and the final ``SimResult``.

The kernels themselves run only on the card:
``tests/test_torch_gpu_flat_step.py`` holds them to the PyTorch step
there.
"""
import dataclasses

import pytest
import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.data.synthetic import BucketShape, pad_workload, \
    synthetic_workload
from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.obs import spans
from fks_tpu_torch.scenarios import get_suite
from fks_tpu_torch.sim import engine, flat, flat_step
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    contended_workload, flat_lockstep, one_torch_thread, roomy_workload,
    tied_workload,
)

#: the benchmark's flat configuration (``tools.discover``'s)
CELL_CFG = SimConfig(track_ctime=False)


@pytest.fixture(scope="module")
def wl():
    return synthetic_workload(6, 80, seed=1)


def report_device(monkeypatch, device: torch.device) -> None:
    """Every workload reports ``device`` (its tensors stay on the CPU):
    the engagement rule's checks past the device, on a machine with no
    card."""
    monkeypatch.setattr(Workload, "device", property(lambda self: device))


@pytest.fixture
def on_cuda(monkeypatch):
    report_device(monkeypatch, torch.device("cuda"))


def test_the_cell_configuration_takes_the_kernel_step_on_cuda(wl, on_cuda):
    assert flat.kernel_step_blocker(wl, CELL_CFG) is None
    assert flat.kernel_step_blocker(wl, SimConfig()) is None
    for cfg in (SimConfig(gpu_allocator="first_fit"),
                SimConfig(score_dtype=torch.float64),
                SimConfig(max_steps=100),
                SimConfig(node_prefilter_k=wl.cluster.n_padded)):
        assert flat.kernel_step_blocker(wl, cfg) is None


@pytest.mark.parametrize("why, kw", [
    ("decision_trace", dict(cfg=SimConfig(decision_trace=True))),
    ("validate_invariants", dict(cfg=SimConfig(validate_invariants=True))),
    ("watchdog", dict(cfg=SimConfig(watchdog=True))),
    ("node_prefilter_k", dict(cfg=SimConfig(node_prefilter_k=2))),
    ("state_pack", dict(cfg=SimConfig(state_pack=True))),
    ("score_dtype", dict(cfg=SimConfig(score_dtype=torch.bfloat16))),
    ("lane_trace", dict(lane_trace=torch.zeros(2, dtype=torch.int64))),
    ("pod_rows", dict(pod_rows=torch.zeros((80, 5), dtype=torch.int32))),
    ("not CUDA", dict(device=torch.device("cpu"))),
])
def test_each_fallback_condition_keeps_the_pytorch_step(wl, monkeypatch,
                                                        why, kw):
    kw = dict(dict(device=torch.device("cuda"), cfg=CELL_CFG), **kw)
    report_device(monkeypatch, kw.pop("device"))
    assert flat.kernel_step_blocker(wl, kw.pop("cfg"), **kw) == why


def test_a_cpu_workload_keeps_the_pytorch_step(wl):
    assert wl.device.type == "cpu"
    assert flat.kernel_step_blocker(wl, CELL_CFG) == "not CUDA"


def test_faults_and_unpacked_aux_keep_the_pytorch_step(wl, monkeypatch):
    suite = get_suite("smoke3", synthetic_workload(4, 24, seed=3))
    faulted = [w for w in suite.workloads if w.faults is not None]
    assert faulted
    wide = pad_workload(wl, BucketShape(n=wl.cluster.n_padded, g=32,
                                        p=wl.pods.p_padded))
    assert not flat._packable(wide.cluster.n_padded, wide.cluster.g_padded)
    report_device(monkeypatch, torch.device("cuda"))
    assert flat.kernel_step_blocker(faulted[0], CELL_CFG) == "faults"
    assert flat.kernel_step_blocker(wide, CELL_CFG) == "unpacked aux"


def test_build_step_builds_the_pytorch_step_on_the_cpu(wl):
    ktable, max_steps = engine.loop_tables(wl, CELL_CFG)
    step = flat.build_step(wl, zoo.ZOO["best_fit"](), CELL_CFG, ktable,
                           max_steps)
    assert not getattr(step, "kernel_step", False)
    kstep = flat_step.build_kernel_step(wl, zoo.ZOO["best_fit"](), CELL_CFG,
                                        ktable, max_steps)
    assert kstep.kernel_step


def _liar(_p, pod, nodes):  # scores every node 1: GPU picks fail
    return torch.ones_like(nodes.cpu_milli_left)


def _refuse(_p, pod, nodes):  # scores every node 0: every CREATE fails
    return torch.zeros_like(nodes.cpu_milli_left)


def _zoo_best_fit(_p, pod, nodes):
    return zoo.ZOO["best_fit"]()(pod, nodes)


POLICIES = {"parametric": parametric.score, "liar": _liar,
            "refuse": _refuse, "zoo_best_fit": _zoo_best_fit}
WORKLOADS = {"synthetic": lambda: synthetic_workload(6, 80, seed=1),
             "contended": contended_workload, "roomy": roomy_workload,
             "tied": tied_workload}
#: the tied workload's retry storm cut to its first 1,024 steps
STEPS = {"tied": 1024}
CONFIGS = {"cell": CELL_CFG, "ctime": SimConfig(),
           "first_fit": SimConfig(gpu_allocator="first_fit"),
           "max_steps": SimConfig(max_steps=40, track_ctime=False),
           "f64": SimConfig(score_dtype=torch.float64)}


def run_both(wl, cfg, policy, pop: int, seed: int = 1):
    """The PyTorch step's and the kernel step's population runners over
    one population in lockstep (``testing.flat_lockstep``)."""
    params = parametric.init_population(
        torch.Generator().manual_seed(seed), pop, noise=0.5)
    advances, _, results = flat_lockstep(
        wl, cfg, policy, params,
        (flat.build_torch_step, flat_step.build_kernel_step))
    return advances, results


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_plain_halves_equal_the_pytorch_step(workload, policy):
    with one_torch_thread():
        cfg = dataclasses.replace(CELL_CFG, max_steps=STEPS.get(workload))
        advances, (a, _) = run_both(WORKLOADS[workload](), cfg,
                                    POLICIES[policy], pop=3)
    assert advances > 0
    if (policy, workload) == ("liar", "contended"):
        # a GPU pod on a node whose GPUs it does not fit aborts its lane
        assert bool(a.failed.all())
    if policy == "refuse":  # nothing placed: no DELETE, every CREATE drops
        assert int(a.scheduled_pods.sum()) == 0


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plain_halves_equal_the_pytorch_step_per_config(config):
    with one_torch_thread():
        _, (a, _) = run_both(contended_workload(), CONFIGS[config],
                             parametric.score, pop=4, seed=2)
    if config == "max_steps":
        assert bool(a.truncated.all())


def test_kernel_step_updates_in_place(wl):
    ktable, max_steps = engine.loop_tables(wl, CELL_CFG)
    step = flat_step.build_kernel_step(wl, zoo.ZOO["best_fit"](), CELL_CFG,
                                       ktable, max_steps)
    s = engine.broadcast_state(flat.initial_state(wl, CELL_CFG), 2)
    leaves = [x.data_ptr() for x in engine._tensor_leaves(s)]
    out = step(s)
    assert out is s
    assert [x.data_ptr() for x in engine._tensor_leaves(out)] == leaves
    assert out.steps.tolist() == [1, 1]


def test_wrappers_refuse_a_state_the_kernels_do_not_take(wl):
    ktable, max_steps = engine.loop_tables(wl, CELL_CFG)
    tab = flat_step.step_tables(wl, CELL_CFG, ktable, max_steps)
    s = engine.broadcast_state(flat.initial_state(wl, CELL_CFG), 2)
    rows = torch.zeros((2, len(flat_step.SCRATCH)), dtype=torch.int32)
    assert flat_step._checked(s, rows, tab) == (2, wl.pods.p_padded)
    bad = dataclasses.replace(s, cpu_left=s.cpu_left.t().contiguous().t())
    with pytest.raises(ValueError, match="cpu_left"):
        flat_step._checked(bad, rows, tab)
    with pytest.raises(ValueError, match="scratch"):
        flat_step._checked(s, rows[:, :4], tab)


def test_threads_are_whole_warps_up_to_the_most():
    assert [flat_step.threads(x, 1024) for x in (1, 32, 33, 1001, 2038,
                                                 10**6)] \
        == [32, 32, 64, 1024, 1024, 1024]
    assert flat_step.threads(-(-1213 // 4), flat_step.COMMIT_THREADS) == 320


class _Job:
    """A graphed job stand-in whose chunk's step is (or is not) the kernel
    step."""

    def __init__(self, replays, kernel_step):
        self.left = replays
        self.chunk = type("Chunk", (), {"steps": 16,
                                        "kernel_step": kernel_step})()
        self.stream = None

    def active(self):
        return self.left > 0

    def read(self, flag):
        return flag

    def advance(self):
        self.left -= 1


def test_drain_counts_the_kernel_steps(monkeypatch):
    spans.ring().clear()
    monkeypatch.setattr(engine, "_ReplayClock", _NoClock)
    with spans.span("drain"):
        engine.drain([_Job(3, True), _Job(2, False)])
    c = list(spans.ring())[-1].counters
    assert c["steps"] == 80 and c["kernel_steps"] == 48
    with spans.span("drain"):
        engine.drain([_Job(2, False)])
    assert "kernel_steps" not in list(spans.ring())[-1].counters
    spans.ring().clear()


class _NoClock:
    """``engine._ReplayClock`` without CUDA events."""

    device_s = gap_s = 0.0

    def __init__(self, stream):
        pass

    def replay(self, job):
        job.advance()

    def turn(self):
        pass
