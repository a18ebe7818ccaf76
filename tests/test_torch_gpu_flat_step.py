"""The flat engine's kernel step on the card (``csrc/flat_step.cu``:
``flat_pop`` and ``flat_commit`` around the policy call) against the
PyTorch step (``sim.flat.build_torch_step``): through the population
runner, every ``FlatState`` tensor bit for bit after every graph replay,
and the final ``SimResult``.

Marked ``gpu``: these need a CUDA card and skip without one. Run them on
the GPU machine with

    python -m pytest -p no:cacheprovider -m gpu tests/test_torch_gpu_flat_step.py

The file imports only torch and the port (and the benchmark's input
reader for the 1,213-node park), so it runs where JAX is not installed.
"""
import json
import pathlib

import pytest
import torch

from fks_tpu_torch.data import TraceParser
from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.obs import spans
from fks_tpu_torch.sim import flat, flat_step
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import contended_workload, flat_lockstep

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL_CFG = SimConfig(track_ctime=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def population(pop: int, dev, seed: int = 0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return parametric.init_population(gen, pop, noise=0.5)


def lockstep(wl, cfg, policy, params):
    """``testing.flat_lockstep`` of the PyTorch step and ``build_step``
    (the kernel step here), with the kernels' launches counted: each
    launches once a step of the captured graph, then only replays."""
    pops, commits = flat_step.flat_pop.launches, \
        flat_step.flat_commit.launches
    advances, runners, (ref, got) = flat_lockstep(
        wl, cfg, policy, params, (flat.build_torch_step, flat.build_step))
    torch.cuda.synchronize()
    (chunk,) = runners[1].graphs.values()
    assert chunk.kernel_step
    assert not next(iter(runners[0].graphs.values())).kernel_step
    # the eager warm-up and the capture: one launch each a step
    assert flat_step.flat_pop.launches - pops == 2 * chunk.steps
    assert flat_step.flat_commit.launches - commits == 2 * chunk.steps
    return advances, ref


@pytest.fixture(scope="module")
def default_trace():
    return TraceParser().parse_workload()


@pytest.mark.parametrize("pop", [32, 1, 33])
def test_default_trace_bit_for_bit(cuda, default_trace, pop):
    wl = default_trace.to(cuda)
    advances, res = lockstep(wl, CELL_CFG, parametric.score,
                             population(pop, cuda))
    assert advances > 8152 * 2 // 16
    assert int(res.scheduled_pods.max()) > 0


def test_openb1213_park_bit_for_bit(cuda):
    from portbench.loops import inputs

    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "openb1213.json").read_text())
    wl = inputs.port_workload(cfg, 1024).to(cuda)
    assert wl.cluster.n_padded == 1213
    _, res = lockstep(wl, CELL_CFG, parametric.score, population(32, cuda))
    assert int(res.scheduled_pods.min()) > 0


@pytest.mark.parametrize("cfg", [
    SimConfig(track_ctime=True),
    SimConfig(track_ctime=False, gpu_allocator="first_fit"),
    SimConfig(track_ctime=True, gpu_allocator="first_fit"),
    SimConfig(track_ctime=False, score_dtype=torch.float64),
], ids=["best_fit-ctime", "first_fit", "first_fit-ctime", "f64"])
def test_configurations_bit_for_bit(cuda, cfg):
    wl = TraceParser().parse_workload(max_pods=2048).to(cuda)
    lockstep(wl, cfg, parametric.score, population(32, cuda, seed=1))


def test_a_lane_stops_at_max_steps(cuda, default_trace):
    wl = default_trace.to(cuda)
    cfg = SimConfig(track_ctime=False, max_steps=1000)
    _, res = lockstep(wl, cfg, parametric.score, population(8, cuda))
    assert bool(res.truncated.all())


def _refuse(_p, pod, nodes):  # every CREATE fails: retries, then drops
    return torch.zeros_like(nodes.cpu_milli_left)


def _liar(_p, pod, nodes):  # every node scores 1: GPU picks fail
    return torch.ones_like(nodes.cpu_milli_left)


@pytest.mark.parametrize("policy", ["parametric", "refuse", "liar"])
def test_contended_retries_drops_and_failures(cuda, policy):
    wl = contended_workload().to(cuda)
    cfg = SimConfig(track_ctime=True, max_steps=4 * 96)
    fn = {"parametric": parametric.score, "refuse": _refuse,
          "liar": _liar}[policy]
    _, res = lockstep(wl, cfg, fn, population(13, cuda, seed=3))
    if policy == "refuse":
        assert int(res.scheduled_pods.sum()) == 0
        assert int(res.num_fragmentation_events.min()) > 0
    if policy == "liar":
        assert bool(res.failed.all())


@pytest.mark.parametrize("nodes, gpus, hist, slots", [
    (0, 16, None, 0), (1, 9, None, 0), (0, 2, 3000, 0), (0, 2, None, 3)],
    ids=["g16", "g9-odd-nodes", "wide-histogram", "odd-queue"])
def test_padded_shapes_bit_for_bit(cuda, nodes, gpus, hist, slots):
    """The kernels' other loads: GPU rows that are not a multiple of 4
    GPUs a node in all (a commit's second pass one GPU a load), a
    histogram wider than one round of the commit's first pass, a queue
    that is not a multiple of 4 slots (the pop one slot a load)."""
    from fks_tpu_torch.data.synthetic import BucketShape, pad_workload

    wl = contended_workload()  # 4 nodes of 2 GPUs, 128 slots
    wl = pad_workload(wl, BucketShape(n=wl.cluster.n_padded + nodes, g=gpus,
                                      p=wl.pods.p_padded + slots))
    cfg = SimConfig(track_ctime=True, max_steps=4 * 96, wait_hist_size=hist)
    _, res = lockstep(wl.to(cuda), cfg, parametric.score,
                      population(13, cuda, seed=4))
    assert int(res.num_fragmentation_events.max()) > 0


def test_zoo_policy_through_the_same_kernels(cuda):
    wl = TraceParser().parse_workload(max_pods=2048).to(cuda)
    best_fit = zoo.ZOO["best_fit"]()
    params = torch.zeros((16, 1), device=cuda)  # the zoo policy reads none
    _, res = lockstep(wl, CELL_CFG,
                      lambda _p, pod, nodes: best_fit(pod, nodes), params)
    assert torch.equal(res.policy_score, res.policy_score[:1].expand(16))


def test_search_generations_run_only_kernel_steps(cuda):
    """``drain`` counts ``kernel_steps`` beside ``steps``: in every
    generation of the flat search they are equal."""
    pe = ParametricEvolution(TraceParser().parse_workload(max_pods=1024),
                             pop_size=32, elite_k=4, engine="flat",
                             cfg=CELL_CFG, device=cuda)
    spans.ring().clear()
    pe.run(2)
    torch.cuda.synchronize()
    gens = [r for r in spans.ring() if r.label == "gen"]
    assert len(gens) == 2
    for rec in gens:
        c = rec.counters
        assert c["steps"] > 0 and c["kernel_steps"] == c["steps"]
    spans.ring().clear()


def test_the_step_is_three_launches(cuda):
    """A captured step is ``flat_pop``, ``param_score`` and
    ``flat_commit``: the profiler sees three kernels a step in a replay."""
    from torch.profiler import ProfilerActivity, profile

    wl = TraceParser().parse_workload(max_pods=1024).to(cuda)
    run = flat.make_population_run_fn(wl, parametric.score, CELL_CFG)
    job = run.start(population(32, cuda), flat.initial_state(wl, CELL_CFG))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        job.advance()
        torch.cuda.synchronize()
    kernels = [ev.name() for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA]
    steps = job.chunk.steps
    assert sum("flat_pop_kernel" in n for n in kernels) == steps, kernels
    assert sum("flat_commit_kernel" in n for n in kernels) == steps
    assert sum("param_score_kernel" in n for n in kernels) == steps
    assert len(kernels) == 3 * steps, kernels
    run.finish(job)
