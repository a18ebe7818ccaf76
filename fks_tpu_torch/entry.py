"""Driver entry points: a one-device run check and a multi-device dry run.

Port of fks_tpu's ``__graft_entry__.py``.

``entry()`` returns ``(fn, example_args)``: the full discrete-event
schedule of a tiny workload under a parametric policy (heap, placement,
GPU sub-allocation, evaluator; the ``param_score`` kernel on the card),
to check that the whole engine runs on one device.

``dryrun_multichip(n)`` runs ONE sharded evolution generation step over
``n`` devices (per-shard evaluation -> gathered fitness -> global top-k
elites -> mutation) on the tiny workload, for both candidate payloads:
the parametric weight matrix (``parallel.mesh.
make_sharded_generation_step`` and ``make_sharded_eval``, and the 2-D
hybrid mesh for even ``n >= 4``) and a stacked VM code-candidate batch
(``make_sharded_code_eval``, segmented). Each is held against its
single-device run. The ``n`` devices are ``n`` cards when the machine
has them, else ``n`` logical shards of one card, or ``n`` logical CPU
shards with ``device="cpu"`` (fks_tpu re-initialises JAX as an
``n``-device virtual CPU platform instead).
"""
from __future__ import annotations

import torch


def _tiny_workload():
    from fks_tpu_torch.data.build import make_workload

    nodes = [
        {"node_id": "n1", "cpu_milli": 8000, "memory_mib": 16000,
         "gpus": [1000, 1000], "gpu_memory_mib": 8000},
        {"node_id": "n2", "cpu_milli": 4000, "memory_mib": 8000, "gpus": []},
    ]
    pods = [
        {"pod_id": "p1", "cpu_milli": 1000, "memory_mib": 2000, "num_gpu": 0,
         "gpu_milli": 0, "creation_time": 0, "duration_time": 10},
        {"pod_id": "p2", "cpu_milli": 2000, "memory_mib": 4000, "num_gpu": 1,
         "gpu_milli": 500, "creation_time": 5, "duration_time": 15},
        {"pod_id": "p3", "cpu_milli": 3000, "memory_mib": 6000, "num_gpu": 0,
         "gpu_milli": 0, "creation_time": 10, "duration_time": 8},
        {"pod_id": "p4", "cpu_milli": 1500, "memory_mib": 3000, "num_gpu": 2,
         "gpu_milli": 400, "creation_time": 15, "duration_time": 12},
    ]
    return make_workload(nodes, pods, pad_nodes_to=4, pad_gpus_to=4,
                         pad_pods_to=8)


def entry(device=None):
    """``(fn, (params, state0))``: ``fn(params, state0)`` is the full
    simulation of the tiny workload under ``parametric.score`` with the
    best_fit weights, on ``device`` (default the card), returning the
    policy score. ``fn`` leaves ``state0`` as it was, so it can run
    again."""
    from fks_tpu_torch.device import resolve_device
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.sim.engine import (
        SimConfig, initial_state, make_param_run_fn,
    )
    from fks_tpu_torch.sim.types import clone_tensors

    dev = resolve_device(device)
    wl = _tiny_workload().to(dev)
    cfg = SimConfig()
    run = make_param_run_fn(wl, parametric.score, cfg)
    params = parametric.seed_weights("best_fit").to(dev)
    state0 = initial_state(wl, cfg)

    def fn(params, state):
        return run(params, clone_tensors(state)).lane(0).policy_score

    return fn, (params, state0)


def mesh_devices(n_devices: int, device=None) -> list:
    """The ``n_devices`` devices of the dry run (module docstring)."""
    from fks_tpu_torch.device import resolve_device
    from fks_tpu_torch.parallel.mesh import cuda_devices

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return cuda_devices(n_devices)
    return [dev] * n_devices


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One full population-sharded evolution generation over an
    ``n_devices``-device mesh, for the weight matrix and for stacked VM
    programs, each held against its single-device run (module
    docstring). Raises on any disagreement; returns what it compared."""
    from fks_tpu_torch.funsearch import vm
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.parallel import (
        hybrid_population_mesh, make_population_eval, make_sharded_code_eval,
        make_sharded_eval, make_sharded_generation_step, pad_population,
        population_mesh,
    )
    from fks_tpu_torch.sim import flat
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.sim.types import map_tensors

    devices = mesh_devices(n_devices, device)
    lead = devices[0]
    mesh = population_mesh(devices)
    wl = _tiny_workload()

    gen = torch.Generator(device=lead)
    gen.manual_seed(0)
    pop = parametric.init_population(gen, 2 * n_devices, noise=0.1)

    # full generation step: sharded eval -> gather -> top-k -> mutate
    elite_k = min(4, n_devices)
    step = make_sharded_generation_step(wl, mesh, elite_k=elite_k)
    new_pop, scores, elite_scores = step(pop, 1)
    if tuple(new_pop.shape) != tuple(pop.shape):
        raise AssertionError(f"generation step changed the population's "
                             f"shape: {tuple(new_pop.shape)}")
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"non-finite scores: {scores}")
    # the elites survive in the leading slots
    order = torch.sort(scores, descending=True, stable=True).indices
    if not torch.equal(new_pop[:elite_k], pop[order[:elite_k]]):
        raise AssertionError("the elites did not survive in the leading "
                             "slots")

    # sharded eval entry point, and the single-device run
    ev = make_sharded_eval(wl, mesh, elite_k=elite_k)
    s2, _, _ = ev(pop)
    single = make_population_eval(wl, device=lead)(pop).policy_score
    for name, got in (("sharded eval", s2), ("generation step", scores)):
        if not torch.equal(got.cpu(), single.cpu()):
            raise AssertionError(f"{name} scores {got} != single-device "
                                 f"{single}")
    out = {"devices": [str(d) for d in devices], "pop": int(pop.shape[0]),
           "scores": single.cpu().tolist(),
           "elite_scores": elite_scores.cpu().tolist()}

    # multi-slice topology: a 2-D hybrid mesh, elites gathered over both
    if n_devices % 2 == 0 and n_devices >= 4:
        hmesh = hybrid_population_mesh(devices, num_slices=2)
        hs, _, _ = make_sharded_eval(wl, hmesh, elite_k=elite_k)(pop)
        if not torch.equal(hs.cpu(), single.cpu()):
            raise AssertionError(f"hybrid-mesh scores {hs} != {single}")
        out["hybrid"] = True

    # VM code-candidate tier: FakeLLM candidates lowered to programs,
    # stacked and sharded over the same mesh (segmented runner), against
    # the single-device flat population run; pad slots never win elites
    c = wl.cluster
    progs, _ = vm.lower_fake_candidates(c.n_padded, c.g_padded,
                                        max(2, n_devices - 2))
    if len(progs) < 2:
        raise AssertionError("FakeLLM produced no VM-vocabulary candidates")
    stacked = vm.stack_programs(progs)
    padded, real = pad_population(stacked, mesh)
    cfg = SimConfig()
    code_eval = make_sharded_code_eval(wl, mesh, cfg=cfg,
                                       elite_k=min(2, len(progs)),
                                       engine="flat", seg_steps=16)
    res, elite_idx, _ = code_eval(padded, real)
    wl_lead = wl.to(lead)
    ref = flat.make_population_run_fn(wl_lead, vm.score_static, cfg)(
        map_tensors(lambda x: x.to(lead), stacked),
        flat.initial_state(wl_lead, cfg))
    got = res.policy_score[:real].double().cpu()
    want = ref.policy_score.double().cpu()
    if not bool(((got - want).abs() <= 1e-9).all()):
        raise AssertionError(f"sharded code eval {got} != single-device "
                             f"{want}")
    if not bool((elite_idx < real).all()):
        raise AssertionError(f"a pad slot won an elite: {elite_idx}")
    out["code_scores"] = want.tolist()
    return out
