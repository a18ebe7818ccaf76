"""Population fitness: every candidate of a parametric population at once.

Port of fks_tpu.parallel.population. The population is ``params[P, 16]``;
the exact and flat engines run it as P lanes of one batched step (on the
card, replayed as a CUDA graph for the exact engine), the fused engine as
one kernel launch with one warp per candidate. ``pad_population`` and the
occupancy counters are the mesh-free helpers of fks_tpu.parallel.mesh
that the budget rungs use.
"""
from __future__ import annotations

from typing import Callable

import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.models import parametric
from fks_tpu_torch.sim import get_engine
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.sim.types import (
    NodeView, PodView, SimResult, as_params, batch_size, map_tensors,
)

# (params, PodView, NodeView) -> i32[L, N] scores
ParamPolicyFn = Callable[[torch.Tensor, PodView, NodeView], torch.Tensor]


def fused_runner(workload: Workload, param_policy, cfg: SimConfig,
                 device=None):
    """The one dispatch point for the fused engine. The kernel hard-wires
    the parametric feature basis, so any other policy is rejected."""
    if param_policy is not parametric.score:
        raise ValueError("engine='fused' hard-wires the parametric feature "
                         "basis; pass param_policy=parametric.score or use "
                         "engine='flat'")
    from fks_tpu_torch.sim import fused
    return fused.make_fused_population_run(workload, cfg, device=device)


def make_population_eval(workload: Workload,
                         param_policy: ParamPolicyFn = parametric.score,
                         cfg: SimConfig = SimConfig(),
                         engine: str = "exact", device=None):
    """``eval(params[P, ...]) -> SimResult`` over all candidates on
    ``device`` (default ``cuda``).

    ``engine``: "exact" (the default, as in fks_tpu) is the heap replica,
    reference parity bit for bit; "flat" is the slot-per-pod engine
    (its own retry rule); "fused" is the CUDA kernel (flat semantics,
    ``parametric.score`` only)."""
    dev = resolve_device(device)
    if engine == "fused":
        return fused_runner(workload, param_policy, cfg, device=dev)
    mod = get_engine(engine)
    wl = workload.to(dev)
    run = mod.make_population_run_fn(wl, param_policy, cfg)
    state0 = mod.initial_state(wl, cfg)

    def population_eval(params) -> SimResult:
        return run(map_tensors(lambda x: x.to(dev), as_params(params)),
                   state0)

    population_eval.run = run  # the engine's runner (captured graphs)
    return population_eval


def fitness(result: SimResult) -> torch.Tensor:
    """The scalar the evolution loop ranks on."""
    return result.policy_score


def pad_population(params, num_shards: int):
    """Pad the candidate axis up to a multiple of ``num_shards``: every
    tensor of ``params`` (a weight matrix ``[C, F]`` or a stacked
    ``vm.VMProgram``) repeats its last candidate's slice. Returns
    ``(padded, real_count)``; pass ``real_count`` on so the pad slots
    (duplicates of the last candidate) are masked out of elite selection.
    Mesh-free part of fks_tpu.parallel.mesh.pad_population: the mesh
    itself waits for ROADMAP queue 1 item 3."""
    c = batch_size(params)
    target = -(-c // num_shards) * num_shards
    if target != c:
        params = map_tensors(
            lambda x: torch.cat([x, x[-1:].expand(
                (target - c,) + tuple(x.shape[1:]))]), params)
    return params, c


def pad_stats(real_count: int, num_shards: int) -> dict:
    """Pad-lane accounting for a ``pad_population`` launch: how many of
    the launched lanes repeat the last candidate instead of doing real
    work (fks_tpu.parallel.mesh.pad_stats)."""
    real = int(real_count)
    padded = -(-real // num_shards) * num_shards if real else 0
    return {
        "real_count": real,
        "padded_count": padded,
        "pad_lanes": padded - real,
        "pad_waste_fraction": (padded - real) / padded if padded else 0.0,
    }


def occupancy_stats(real_count: int, num_shards: int, scenarios: int = 1,
                    segments: int = 1) -> dict:
    """``pad_stats`` extended with the other two batch axes a launch
    multiplies over, scenarios and trace segments:
    ``launched_lane_steps`` is the lane-dispatch count, ``real_lane_steps``
    the share that was real candidates (fks_tpu.parallel.mesh.
    occupancy_stats)."""
    s = pad_stats(real_count, num_shards)
    scenarios = max(1, int(scenarios))
    segments = max(1, int(segments))
    s["scenarios"] = scenarios
    s["segments"] = segments
    s["launched_lane_steps"] = s["padded_count"] * scenarios * segments
    s["real_lane_steps"] = s["real_count"] * scenarios * segments
    return s
