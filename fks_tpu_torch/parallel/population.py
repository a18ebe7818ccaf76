"""Population fitness: every candidate of a parametric population at once.

Port of fks_tpu.parallel.population. The population is ``params[P, 16]``;
the flat engine runs it as P lanes of one batched step, the fused engine
as one kernel launch with one warp per candidate. The exact heap
engine waits for a later slice of the port.
"""
from __future__ import annotations

from typing import Callable

import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.models import parametric
from fks_tpu_torch.sim import flat
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.sim.types import NodeView, PodView, SimResult

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
                         engine: str = "flat", device=None):
    """``eval(params[P, ...]) -> SimResult`` over all candidates on
    ``device`` (default ``cuda``).

    ``engine``: "flat" is the lane-batched PyTorch flat engine; "fused" is
    the CUDA kernel (flat semantics, ``parametric.score`` only)."""
    dev = resolve_device(device)
    if engine == "fused":
        return fused_runner(workload, param_policy, cfg, device=dev)
    if engine != "flat":
        raise ValueError(f"engine={engine!r} is not ported yet (the exact "
                         "heap engine waits for a later slice); use 'flat' "
                         "or 'fused'")
    wl = workload.to(dev)
    run = flat.make_population_run_fn(wl, param_policy, cfg)
    state0 = flat.initial_state(wl, cfg)

    def population_eval(params) -> SimResult:
        return run(torch.as_tensor(params).to(dev), state0)

    return population_eval


def fitness(result: SimResult) -> torch.Tensor:
    """The scalar the evolution loop ranks on."""
    return result.policy_score
