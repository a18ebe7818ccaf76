"""Hand-written scheduling policies, vectorized over lanes and nodes.

Port of the first two baselines of fks_tpu.models.zoo plus the shared
feasibility prologue, in the float32 arithmetic XLA's CPU backend gives
fks_tpu's versions (see fks_tpu_torch.models.parametric). Each factory
returns ``policy(PodView, NodeView) -> i32[L, N]``; infeasible nodes score
0 and feasible ones ``max(1, int(score))``. The other seven policies
(worst_fit, gpu_aware, utilization_based, micro_best_fit and the three
FunSearch champions) wait for a later slice.
"""
from __future__ import annotations

import torch

from fks_tpu_torch.ops.numerics import fma_f32, trunc_to_int32
from fks_tpu_torch.sim.types import NodeView, PodView, PolicyFn

_K33 = torch.tensor(0.33, dtype=torch.float32)
_K34 = torch.tensor(0.34, dtype=torch.float32)


def feasible_mask(pod: PodView, nodes: NodeView) -> torch.Tensor:
    """Resource fit + at least num_gpu GPUs with gpu_milli_left >= request
    (reference test_scheduler.py:22-33). bool[L, N]."""
    eligible = (nodes.gpu_mask
                & (nodes.gpu_milli_left >= pod.gpu_milli[..., None])
                ).sum(dim=-1)
    gpu_ok = torch.where(pod.num_gpu > 0, eligible >= pod.num_gpu, True)
    return (nodes.node_mask
            & (pod.cpu_milli <= nodes.cpu_milli_left)
            & (pod.memory_mib <= nodes.memory_mib_left)
            & (pod.num_gpu <= nodes.gpu_left)
            & gpu_ok)


def _finish(score, feasible):
    """max(1, int(score)) under the feasibility gate."""
    return torch.where(feasible, trunc_to_int32(score).clamp(min=1), 0)


def first_fit(dtype=torch.float32) -> PolicyFn:
    """Constant 1000 when feasible (reference test_scheduler.py:203-218)."""

    def policy(pod: PodView, nodes: NodeView):
        return torch.where(feasible_mask(pod, nodes), 1000, 0).to(torch.int32)

    return policy


def best_fit(dtype=torch.float32) -> PolicyFn:
    """Weighted 1 - normalized remaining, x10000 (reference
    test_scheduler.py:171-200)."""

    def policy(pod: PodView, nodes: NodeView):
        f = feasible_mask(pod, nodes)
        d = dtype
        rem_cpu = (nodes.cpu_milli_left - pod.cpu_milli).to(d)
        rem_mem = (nodes.memory_mib_left - pod.memory_mib).to(d)
        rem_gpu = (nodes.gpu_left - pod.num_gpu).to(d)
        rc = rem_cpu / nodes.cpu_milli_total.to(d)
        rm = rem_mem / nodes.memory_mib_total.to(d)
        rg = rem_gpu / nodes.num_gpus.clamp(min=1).to(d)
        if d == torch.float32:  # XLA contracts the chain (ops.numerics)
            norm = fma_f32(rg, _K34, fma_f32(rc, _K33, rm * 0.33))
        else:
            norm = rc * 0.33 + rm * 0.33 + rg * 0.34
        return _finish((1 - norm) * 10000, f)

    return policy


ZOO = {
    "first_fit": first_fit,
    "best_fit": best_fit,
}
