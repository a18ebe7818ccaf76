"""Hand-written scheduling policies, vectorized over lanes and nodes.

Port of fks_tpu.models.zoo: the shared feasibility prologue, the five
baselines (first_fit, best_fit, worst_fit, gpu_aware, utilization_based),
the micro-scenario ``micro_best_fit`` and the three FunSearch champions.
Each factory takes ``dtype`` (float64 reproduces the reference's Python
floats; float32 is the fast default) and returns
``policy(PodView, NodeView) -> i32[L, N]``; infeasible nodes score 0 and
feasible ones ``max(1, int(score))``.

Arithmetic notes:

- integer ``%`` and ``//`` floor, as the reference's Python ints and jnp;
- a division by a constant divides by a tensor: PyTorch's CUDA ``x / c``
  with a Python scalar c multiplies by 1/c, which is not the IEEE quotient;
- float32 follows the arithmetic XLA's CPU backend gives fks_tpu's
  versions where it contracts a multiply-add (``ops.numerics.fma_f32``);
  ``tests/test_torch_zoo.py`` lists the float32 forms that still differ.
"""
from __future__ import annotations

import torch

from fks_tpu_torch.ops.numerics import fma_f32, trunc_to_int32
from fks_tpu_torch.sim.types import NodeView, PodView, PolicyFn

_THIRD = float(torch.tensor(1 / 3, dtype=torch.float32))


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


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``x``'s dtype and device (a divisor
    that divides, see the module docstring)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _ratio(num: torch.Tensor, den: torch.Tensor, d) -> torch.Tensor:
    return num.to(d) / den.to(d)


def _wsum(terms) -> torch.Tensor:
    """``x1 * c1 + x2 * c2 + ...`` for ``(x, c)`` pairs, left to right.
    In float32 it is the chain XLA's CPU backend compiles:
    ``fma(x1, c1, x2 * c2)``, then ``fma(xk, ck, acc)`` per term (a
    subtraction is a negative ``c``)."""
    (x1, c1), (x2, c2) = terms[:2]
    if x1.dtype != torch.float32:
        acc = x1 * c1 + x2 * c2
        for x, c in terms[2:]:
            acc = acc + x * c
        return acc
    f32 = lambda c: float(torch.tensor(c, dtype=torch.float32))  # noqa: E731
    acc = fma_f32(x1, f32(c1), x2 * c2)
    for x, c in terms[2:]:
        acc = fma_f32(x, f32(c), acc)
    return acc


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
        norm = _wsum([(rc, 0.33), (rm, 0.33), (rg, 0.34)])
        return _finish((1 - norm) * 10000, f)

    return policy


def worst_fit(dtype=torch.float32) -> PolicyFn:
    """Prefer the emptiest node (reference funsearch_integration.py:271-297,
    shipped commented out of the seed list)."""

    def policy(pod: PodView, nodes: NodeView):
        f = feasible_mask(pod, nodes)
        d = dtype
        rc = _ratio(nodes.cpu_milli_left - pod.cpu_milli,
                    nodes.cpu_milli_total, d)
        rm = _ratio(nodes.memory_mib_left - pod.memory_mib,
                    nodes.memory_mib_total, d)
        rg = _ratio(nodes.gpu_left - pod.num_gpu,
                    nodes.num_gpus.clamp(min=1), d)
        return _finish(_wsum([(rc, 0.33), (rm, 0.33), (rg, 0.34)]) * 10000,
                       f)

    return policy


def micro_best_fit(dtype=torch.float32) -> PolicyFn:
    """The micro-scenario best fit: 1000000 // (sum remaining + 1), exact
    integer floor division (reference tests/test_simulator.py:13-38)."""

    def policy(pod: PodView, nodes: NodeView):
        f = feasible_mask(pod, nodes)
        rem = ((nodes.cpu_milli_left - pod.cpu_milli)
               + (nodes.memory_mib_left - pod.memory_mib)
               + (nodes.gpu_left - pod.num_gpu) + 1)
        score = torch.div(1_000_000, rem.clamp(min=1), rounding_mode="floor")
        return torch.where(f, score, 0).to(torch.int32)

    return policy


def gpu_aware(dtype=torch.float32) -> PolicyFn:
    """GPU/CPU workload separation heuristic (funsearch_integration.py:
    299-353, shipped commented out)."""

    def policy(pod: PodView, nodes: NodeView):
        f = feasible_mask(pod, nodes)
        d = dtype
        ngpus = nodes.num_gpus.clamp(min=1)
        node_has_gpu = nodes.num_gpus > 0
        pod_needs_gpu = pod.num_gpu > 0
        cpu_util = 1 - _ratio(nodes.cpu_milli_left, nodes.cpu_milli_total, d)
        mem_util = 1 - _ratio(nodes.memory_mib_left, nodes.memory_mib_total,
                              d)
        gpu_util = torch.where(node_has_gpu,
                               1 - _ratio(nodes.gpu_left, ngpus, d), 0)
        rem_cpu = _ratio(nodes.cpu_milli_left - pod.cpu_milli,
                         nodes.cpu_milli_total, d)
        rem_mem = _ratio(nodes.memory_mib_left - pod.memory_mib,
                         nodes.memory_mib_total, d)

        # GPU-pod branch
        busy = gpu_util > 0.1
        base_g = torch.where(busy, 9000.0, 1000.0).to(d)
        rem_gpu_norm = _ratio(nodes.gpu_left - pod.num_gpu, ngpus, d)
        sc_g = torch.where(busy, base_g + torch.trunc((1 - rem_gpu_norm)
                                                      * 5000),
                           base_g + 2000.0)
        sc_g = torch.where((cpu_util > 0.1) & (gpu_util < 0.1),
                           (sc_g - 5000).clamp(min=1.0), sc_g)
        sc_g = torch.where(node_has_gpu, sc_g, 0.0)  # return 0 if no GPUs

        # CPU-pod branch
        sc_c_gpu_node = torch.where(busy, 100.0, 1000.0).to(d)
        sc_c_plain = torch.where(
            cpu_util > 0.2,
            6000.0 + torch.trunc((1 - (rem_cpu + rem_mem) / 2) * 4000),
            8000.0)
        sc_c = torch.where(node_has_gpu, sc_c_gpu_node, sc_c_plain)

        score = torch.where(pod_needs_gpu, sc_g, sc_c)
        balance = 1 - (rem_cpu - rem_mem).abs()
        score = score + torch.trunc(balance * 1000)
        # the gpu-pod/no-gpu-node case returned 0 before the balance bonus
        gate = f & (node_has_gpu | ~pod_needs_gpu)
        return _finish(score, gate)

    return policy


def utilization_based(dtype=torch.float32) -> PolicyFn:
    """Size-adaptive hybrid best/worst fit (funsearch_integration.py:
    355-401, shipped commented out)."""

    def policy(pod: PodView, nodes: NodeView):
        f = feasible_mask(pod, nodes)
        d = dtype
        ngpus = nodes.num_gpus.clamp(min=1)
        pod_size = torch.maximum(
            torch.maximum(_ratio(pod.cpu_milli, nodes.cpu_milli_total, d),
                          _ratio(pod.memory_mib, nodes.memory_mib_total, d)),
            _ratio(pod.num_gpu, ngpus, d))
        rem_cpu = _ratio(nodes.cpu_milli_left - pod.cpu_milli,
                         nodes.cpu_milli_total, d)
        rem_mem = _ratio(nodes.memory_mib_left - pod.memory_mib,
                         nodes.memory_mib_total, d)
        rem_gpu = _ratio(nodes.gpu_left - pod.num_gpu, ngpus, d)
        cur_util = 1 - torch.minimum(
            _ratio(nodes.cpu_milli_left, nodes.cpu_milli_total, d),
            _ratio(nodes.memory_mib_left, nodes.memory_mib_total, d))

        rem = rem_cpu + rem_mem + rem_gpu
        large = torch.trunc(rem * 3333) + torch.where(cur_util < 0.01,
                                                      5000.0, 0.0)
        if d == torch.float32:  # XLA: 1 - rem * (1/3), contracted
            mid = fma_f32(-rem, _THIRD, torch.ones_like(rem))
        else:
            mid = 1 - rem / _const(rem, 3.0)
        small_mid = torch.trunc(mid * 10000) + 2000
        small_hot = torch.where(pod_size >= 0.1, 100.0, 8000.0)
        small = torch.where((cur_util > 0.3) & (cur_util < 0.9), small_mid,
                            torch.where(cur_util >= 0.9, small_hot, 100.0)
                            .to(d))
        score = torch.where(pod_size > 0.3, large, small)
        return _finish(score, f)

    return policy


# ------------------------------------------------- FunSearch champion zoo

def funsearch_4901(dtype=torch.float32) -> PolicyFn:
    """Champion, score 0.4901 (reference tests/test_scheduler.py:20-96)."""

    def policy(pod: PodView, nodes: NodeView):
        f = feasible_mask(pod, nodes)
        d = dtype
        gm = nodes.gpu_mask
        pod_gpu = pod.num_gpu > 0

        cpu_util = _ratio(nodes.cpu_milli_total - nodes.cpu_milli_left,
                          nodes.cpu_milli_total, d)
        cpu_score = (1 - cpu_util) * torch.where(cpu_util < 0.7, 100.0, 50.0)
        mem_util = _ratio(nodes.memory_mib_total - nodes.memory_mib_left,
                          nodes.memory_mib_total, d)
        mem_score = (1 - mem_util) * torch.where(mem_util < 0.7, 100.0, 50.0)

        free_milli = torch.where(gm, nodes.gpu_milli_left, 0).sum(
            dim=-1, dtype=torch.int32)
        cap0 = nodes.gpu_milli_total[..., 0]  # node.gpus[0].gpu_milli_total
        den = (nodes.gpu_left * cap0).to(d)
        gpu_util = (den - free_milli.to(d)) / torch.where(den != 0, den, 1)
        gpu_score = torch.where(
            pod_gpu,
            (1 - gpu_util) * torch.where(gpu_util < 0.7, 200.0, 100.0), 0.0)

        score = cpu_score + mem_score + gpu_score
        # fragmentation penalty: (sum free milli) % pod.gpu_milli, int math
        mod = torch.where(pod.gpu_milli > 0,
                          torch.remainder(free_milli,
                                          pod.gpu_milli.clamp(min=1)), 0)
        score = score - torch.where(pod_gpu, mod.to(d) * 0.2, 0.0)

        low_cap = ((nodes.cpu_milli_total < 2000)
                   | (nodes.memory_mib_total < 12))
        score = score - torch.where(
            low_cap,
            (2000 - nodes.cpu_milli_total).to(d) * 0.01
            + (12 - nodes.memory_mib_total).to(d) * 0.1, 0.0)

        balance = (_ratio(nodes.cpu_milli_left,
                          nodes.memory_mib_left.clamp(min=1), d)
                   - _ratio(pod.cpu_milli, pod.memory_mib.clamp(min=1),
                            d)).abs()
        score = score - balance * 0.5

        ample = ((nodes.cpu_milli_left > pod.cpu_milli * 2)
                 & (nodes.memory_mib_left > pod.memory_mib * 2))
        score = score + torch.where(ample, 25.0, 0.0)

        gmax = torch.where(gm, nodes.gpu_milli_left, -(2**30)).amax(dim=-1)
        gmin = torch.where(gm, nodes.gpu_milli_left, 2**30).amin(dim=-1)
        imb = (gmax - gmin).to(d)
        score = score - torch.where(pod_gpu, imb * 0.05, 0.0)

        high_cap = ((nodes.cpu_milli_total > 10000)
                    & (nodes.memory_mib_total > 64))
        score = score + torch.where(high_cap, 15.0, 0.0)
        nearly_full = (cpu_util > 0.9) | (mem_util > 0.9)
        score = score - torch.where(nearly_full, 20.0, 0.0)
        return _finish(score, f)

    return policy


def funsearch_4816(dtype=torch.float32) -> PolicyFn:
    """Champion, score 0.4816 (reference tests/test_scheduler.py:99-131)."""

    def policy(pod: PodView, nodes: NodeView):
        f = feasible_mask(pod, nodes)
        d = dtype
        i32 = torch.int32
        cpu_util = _ratio(
            nodes.cpu_milli_total - nodes.cpu_milli_left + pod.cpu_milli,
            nodes.cpu_milli_total.clamp(min=1), d)
        mem_util = _ratio(
            nodes.memory_mib_total - nodes.memory_mib_left + pod.memory_mib,
            nodes.memory_mib_total.clamp(min=1), d)
        balance = 1 - (cpu_util - mem_util).abs()
        efficiency = torch.sqrt(cpu_util * mem_util)

        # eligible = first num_gpu GPUs (slot order) with milli_left >= req
        gml, gmt = nodes.gpu_milli_left, nodes.gpu_milli_total
        req = pod.gpu_milli[..., None]
        elig = nodes.gpu_mask & (gml >= req)
        rank = torch.cumsum(elig.to(i32), dim=-1) - 1
        seli = (elig & (rank < pod.num_gpu[..., None])).to(i32)
        sum_total = (gmt * seli).sum(dim=-1, dtype=i32)
        sum_left = (gml * seli).sum(dim=-1, dtype=i32)
        nsel = seli.sum(dim=-1, dtype=i32)
        gpu_util = _ratio(sum_total - sum_left + nsel * pod.gpu_milli,
                          sum_total.clamp(min=1), d)
        sq = (gml - req) ** 2
        gpu_frag = _ratio((sq * seli).sum(dim=-1, dtype=i32),
                          sum_left.clamp(min=1), d)
        isolation = 0.5 - (0.5 - torch.sqrt(gpu_frag)).abs()
        score_gpu = _wsum([
            (cpu_util, 0.25), (mem_util, 0.15), (gpu_util, 0.45),
            (balance, 0.05), (efficiency, 0.05), (gpu_frag, -0.05),
            (isolation, 0.1)]) * 10000

        frag_cpu = _ratio(torch.remainder(nodes.cpu_milli_left,
                                          pod.cpu_milli.clamp(min=1)),
                          nodes.cpu_milli_total, d)
        frag_mem = _ratio(torch.remainder(nodes.memory_mib_left,
                                          pod.memory_mib.clamp(min=1)),
                          nodes.memory_mib_total, d)
        frag = torch.minimum(frag_cpu, frag_mem)
        score_cpu = _wsum([
            (cpu_util, 0.45), (mem_util, 0.35), (balance, 0.1),
            (efficiency, 0.1), (frag, -0.1)]) * 10000

        score = torch.where(pod.num_gpu > 0, score_gpu, score_cpu)
        return _finish(score, f)

    return policy


def funsearch_4800(dtype=torch.float32) -> PolicyFn:
    """Champion, score 0.4800 (reference tests/test_scheduler.py:134-167)."""

    def policy(pod: PodView, nodes: NodeView):
        f = feasible_mask(pod, nodes)
        d = dtype
        gml = nodes.gpu_milli_left
        g = gml.shape[-1]
        cpu_util = _ratio(
            nodes.cpu_milli_total - nodes.cpu_milli_left + pod.cpu_milli,
            nodes.cpu_milli_total, d)
        mem_util = _ratio(
            nodes.memory_mib_total - nodes.memory_mib_left + pod.memory_mib,
            nodes.memory_mib_total, d)
        balance = (1 - (cpu_util - mem_util).abs()) ** 2.5 * 300

        # viable GPUs sorted by milli_left ascending (stable), take num_gpu
        req = pod.gpu_milli[..., None]
        elig = nodes.gpu_mask & (gml >= req)
        iota = torch.arange(g, dtype=gml.dtype, device=gml.device)
        key = torch.where(elig, gml * g + iota, 2**30)
        order = torch.argsort(key, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)  # inverse perm
        sel = elig & (rank < pod.num_gpu[..., None])
        eff_terms = 1 - _ratio(gml - req, nodes.gpu_milli_total.clamp(min=1),
                               d)
        gpu_eff = (torch.where(sel, eff_terms, 0).sum(dim=-1)
                   / pod.num_gpu.clamp(min=1).to(d))
        n_viable = elig.sum(dim=-1)
        gpu_score = torch.where((pod.num_gpu > 0) & (n_viable >= pod.num_gpu),
                                gpu_eff ** 2 * 450, 0.0)

        head = torch.minimum(nodes.cpu_milli_left - pod.cpu_milli,
                             nodes.memory_mib_left - pod.memory_mib).to(d)
        frag_score = (head.clamp(min=0) ** 0.6
                      / torch.maximum(nodes.cpu_milli_total,
                                      nodes.memory_mib_total).to(d) * 300)
        util_score = (torch.minimum(cpu_util, mem_util) * 0.6
                      + torch.maximum(cpu_util, mem_util) * 0.4) * 600
        return _finish(util_score + balance + gpu_score + frag_score, f)

    return policy


ZOO = {
    "first_fit": first_fit,
    "best_fit": best_fit,
    "funsearch_4901": funsearch_4901,
    "funsearch_4816": funsearch_4816,
    "funsearch_4800": funsearch_4800,
}

BASELINE_FACTORIES = {
    "first_fit": first_fit,
    "best_fit": best_fit,
    "worst_fit": worst_fit,
    "gpu_aware": gpu_aware,
    "utilization_based": utilization_based,
}
