"""Deterministic workload perturbations and fault-event injection.

Port of fks_tpu.scenarios.generator. Every transform is seed-derived host
numpy with fks_tpu's salts and ``SeedSequence`` streams, so the same
``(base workload, ScenarioSpec)`` pair materializes the same arrays as
fks_tpu's, byte for byte; the results come back as tensors on the base
workload's device.

Perturbation families, each drawing from its own seeded stream:

- **arrival jitter**: creation times shift by up to ``±frac * span``,
  clipped at 0; pod ids, tie ranks and durations are untouched;
- **demand scaling**: cpu/mem scale multiplicatively, clipped to ``[1,
  max real node capacity]``; gpu_milli scales within ``[1, 1000]``, so the
  shared waiting-histogram width (1001) holds across a suite;
- **pod-mix shift**: swap the resource columns between random pod pairs,
  keeping ids and arrival times;
- **fault injection**: NODE_DOWN / NODE_UP pairs (``FaultEvents``); a
  downed node is cordoned until its NODE_UP, running pods are not
  evicted.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fks_tpu_torch.data.entities import FaultEvents, Workload
from fks_tpu_torch.ops.heap import KIND_NODE_DOWN, KIND_NODE_UP

INF_I32 = np.iinfo(np.int32).max

# per-family salt: each perturbation family owns an independent stream
_SALT_JITTER = 0x5ce7a710
_SALT_MIX = 0x5ce7a711
_SALT_FAULT = 0x5ce7a712


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One scenario: a named, seeded bundle of perturbation parameters.
    All defaults (except the name) is the identity: the base workload."""

    name: str
    seed: int = 0
    arrival_jitter_frac: float = 0.0  # ± fraction of the arrival span
    demand_scale: float = 1.0         # cpu/mem multiplier
    gpu_milli_scale: float = 1.0      # gpu_milli multiplier (clip to 1000)
    pod_mix_swap_frac: float = 0.0    # fraction of pods in resource swaps
    fault_nodes: int = 0              # nodes receiving a DOWN/UP window
    fault_start_frac: float = 0.45    # window start, fraction of the span
    fault_duration_frac: float = 0.15  # window length, fraction of the span

    def describe(self) -> dict:
        """JSON-ready parameter dump."""
        return dataclasses.asdict(self)


def _rng(salt: int, seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([salt, seed]))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def make_fault_events(events: Sequence[Tuple[int, int, int]],
                      pad_to: Optional[int] = None,
                      device="cpu") -> Optional[FaultEvents]:
    """``FaultEvents`` from ``(time, node, kind)`` triples, padded to
    ``pad_to`` rows (all-masked padding: time INT32_MAX, kind NODE_UP).
    Events are stably time-sorted: array order is the exact engine's
    equal-time fault rank and the flat engine's first-index tie order.
    Returns None when there is nothing to pad (no events, no pad_to): a
    fault-free workload carries ``faults=None``."""
    events = sorted(events, key=lambda e: int(e[0]))
    pad = max(len(events), int(pad_to or 0))
    if pad == 0:
        return None
    time = np.full(pad, INF_I32, np.int32)
    node = np.zeros(pad, np.int32)
    kind = np.full(pad, KIND_NODE_UP, np.int32)
    mask = np.zeros(pad, bool)
    for i, (t, nd, k) in enumerate(events):
        if k not in (KIND_NODE_DOWN, KIND_NODE_UP):
            raise ValueError(f"fault kind {k} is not NODE_DOWN/NODE_UP")
        time[i], node[i], kind[i], mask[i] = int(t), int(nd), int(k), True
    return FaultEvents(time=torch.from_numpy(time), node=torch.from_numpy(node),
                       kind=torch.from_numpy(kind),
                       mask=torch.from_numpy(mask)).to(device)


def fault_events_for(base: Workload,
                     spec: ScenarioSpec) -> List[Tuple[int, int, int]]:
    """The (time, node, kind) fault triples a spec injects into ``base``:
    ``fault_nodes`` distinct nodes each get one DOWN -> UP window inside
    the arrival span, staggered so windows overlap but never coincide."""
    if spec.fault_nodes <= 0:
        return []
    p = base.pods
    pm = _np(p.pod_mask)
    if not pm.any():
        return []
    ct = _np(p.creation_time)[pm]
    t0, t1 = int(ct.min()), int(ct.max())
    span = max(1, t1 - t0)
    nn = base.num_nodes
    k = min(int(spec.fault_nodes), nn)
    rng = _rng(_SALT_FAULT, spec.seed)
    nodes = np.sort(rng.choice(nn, size=k, replace=False))
    events: List[Tuple[int, int, int]] = []
    dur = max(1, int(round(spec.fault_duration_frac * span)))
    for i, nd in enumerate(nodes.tolist()):
        start = t0 + int(round((spec.fault_start_frac + 0.03 * i) * span))
        events.append((start, int(nd), KIND_NODE_DOWN))
        events.append((start + dur, int(nd), KIND_NODE_UP))
    return events


def perturb_workload(base: Workload, spec: ScenarioSpec,
                     fault_pad: Optional[int] = None) -> Workload:
    """One scenario: ``base`` with ``spec``'s perturbations applied and its
    fault timeline attached (padded to ``fault_pad`` rows, so every
    scenario of a suite shares one FaultEvents shape, as
    ``parallel.traces.stack_traces`` requires). Padded shapes, pod ids,
    tie ranks and masks are untouched."""
    if base.faults is not None:
        raise ValueError("base workload already carries fault events; "
                         "perturb the fault-free original")
    p = base.pods
    c = base.cluster
    real = _np(p.pod_mask)
    ct = _np(p.creation_time).astype(np.int64).copy()
    cpu = _np(p.cpu).astype(np.int64).copy()
    mem = _np(p.mem).astype(np.int64).copy()
    num_gpu = _np(p.num_gpu).copy()
    milli = _np(p.gpu_milli).astype(np.int64).copy()

    span = int(ct[real].max() - ct[real].min()) if real.any() else 0
    if spec.arrival_jitter_frac > 0 and span > 0:
        j = max(1, int(round(spec.arrival_jitter_frac * span)))
        jit = _rng(_SALT_JITTER, spec.seed).integers(-j, j + 1, ct.shape[0])
        ct = np.where(real, np.maximum(ct + jit, 0), ct)

    if spec.demand_scale != 1.0:
        nm = _np(c.node_mask)
        cap_cpu = int(_np(c.cpu_total)[nm].max(initial=1))
        cap_mem = int(_np(c.mem_total)[nm].max(initial=1))
        scale = float(spec.demand_scale)
        cpu = np.where(real & (cpu > 0),
                       np.clip(np.round(cpu * scale), 1, cap_cpu), cpu)
        mem = np.where(real & (mem > 0),
                       np.clip(np.round(mem * scale), 1, cap_mem), mem)

    if spec.gpu_milli_scale != 1.0:
        milli = np.where(
            real & (num_gpu > 0),
            np.clip(np.round(milli * float(spec.gpu_milli_scale)), 1, 1000),
            milli)

    if spec.pod_mix_swap_frac > 0:
        idx = np.nonzero(real)[0]
        k = int(len(idx) * min(spec.pod_mix_swap_frac, 1.0)) // 2
        if k > 0:
            order = _rng(_SALT_MIX, spec.seed).permutation(idx)
            a, b = order[:k], order[k:2 * k]
            for arr in (cpu, mem, num_gpu, milli):
                arr[a], arr[b] = arr[b].copy(), arr[a].copy()

    dev = base.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    pods = dataclasses.replace(
        p, cpu=t(cpu), mem=t(mem), num_gpu=t(num_gpu), gpu_milli=t(milli),
        creation_time=t(ct))
    wl = Workload(cluster=c, pods=pods)
    faults = make_fault_events(fault_events_for(wl, spec), pad_to=fault_pad,
                               device=dev)
    return dataclasses.replace(wl, faults=faults)
