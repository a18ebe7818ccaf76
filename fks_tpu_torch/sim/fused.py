"""Fused parametric-population simulation: one CUDA kernel launch.

Port of fks_tpu.sim.fused. fks_tpu's Pallas kernel (fused.py:179-442,
``pl.pallas_call`` at fused.py:471) runs the flat engine's whole event loop
for a chunk of parametric candidates with the queue resident in TPU VMEM;
here ``csrc/fused_sim.cu`` does the same on Hopper with one warp per
candidate and the queue resident in shared memory.

Three parts:

- ``_build_plan``: host-side constants (slot-ordered pod rows, snapshot
  table, node rows) and the same rejections as fks_tpu (fused.py:94-128);
- ``fused_sim``: the kernel's wrapper. On a CUDA tensor it launches the
  kernel (counting launches in ``fused_sim.launches``) or raises; on a CPU
  tensor it runs ``fused_sim_plain``, the plain PyTorch version — the
  port's flat engine with ``parametric.score``, reshaped into the kernel's
  raw outputs;
- ``make_fused_population_run``: ``run(params[P, 16]) -> SimResult``.

The kernel follows the flat engine where the two JAX engines disagree:
utilization "used" is an integer subtraction before the float convert
(flat.py:448-453), and ``max_nodes`` counts ``gpu_left < num_gpus``
(flat.py:460-462). TPU workarounds that do not carry over: the one-hot
MXU gather of the pod row and its ``< 2**24`` check (the kernel indexes
the row directly) and lane chunking (grid = P one-warp blocks).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.models import parametric
from fks_tpu_torch.models.parametric import NUM_FEATURES
from fks_tpu_torch.sim import flat
from fks_tpu_torch.sim.engine import (
    FinalView, SimConfig, finalize_fields, loop_tables,
)
from fks_tpu_torch.sim.types import SimResult

#: dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232_448
#: waiting-histogram buckets the kernel's register bitmap covers
MAX_HIST = 4096


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def smem_bytes(q: int, n: int, g: int, hist: int) -> int:
    """Shared memory one lane of the kernel holds, all int32
    (csrc/fused_sim.cu ``Layout``): ev and aux [Q]; the chunk minima cmin
    and dmin, 32 x run each, where each of the warp's 32 threads owns
    ``run`` = ceil(Q / 32 / 32) chunks of 32 slots; eight words per node;
    three [N, gs] GPU grids, gs = G rounded up to 8, plus 1; hist [H]."""
    run = -(-(q // 32) // 32)
    gs = _round_up(g, 8) + 1
    return 4 * (2 * q + 2 * 32 * run + 8 * n + 3 * n * gs + hist)


@dataclasses.dataclass
class _Plan:
    """Static geometry + host-prepared constants, on the run's device."""

    q: int            # slot count (p_padded rounded up to 128)
    n: int
    g: int
    hist: int
    klen: int
    max_steps: int
    pending0: int
    ev0: torch.Tensor     # i32[Q] initial slot times (tie-rank order)
    feat: torch.Tensor    # i32[Q, 8] pod rows: cpu, mem, ngpu, milli, dur, 0..
    ktable: torch.Tensor  # i32[K]
    nrow: torch.Tensor    # i32[6, N]: cpu_tot, mem_tot, gpu_declared,
                          #            num_gpus, node_mask, milli_tot
    gmt: torch.Tensor     # i32[N, G] per-GPU milli totals
    gmask: torch.Tensor   # i32[N, G]
    totals: tuple         # (cpu, mem, gpu count, gpu milli) python ints
    workload: Workload    # on the same device (the plain version's input)
    cfg: SimConfig


def _build_plan(workload: Workload, cfg: SimConfig,
                device=None) -> _Plan:
    c, p = workload.cluster, workload.pods
    n, g, pp = c.n_padded, c.g_padded, p.p_padded
    if not flat._packable(n, g):
        raise ValueError("fused kernel needs packed aux (node_bits+G<=31); "
                         "use engine='flat'")
    if cfg.gpu_allocator != "best_fit":
        raise ValueError("fused kernel implements best_fit only")
    if cfg.validate_invariants:
        raise ValueError("invariant audit is not supported in the fused "
                         "kernel; use engine='flat'")
    if cfg.decision_trace:
        raise ValueError("decision trace is not supported in the fused "
                         "kernel")
    if cfg.probe_score:
        raise ValueError("budget probe rungs (SimConfig.probe_score) are "
                         "not supported in the fused kernel")
    if workload.faults is not None:
        raise ValueError("fault-injected workloads are not supported in the "
                         "fused kernel")
    if cfg.node_prefilter_k:
        raise ValueError("top-k node prefiltering (SimConfig."
                         "node_prefilter_k) is not supported in the fused "
                         "kernel")
    if cfg.state_pack:
        raise ValueError("packed state dtypes (SimConfig.state_pack) are "
                         "not supported in the fused kernel")
    if cfg.watchdog:
        raise ValueError("the numerics watchdog (SimConfig.watchdog) is not "
                         "ported yet; it waits for a later slice of the "
                         "port (sim/guards.py)")
    dev = workload.device if device is None else torch.device(device)
    q = _round_up(pp, 128)
    hist = flat.hist_size(workload, cfg)
    if hist > MAX_HIST:
        raise ValueError(f"fused kernel keeps at most {MAX_HIST} waiting-"
                         f"histogram buckets, not {hist}; use engine='flat'")

    cpu = lambda x: x.detach().cpu().numpy()  # noqa: E731
    pm = cpu(p.pod_mask)
    perm = cpu(flat.rank_perm(p.pod_mask.cpu(), p.tie_rank.cpu()))
    ev0 = np.full(q, flat.INF, np.int32)
    ev0[:pp] = np.where(pm[perm], cpu(p.creation_time)[perm], flat.INF)
    feat = np.zeros((q, 8), np.int32)
    for k, arr in enumerate((p.cpu, p.mem, p.num_gpu, p.gpu_milli,
                             p.duration)):
        feat[:pp, k] = cpu(arr)[perm]

    ktable, max_steps = loop_tables(workload, cfg)
    gmt = cpu(c.gpu_milli_total).astype(np.int32)
    gmask = cpu(c.gpu_mask).astype(np.int32)
    milli_tot = (gmt * gmask).sum(axis=1).astype(np.int32)
    nrow = np.stack([cpu(c.cpu_total), cpu(c.mem_total),
                     cpu(c.gpu_declared), cpu(c.num_gpus),
                     cpu(c.node_mask).astype(np.int32), milli_tot]
                    ).astype(np.int32)
    totals = (int(nrow[0].sum()), int(nrow[1].sum()), int(nrow[3].sum()),
              int(gmt.sum()))
    if totals[3] >= 2**31 or int(gmt.max(initial=0)) >= 2**26:
        raise ValueError("fused kernel needs total GPU milli < 2**31 and "
                         "per-GPU milli < 2**26; use engine='flat'")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return _Plan(
        q=q, n=n, g=g, hist=hist, klen=int(ktable.shape[0]),
        max_steps=int(max_steps), pending0=int(pm.sum()),
        ev0=t(ev0), feat=t(feat), ktable=t(np.asarray(ktable, np.int32)),
        nrow=t(nrow), gmt=t(gmt), gmask=t(gmask), totals=totals,
        workload=workload.to(dev), cfg=cfg)


def fused_sim_plain(plan: _Plan, params: torch.Tensor):
    """The kernel's plain PyTorch version on ``params``' device: the flat
    engine with ``parametric.score`` in float32, reshaped into the kernel's
    raw outputs ``(aux[P, Q], cpu, mem, gpu [P, N], gmil [P, N, G],
    acci i32[P, 8], accf f32[P, 8])``."""
    wl = plan.workload
    cfg = dataclasses.replace(plan.cfg, track_ctime=False,
                              score_dtype=torch.float32)
    ktable, max_steps = loop_tables(wl, cfg)
    step = flat.build_step(
        wl, lambda pod, nodes: parametric.score(params, pod, nodes), cfg,
        ktable, max_steps)
    pop = params.shape[0]
    s = flat.run_lanes(step, flat.initial_state(wl, cfg, lanes=pop),
                       max_steps)
    aux = torch.full((pop, plan.q), flat.AUX_FRESH, dtype=torch.int32,
                     device=params.device)
    aux[:, :s.aux.shape[1]] = s.aux
    zeros = torch.zeros_like(s.pending)
    acci = torch.stack([s.pending, s.steps, s.events_processed, s.snap_idx,
                        s.frag_count, s.max_nodes, s.failed.to(torch.int32),
                        zeros], dim=1)
    accf = torch.cat([s.snap_sums, s.frag_sum[:, None],
                      torch.zeros((pop, 3), dtype=torch.float32,
                                  device=params.device)], dim=1)
    return (aux, s.cpu_left, s.mem_left, s.gpu_left, s.gpu_milli_left,
            acci, accf)


def _launch(plan: _Plan, params: torch.Tensor):
    from fks_tpu_torch.ops import _ext

    if params.dtype != torch.float32 or params.dim() != 2 \
            or params.shape[1] != NUM_FEATURES:
        raise ValueError(f"params must be float32 [P, {NUM_FEATURES}], got "
                         f"{params.dtype} {tuple(params.shape)}")
    if not params.is_contiguous():
        raise ValueError("params must be contiguous")
    dev = params.device
    consts = (plan.ev0, plan.feat, plan.ktable, plan.nrow, plan.gmt,
              plan.gmask)
    for x in consts:
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("the plan's tables must be contiguous int32 on "
                             f"{dev}; build the run with device={dev}")
    pop, q, n, g = params.shape[0], plan.q, plan.n, plan.g
    i32 = dict(dtype=torch.int32, device=dev)
    outs = (torch.empty((pop, q), **i32), torch.empty((pop, n), **i32),
            torch.empty((pop, n), **i32), torch.empty((pop, n), **i32),
            torch.empty((pop, n, g), **i32), torch.empty((pop, 8), **i32),
            torch.empty((pop, 8), dtype=torch.float32, device=dev))
    lib = _ext.fused_sim_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fks_fused_sim(
            params.data_ptr(), *(x.data_ptr() for x in consts),
            *(o.data_ptr() for o in outs), pop, q, n, g, plan.hist,
            plan.klen, plan.max_steps, plan.pending0, *plan.totals, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_sim kernel launch failed: CUDA error {err} "
            f"({lib.fks_cuda_error_string(err).decode()})")
    fused_sim.launches += 1
    return outs


def fused_sim(plan: _Plan, params: torch.Tensor):
    """The fused simulation on ``params``' device: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor. Returns the raw
    outputs ``(aux, cpu, mem, gpu, gmil, acci, accf)``."""
    if params.is_cuda:
        return _launch(plan, params)
    if params.device.type != "cpu":
        raise ValueError(f"fused_sim runs on cuda or cpu, not {params.device}")
    return fused_sim_plain(plan, params)


fused_sim.launches = 0  # kernel launches (CUDA only), reset by callers


def make_fused_population_run(workload: Workload,
                              cfg: SimConfig = SimConfig(), device=None):
    """``run(params[P, 16]) -> SimResult`` (leading axis P) through the
    fused kernel on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    version). Rejects shapes whose per-lane state does not fit one block's
    shared memory."""
    dev = resolve_device(device)
    plan = _build_plan(workload, cfg, dev)
    per_lane = smem_bytes(plan.q, plan.n, plan.g, plan.hist)
    if per_lane > MAX_SMEM_BYTES:
        raise ValueError(
            f"workload too large for the fused kernel's shared-memory plan "
            f"({per_lane >> 10} KB/lane for q={plan.q}, n={plan.n}, "
            f"hist={plan.hist}; a block holds {MAX_SMEM_BYTES >> 10} KB); "
            "use engine='flat'")
    wl = plan.workload
    p = wl.pods
    pp = p.p_padded
    inv = torch.argsort(flat.rank_perm(p.pod_mask, p.tie_rank))
    ctime0 = p.creation_time

    def run(params) -> SimResult:
        params = torch.as_tensor(params).to(dev, torch.float32).contiguous()
        pop = params.shape[0]
        aux, cpu, mem, gpu, gmil, acci, accf = fused_sim(plan, params)
        an, ag = flat.decode_assignment(aux[:, :pp], None, plan.g, True)
        view = FinalView(
            assigned_node=an[:, inv], assigned_gpus=ag[:, inv],
            pod_ctime=ctime0.expand(pop, pp), cpu_left=cpu, mem_left=mem,
            gpu_left=gpu, gpu_milli_left=gmil,
            events_processed=acci[:, 2], snap_idx=acci[:, 3],
            snap_sums=accf[:, 0:4], frag_sum=accf[:, 4],
            frag_count=acci[:, 4], max_nodes=acci[:, 5],
            failed=acci[:, 6] > 0)
        return finalize_fields(wl, cfg, pending=acci[:, 0] > 0, s=view)

    run.plan = plan
    return run
