"""The flat engine's kernel step: ``csrc/flat_step.cu``'s two kernels
around the policy call.

A step of ``build_kernel_step`` is three launches on CUDA: ``flat_pop``
(each lane's (time, slot) minimum, the earliest pending DELETE, the pod
row, the DELETE refund in place, and the lane's scratch row), the
policy on the pod columns of that scratch row (``pod_view``) and the
node state in place, and ``flat_commit`` (the masked argmax, the GPU
pick, the placement, the waiting histogram, the fragmentation score,
the retry rule, the slot rewrite, the snapshot and the counters). The
step updates the state in place and returns it, so ``engine.run_chunk``
copies nothing. ``sim.flat.build_step`` builds it where
``sim.flat.kernel_step_blocker`` finds nothing against it; elsewhere it
builds the PyTorch step, ``sim.flat.build_torch_step``, which the
kernels are held to.

Each wrapper launches its kernel for a CUDA state (counted in its
``launches``) and raises rather than fall back; for a CPU state it runs
its plain version (``pop_plain``, ``commit_plain``), which computes the
same in PyTorch, so the CPU tests hold the split against the PyTorch
step. Like the kernels, the plain versions skip nothing a lane needs
and change nothing in a lane that is not active.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from fks_tpu_torch.ops.allocator import best_fit_gpus, first_fit_gpus
from fks_tpu_torch.sim.engine import (
    SimConfig, _cluster_totals, _node_view, hist_size,
)
from fks_tpu_torch.sim.flat import AUX_WAITING, INF, pod_table
from fks_tpu_torch.sim.types import FlatState, PodView
from fks_tpu_torch.data.entities import Workload

#: a lane's scratch row (csrc/flat_step.cu ``Col``): the popped time and
#: slot, the slot's aux, the pod's row, whether the lane is active, and
#: the earliest pending DELETE's time (INF when none)
SCRATCH = ("t", "col", "aux", "cpu", "mem", "num_gpu", "gpu_milli",
           "duration", "act", "next_del")
#: the kernels' threads at most (csrc/flat_step.cu kMaxThreads,
#: kCommitThreads), and the nodes a commit thread loads at once (kPer)
POP_THREADS = 1024
COMMIT_THREADS = 512
COMMIT_PER_THREAD = 4


@dataclasses.dataclass(frozen=True)
class StepTables:
    """What the kernels read besides the state, built with the step on the
    workload's device: the pod rows in slot order, the cluster's tables,
    its totals and their float denominators (``clamp(min=1)`` in the score
    dtype, as the PyTorch step divides), the snapshot triggers."""

    feat: torch.Tensor  # i32[Q, 5]
    node_mask: torch.Tensor  # bool[N]
    cpu_total: torch.Tensor  # i32[N]
    mem_total: torch.Tensor  # i32[N]
    num_gpus: torch.Tensor  # i32[N]
    gpu_mask: torch.Tensor  # bool[N, G]
    totals: torch.Tensor  # i64[4]
    denom: torch.Tensor  # f[4]
    ktable: torch.Tensor  # i32[K]
    h: int  # waiting-histogram width
    max_steps: int
    first_fit: bool
    track_ctime: bool

    @property
    def n(self) -> int:
        return int(self.node_mask.shape[0])

    @property
    def g(self) -> int:
        return int(self.gpu_mask.shape[1])


def step_tables(workload: Workload, cfg: SimConfig, ktable,
                max_steps: int) -> StepTables:
    c = workload.cluster
    dev = workload.device
    totals = _cluster_totals(c)
    return StepTables(
        feat=pod_table(workload.pods).contiguous(),
        node_mask=c.node_mask.contiguous(),
        cpu_total=c.cpu_total.contiguous(),
        mem_total=c.mem_total.contiguous(),
        num_gpus=c.num_gpus.contiguous(),
        gpu_mask=c.gpu_mask.contiguous(), totals=totals,
        denom=totals.clamp(min=1).to(cfg.score_dtype),
        ktable=torch.as_tensor(ktable, dtype=torch.int32,
                               device=dev).contiguous(),
        h=hist_size(workload, cfg), max_steps=int(max_steps),
        first_fit=cfg.gpu_allocator == "first_fit",
        track_ctime=cfg.track_ctime)


def pod_view(scratch: torch.Tensor) -> PodView:
    """The popped pods as the policy reads them: ``[L, 1]`` columns of the
    scratch rows, creation time the popped time."""
    col = {name: scratch[:, i:i + 1] for i, name in enumerate(SCRATCH)}
    return PodView(col["cpu"], col["mem"], col["num_gpu"], col["gpu_milli"],
                   col["t"], col["duration"])


def build_kernel_step(workload: Workload, policy, cfg: SimConfig, ktable,
                      max_steps: int):
    """``flat_pop``, ``policy(PodView, NodeView) -> i32[L, N]`` and
    ``flat_commit``: one event in every lane, the state updated in place.
    Takes what ``sim.flat.kernel_step_blocker`` admits. The scratch rows
    are allocated at the first step of each lane count (a captured graph's
    eager warm-up) and reused by every later one."""
    c = workload.cluster
    tab = step_tables(workload, cfg, ktable, max_steps)
    scratch = {}

    def step(s: FlatState) -> FlatState:
        rows = scratch.get(s.lanes)
        if rows is None:
            rows = scratch[s.lanes] = torch.zeros(
                (s.lanes, len(SCRATCH)), dtype=torch.int32,
                device=s.ev_time.device)
        flat_pop(s, rows, tab)
        nodes = _node_view(c, s.cpu_left, s.mem_left, s.gpu_left,
                           s.gpu_milli_left)
        flat_commit(s, rows, policy(pod_view(rows), nodes), tab)
        return s

    step.kernel_step = True
    return step


# ------------------------------------------------------ the plain versions

def pop_plain(s: FlatState, scratch: torch.Tensor, tab: StepTables) -> None:
    """``flat_pop`` in PyTorch: writes the lanes' scratch rows and applies
    the DELETE refund in place."""
    i32 = torch.int32
    dev = s.ev_time.device
    act = (s.pending > 0) & ~s.failed & (s.steps < tab.max_steps)
    t, col = torch.min(s.ev_time, dim=1, keepdim=True)  # first slot on ties
    next_del = torch.where(s.aux >= 0, s.ev_time, INF).amin(
        dim=1, keepdim=True)
    aux_s = s.aux.gather(1, col)
    row = tab.feat[col[:, 0]]  # [L, 5]
    n_iota = torch.arange(tab.n, dtype=i32, device=dev)
    g_iota = torch.arange(tab.g, dtype=i32, device=dev)
    oh = ((n_iota == aux_s >> tab.g) & act[:, None]
          & (aux_s >= 0)).to(i32)  # [L, N]
    s.cpu_left.add_(oh * row[:, 0:1])
    s.mem_left.add_(oh * row[:, 1:2])
    s.gpu_left.add_(oh * row[:, 2:3])
    bits = (aux_s >> g_iota) & 1  # [L, G]
    s.gpu_milli_left.add_(oh[:, :, None] * bits[:, None, :]
                          * row[:, 3:4, None])
    scratch.copy_(torch.cat([t, col.to(i32), aux_s, row,
                             act[:, None].to(i32), next_del], dim=1))


def commit_plain(s: FlatState, scratch: torch.Tensor, raw: torch.Tensor,
                 tab: StepTables) -> None:
    """``flat_commit`` in PyTorch, in place."""
    i32, i64 = torch.int32, torch.int64
    dev = s.ev_time.device
    lanes, n, g = s.lanes, tab.n, tab.g
    f = s.frag_sum.dtype
    zero_f = torch.zeros((), dtype=f, device=dev)
    t, col, aux_s, pcpu, pmem, pngpu, pmilli, pdur, act, next_del = \
        scratch.split(1, dim=1)
    col = col.long()
    act = act.bool()
    create = act & (aux_s < 0)
    was_waiting = aux_s == AUX_WAITING
    gpu_pod = pngpu > 0

    scores = torch.where(tab.node_mask, raw, 0)
    w = scores.argmax(dim=1, keepdim=True)  # the first maximal node
    placed = create & (scores.gather(1, w) > 0)
    alloc = first_fit_gpus if tab.first_fit else best_fit_gpus
    gml = s.gpu_milli_left
    sel, ok = alloc(gml[torch.arange(lanes, device=dev), w[:, 0]],
                    tab.gpu_mask[w[:, 0]], pmilli[:, 0], pngpu[:, 0])
    alloc_fail = placed & gpu_pod & ~ok[:, None]
    pl = placed & ~alloc_fail
    oh = ((torch.arange(n, device=dev) == w) & pl).to(i32)  # [L, N]
    s.cpu_left.sub_(oh * pcpu)
    s.mem_left.sub_(oh * pmem)
    s.gpu_left.sub_(oh * pngpu)
    gml.sub_(oh[:, :, None] * sel.to(i32)[:, None, :] * pmilli[:, :, None])
    bits = (sel.to(i64) << torch.arange(g, device=dev)).sum(
        dim=1, keepdim=True)
    enc = (w.to(i32) << g) | bits.to(i32)

    failp = create & ~placed
    hdelta = ((failp & ~was_waiting & gpu_pod).to(i32)
              - (pl & was_waiting & gpu_pod).to(i32))
    s.wait_hist.scatter_add_(1, pmilli.clamp(0, tab.h - 1).long(), hdelta)
    waiting = s.wait_hist > 0
    min_needed = waiting.to(i32).argmax(dim=1)  # the first waiting bucket
    frag_free = (gml * (tab.gpu_mask & (gml > 0)
                        & (gml < min_needed[:, None, None]))).sum(
        dim=(1, 2))
    frag = torch.where(waiting.any(dim=1) & (tab.totals[3] > 0),
                       frag_free.to(f) / tab.denom[3], zero_f)
    s.frag_sum.copy_(s.frag_sum + torch.where(failp[:, 0], frag, zero_f))

    found = next_del < INF
    retry = failp & found
    rt = next_del + 1
    new_t = torch.where(pl, t + pdur, torch.where(retry, rt, INF))
    new_aux = torch.where(pl, enc, torch.where(failp, AUX_WAITING, aux_s))
    s.ev_time.scatter_(1, col, torch.where(act, new_t, t))
    s.aux.scatter_(1, col, torch.where(act, new_aux, aux_s))
    if tab.track_ctime:
        s.pod_ctime.scatter_(1, col, torch.where(
            retry, rt, s.pod_ctime.gather(1, col)))
    s.pending.sub_((act & ~create | failp & ~found)[:, 0].to(i32))

    valid = (act & ~alloc_fail)[:, 0]
    s.events_processed.add_(valid.to(i32))
    klen = int(tab.ktable.shape[0])
    fire = valid & (s.snap_idx < klen) & (s.events_processed >= tab.ktable[
        s.snap_idx.clamp(max=klen - 1).long()])
    used = torch.stack([
        tab.totals[0] - s.cpu_left.sum(dim=1, dtype=i64),
        tab.totals[1] - s.mem_left.sum(dim=1, dtype=i64),
        (tab.num_gpus - s.gpu_left).sum(dim=1, dtype=i64),
        tab.totals[3] - gml.sum(dim=(1, 2), dtype=i64)], dim=1).to(f)
    utils = torch.where(tab.totals <= 0, zero_f, used / tab.denom)
    s.snap_sums.copy_(s.snap_sums + torch.where(fire[:, None], utils, zero_f))
    s.snap_idx.add_(fire.to(i32))
    active_nodes = (tab.node_mask & (
        (s.cpu_left < tab.cpu_total) | (s.mem_left < tab.mem_total)
        | (s.gpu_left < tab.num_gpus))).sum(dim=1, dtype=i32)
    torch.maximum(s.max_nodes, active_nodes * valid, out=s.max_nodes)
    s.failed.logical_or_(alloc_fail[:, 0])
    s.frag_count.add_(failp[:, 0].to(i32))
    s.steps.add_(act[:, 0].to(i32))


# ----------------------------------------------------------- the launches

def threads(work: int, most: int) -> int:
    """A kernel's block: one thread per ``work`` item, whole warps, at
    most ``most``."""
    return min(most, max(32, -(-work // 32) * 32))


def _checked(s: FlatState, scratch: torch.Tensor, tab: StepTables):
    """Raise ``ValueError`` on a state the kernels do not take: every
    tensor contiguous on the tables' device, with the step's shapes and
    dtypes."""
    lanes, q = s.ev_time.shape
    n, g = tab.n, tab.g
    f = tab.denom.dtype
    want = {
        "ev_time": (torch.int32, (lanes, q)), "aux": (torch.int32, (lanes, q)),
        "pod_ctime": (torch.int32, (lanes, q)),
        "pending": (torch.int32, (lanes,)), "failed": (torch.bool, (lanes,)),
        "steps": (torch.int32, (lanes,)),
        "cpu_left": (torch.int32, (lanes, n)),
        "mem_left": (torch.int32, (lanes, n)),
        "gpu_left": (torch.int32, (lanes, n)),
        "gpu_milli_left": (torch.int32, (lanes, n, g)),
        "wait_hist": (torch.int32, (lanes, tab.h)),
        "events_processed": (torch.int32, (lanes,)),
        "snap_idx": (torch.int32, (lanes,)), "snap_sums": (f, (lanes, 4)),
        "frag_sum": (f, (lanes,)), "frag_count": (torch.int32, (lanes,)),
        "max_nodes": (torch.int32, (lanes,)),
    }
    dev = tab.feat.device
    named = [(k, getattr(s, k), d, shape) for k, (d, shape) in want.items()]
    named.append(("scratch", scratch, torch.int32, (lanes, len(SCRATCH))))
    if s.aux_gpus is not None or s.fault_time is not None \
            or s.trace is not None:
        raise ValueError("flat_step takes packed aux, no faults and no "
                         "decision trace")
    if tab.feat.shape[0] != q:
        raise ValueError(f"flat_step: {q} slots, {tab.feat.shape[0]} pods")
    for name, x, dtype, shape in named:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"flat_step reads {name} as a contiguous {dtype} {shape} on "
                f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return lanes, q


def _launch(name: str, dev: torch.device, block, *args) -> None:
    """``name`` of ``csrc/flat_step.cu`` on ``dev``'s current stream."""
    from fks_tpu_torch.ops import _ext

    lib = _ext.flat_step_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)((ctypes.c_longlong * len(block))(*block),
                                 *args, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.fks_cuda_error_string(err).decode()})")


def flat_pop(s: FlatState, scratch: torch.Tensor, tab: StepTables) -> None:
    """Pop every lane's next event into ``scratch`` and refund a DELETE's
    node in place: one launch of ``csrc/flat_step.cu``'s ``flat_pop`` on
    the state's card (counted in ``flat_pop.launches``); ``pop_plain`` for
    CPU tensors."""
    if s.ev_time.device.type == "cpu":
        return pop_plain(s, scratch, tab)
    lanes, q = _checked(s, scratch, tab)
    block = [x.data_ptr() for x in (
        s.ev_time, s.aux, tab.feat, s.pending, s.failed, s.steps, s.cpu_left,
        s.mem_left, s.gpu_left, s.gpu_milli_left, scratch)]
    # a thread folds 8 slots (two 16-byte loads of each row) at once
    block += [lanes, q, tab.n, tab.g, tab.max_steps,
              threads(-(-q // 8), POP_THREADS)]
    _launch("fks_flat_pop", s.ev_time.device, block)
    flat_pop.launches += 1


def flat_commit(s: FlatState, scratch: torch.Tensor, raw: torch.Tensor,
                tab: StepTables) -> None:
    """Apply every active lane's event after the policy scored it (``raw``
    i32[L, N], any strides): one launch of ``csrc/flat_step.cu``'s
    ``flat_commit`` (counted in ``flat_commit.launches``);
    ``commit_plain`` for CPU tensors."""
    if s.ev_time.device.type == "cpu":
        return commit_plain(s, scratch, raw, tab)
    lanes, q = _checked(s, scratch, tab)
    if raw.dtype != torch.int32 or raw.device != s.ev_time.device \
            or raw.dim() > 2:
        raise ValueError(f"flat_commit reads the policy's scores as int32 "
                         f"[L, N] on {s.ev_time.device}, got {raw.dtype} "
                         f"{tuple(raw.shape)} on {raw.device}")
    raw = raw.expand(lanes, tab.n)
    strides = [st if sz > 1 else 0 for sz, st in zip(raw.shape, raw.stride())]
    block = [x.data_ptr() for x in (
        s.ev_time, s.aux, s.pod_ctime, s.pending, s.cpu_left, s.mem_left,
        s.gpu_left, s.gpu_milli_left, s.wait_hist, s.events_processed,
        s.snap_idx, s.snap_sums, s.frag_sum, s.frag_count, s.max_nodes,
        s.failed, s.steps, scratch, raw, tab.node_mask, tab.cpu_total,
        tab.mem_total, tab.num_gpus, tab.gpu_mask, tab.totals, tab.denom,
        tab.ktable)]
    block += strides + [lanes, q, tab.n, tab.g, tab.h,
                        int(tab.ktable.shape[0]), int(tab.first_fit),
                        int(tab.track_ctime),
                        threads(-(-max(tab.n, tab.h) // COMMIT_PER_THREAD),
                                COMMIT_THREADS)]
    _launch("fks_flat_commit", s.ev_time.device, block,
            ctypes.c_int(tab.denom.element_size()))
    flat_commit.launches += 1


flat_pop.launches = 0  # kernel launches (CUDA only), reset by callers
flat_commit.launches = 0
