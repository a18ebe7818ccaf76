"""The flat (slot-per-pod) event-queue engine, lanes written out.

Port of fks_tpu.sim.flat: best_fit or first_fit GPU allocation, packed or
unpacked ``aux``, ``track_ctime`` on or off, and the ``watchdog``,
``probe_score`` and ``validate_invariants`` flags (through the shared
guards, ``_audit`` and ``finalize_fields``). It is the fused kernel's
specification (csrc/fused_sim.cu) and its plain version.

One slot per pod, in tie-rank order: ``ev_time[L, Q]`` holds each slot's
pending event time (INF = none) and ``aux[L, Q]`` its scheduling state
(-1 fresh CREATE, -2 waiting after a failed placement, >= 0 placed as
``(node << G) | gpu_bits`` when that fits 31 bits, else the node index
with the bits in ``aux_gpus``). Each step pops, in every lane at once, the
slot with the lexicographic (time, slot) minimum — the reference's
equal-time tie rule — and applies the DELETE refund or the CREATE
placement. A failed CREATE retries at ``1 + earliest pending DELETE`` or
is dropped when no DELETE is pending (fks_tpu.sim.flat docstring: the
engine's defined retry rule). The step is self-masking: a finished lane
is a no-op, so one host loop drives all lanes until none is active.

Scenario faults (``Workload.faults``) sit in a queue of their own,
``fault_time[L, F]``: the earliest unconsumed fault wins against pod
events at equal time (the exact engine gives faults negative ranks), and
among equal-time faults the first index wins, their heap rank order. A
fault step flips one node's cordon bit and nothing else. The decision
trace (``SimConfig.decision_trace``) records input-order pod ids, so its
rows align with the exact engine's. Lanes may run different workloads, as
in the exact engine (``engine`` module docstring); the slot order is then
each trace's own.

The step updates the queue tensors (``ev_time``, ``aux``, ``aux_gpus``,
``pod_ctime``, ``wait_hist``, ``fault_time``, the trace) in place instead
of copying them per event.

``build_step`` decides once, from its inputs (``kernel_step_blocker``),
which step it builds: on CUDA, for packed ``aux`` and one workload with
no faults, trace, audit, watchdog, prefilter or packed state, the kernel
step (``sim.flat_step``: ``csrc/flat_step.cu``'s ``flat_pop`` and
``flat_commit`` around the policy call, three launches a step, the
whole state updated in place); everywhere else the PyTorch step
(``build_torch_step``), which the kernels are held to bit for bit.

Large clusters: ``SimConfig.node_prefilter_k`` scores only each event's
first k feasible nodes (``engine.prefilter_candidates``); ``state_pack``
stores the columns whose range provably fits 16 bits at the workload's
shape in int16 (``_pack_dtypes``), widening to int32 for arithmetic, so
policies see int32 views and results are bit-identical;
``make_segmented_population_run`` bounds the length of one device call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from fks_tpu_torch.data.entities import PodArrays, Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.ops.allocator import best_fit_gpus, first_fit_gpus
from fks_tpu_torch.ops.heap import KIND_NODE_UP
from fks_tpu_torch.sim.engine import (
    SYNC_EVERY, FinalView, GraphedChunk, SimConfig, _audit, _cluster_totals,
    _node_rows, _node_view, _pod_rows, _take, _tensor_leaves,
    bind_step, broadcast_state, check_config, graph_key,
    copy_state_, finalize_fields, gather_node_view, hist_size,
    lane_cluster, lane_table, loop_tables, population_runner,
    prefilter_candidates, run_batched_lanes, trace_append,
)
from fks_tpu_torch.sim.guards import guard_scores
from fks_tpu_torch.sim.types import (
    FlatState, PodView, PolicyFn, SimResult, batch_size, clone_tensors,
    copy_tensors_, empty_trace, map_tensors,
)
from fks_tpu_torch.utils.segments import segment_budget, validate_seg_steps

INF = 2**31 - 1  # empty-slot sentinel (int32 max)

AUX_FRESH = -1    # CREATE pending, never failed
AUX_WAITING = -2  # retried CREATE pending or dropped (in the waiting set)


def _node_bits(n_padded: int) -> int:
    return max(1, (max(n_padded, 1) - 1).bit_length())


def _packable(n_padded: int, g_padded: int) -> bool:
    """Can (node, gpu_bits) share one non-negative int32?"""
    return _node_bits(n_padded) + g_padded <= 31


def _pack_dtypes(cfg: SimConfig, c, p) -> dict:
    """Per-column state dtypes under ``SimConfig.state_pack``
    (fks_tpu.sim.flat._pack_dtypes, the same proofs). A column narrows to
    16 bits only when its full value range fits at this workload's shape:
    per-GPU milli capacity <= 32767 for ``gpu_milli_left``, the declared
    GPU count for ``gpu_left``, the pod count for ``wait_hist`` (a bucket
    cannot count more waiting pods), the node/GPU encoding width for
    ``aux`` (the -1/-2 sentinels need the sign bit, so the packed encoding
    must fit 14 value bits) and G <= 16 for ``aux_gpus``, whose bit
    pattern is stored in a signed int16 (PyTorch's uint16 supports few
    operations) and widened before any bit operation. Columns that cannot
    prove their range stay wide, so the knob degrades to a no-op, never to
    wraparound."""
    i16, i32 = torch.int16, torch.int32
    if not cfg.state_pack:
        return dict(aux=i32, aux_gpus=torch.int64, wait_hist=i32,
                    gpu_left=i32, gpu_milli_left=i32)
    n, g = c.n_padded, c.g_padded
    if _packable(n, g):
        aux_fits = _node_bits(n) + g <= 14
    else:
        aux_fits = n <= 32767  # unpacked aux holds a bare node index
    max_pg_milli = int(c.gpu_milli_total.max()) if c.gpu_milli_total.numel() \
        else 0
    max_gd = int(c.gpu_declared.max()) if c.gpu_declared.numel() else 0
    num_real = int(p.pod_mask.sum())
    return dict(
        aux=i16 if aux_fits else i32,
        aux_gpus=i16 if g <= 16 else torch.int64,
        wait_hist=i16 if num_real <= 32767 else i32,
        gpu_left=i16 if max_gd <= 32767 else i32,
        gpu_milli_left=i16 if max_pg_milli <= 32767 else i32,
    )


def _wide_bits(bits: torch.Tensor) -> torch.Tensor:
    """A GPU bitmask column as i64, whatever its stored width (an int16
    column holds a uint16 bit pattern)."""
    if bits.dtype == torch.int16:
        return bits.to(torch.int64) & 0xFFFF
    return bits


def state_bytes(state) -> int:
    """Bytes of every tensor of a state (the ``state_pack`` saving)."""
    return sum(x.numel() * x.element_size() for x in _tensor_leaves(state))


def runs_every_branch(device: torch.device) -> bool:
    """Whether the flat step runs its optional branches unconditionally:
    on CUDA, where asking whether any lane needs one is a host sync."""
    return device.type == "cuda"


def rank_perm(pod_mask: torch.Tensor, tie_rank: torch.Tensor) -> torch.Tensor:
    """Slot order: real pods by ascending tie_rank, padding last (stable);
    along the last axis, so a stack of traces gets one order per trace."""
    key = torch.where(pod_mask, tie_rank.to(torch.int64), INF)
    return torch.sort(key, stable=True).indices


def initial_state(workload: Workload, cfg: SimConfig,
                  lanes: int = 1) -> FlatState:
    """t=0 carry for ``lanes`` identical lanes on the workload's device:
    every real pod's slot (tie-rank order) holds its CREATE time."""
    check_config(cfg)
    c, p, fe = workload.cluster, workload.pods, workload.faults
    dev = workload.device
    i32 = torch.int32
    dt = _pack_dtypes(cfg, c, p)
    perm = rank_perm(p.pod_mask, p.tie_rank)
    ev_time = torch.where(p.pod_mask[perm], p.creation_time[perm], INF)
    pp = p.p_padded
    f = cfg.score_dtype

    def lane(x):
        return x.expand((lanes,) + tuple(x.shape)).clone()

    zeros = torch.zeros(lanes, dtype=i32, device=dev)
    return FlatState(
        ev_time=lane(ev_time.to(i32)),
        aux=torch.full((lanes, pp), AUX_FRESH, dtype=dt["aux"],
                       device=dev),
        aux_gpus=(None if _packable(c.n_padded, c.g_padded)
                  else torch.zeros((lanes, pp), dtype=dt["aux_gpus"],
                                   device=dev)),
        pending=torch.full((lanes,), int(p.pod_mask.sum()), dtype=i32,
                           device=dev),
        cpu_left=lane(c.cpu_total), mem_left=lane(c.mem_total),
        gpu_left=lane(c.gpu_declared.to(dt["gpu_left"])),
        gpu_milli_left=lane(c.gpu_milli_total.to(dt["gpu_milli_left"])),
        pod_ctime=lane(p.creation_time[perm]),
        wait_hist=torch.zeros((lanes, hist_size(workload, cfg)),
                              dtype=dt["wait_hist"], device=dev),
        events_processed=zeros, snap_idx=zeros.clone(),
        snap_sums=torch.zeros((lanes, 4), dtype=f, device=dev),
        frag_sum=torch.zeros(lanes, dtype=f, device=dev),
        frag_count=zeros.clone(), max_nodes=zeros.clone(),
        failed=torch.zeros(lanes, dtype=torch.bool, device=dev),
        steps=zeros.clone(), violations=zeros.clone(),
        numeric_flags=zeros.clone(),
        trace=(empty_trace(lanes, cfg.resolve_trace_len(workload.num_pods),
                           f, dev) if cfg.decision_trace else None),
        fault_time=None if fe is None else lane(
            torch.where(fe.mask, fe.time, INF).to(i32)),
        node_avail=None if fe is None else torch.ones(
            (lanes, c.n_padded), dtype=torch.bool, device=dev),
    )


def lane_active(s: FlatState, max_steps: int) -> torch.Tensor:
    """bool[L] termination predicate — the loop condition and the step's
    self-mask, so the two cannot diverge. Unconsumed faults keep a lane
    live, as they would still sit in the exact engine's heap, so trailing
    NODE_UP events drain in both engines."""
    live = s.pending > 0
    if s.fault_time is not None:
        live = live | (s.fault_time.amin(dim=1) < INF)
    return live & ~s.failed & (s.steps < max_steps)


def pod_table(p: PodArrays) -> torch.Tensor:
    """The pod rows a step gathers from, in slot (tie-rank) order: i32[Q,
    5] (cpu, mem, GPU count, GPU milli, duration), or [T, Q, 5] for
    stacked traces."""
    perm = rank_perm(p.pod_mask, p.tie_rank)
    return torch.stack([x.gather(-1, perm) for x in (
        p.cpu, p.mem, p.num_gpu, p.gpu_milli, p.duration)],
        dim=-1).to(torch.int32)


def kernel_step_blocker(workload: Workload, cfg: SimConfig,
                        lane_trace=None, pod_rows=None) -> Optional[str]:
    """What keeps ``build_step`` from building the kernel step
    (``sim.flat_step``: ``csrc/flat_step.cu``'s two kernels around the
    policy call) for a step over ``workload`` with these inputs, or None
    where it builds it. Decided once, from the inputs alone: the kernels take
    CUDA, packed ``aux``, no faults, one workload with the step's own pod
    and snapshot tables, no decision trace, audit or watchdog, the dense
    node sweep, unpacked state columns and a float32 or float64 score
    dtype (packed ``aux`` holds at most 30 GPUs a node, within the
    kernels' 32)."""
    c = workload.cluster
    checks = (
        ("not CUDA", workload.device.type != "cuda"),
        ("unpacked aux", not _packable(c.n_padded, c.g_padded)),
        ("faults", workload.faults is not None),
        ("lane_trace", lane_trace is not None),
        ("pod_rows", pod_rows is not None),
        ("decision_trace", cfg.decision_trace),
        ("validate_invariants", cfg.validate_invariants),
        ("watchdog", cfg.watchdog),
        ("node_prefilter_k", cfg.resolve_prefilter_k(c.n_padded) > 0),
        ("state_pack", cfg.state_pack),
        ("score_dtype", cfg.score_dtype not in (torch.float32,
                                                torch.float64)),
    )
    return next((why for why, hit in checks if hit), None)


def build_step(workload: Workload, policy: PolicyFn, cfg: SimConfig,
               ktable, max_steps: int, lane_trace=None,
               pod_rows=None) -> Callable[[FlatState], FlatState]:
    """One event in every lane (``build_torch_step``'s arguments): the
    kernel step (``sim.flat_step.build_kernel_step``) where
    ``kernel_step_blocker`` finds nothing against it, else the PyTorch
    step. The kernel step carries ``kernel_step = True``."""
    check_config(cfg)
    if kernel_step_blocker(workload, cfg, lane_trace, pod_rows) is None:
        from fks_tpu_torch.sim.flat_step import build_kernel_step

        return build_kernel_step(workload, policy, cfg, ktable, max_steps)
    return build_torch_step(workload, policy, cfg, ktable, max_steps,
                            lane_trace, pod_rows)


def build_torch_step(workload: Workload, policy: PolicyFn, cfg: SimConfig,
                     ktable, max_steps: int, lane_trace=None,
                     pod_rows=None) -> Callable[[FlatState], FlatState]:
    """The PyTorch step: the CPU's, and the one the kernel step is held
    to. One event in every lane. ``policy(PodView, NodeView) -> i32[L, N]``
    scores all lanes at once. With ``lane_trace`` the workload is a stack
    of traces and ``ktable`` their ``[T, K]`` snapshot tables.
    ``pod_rows`` is the step's ``pod_table`` buffer when the caller keeps
    its own (a serve graph rewrites it in place for every batch);
    ``ktable`` is then the caller's ``[L, K]`` buffer too, read in place
    with one row per lane, and ``lane_trace`` must map lane l to trace l.
    By default the step derives both from the workload once, when it is
    built.

    Per-lane scalars are ``[L, 1]`` columns inside the step. On the CPU,
    work that only some events need (refunds, scoring, GPU picks,
    fragmentation, snapshots) is skipped when no lane needs it: those
    branches only ever add masked-out zeros, so skipping them changes no
    result. On CUDA every branch runs, so the step never waits for the
    card to answer "does any lane need it"."""
    check_config(cfg)
    p = workload.pods
    c = lane_cluster(workload.cluster, lane_trace)
    dev = workload.device
    i32, i64 = torch.int32, torch.int64
    n, g = c.n_padded, c.g_padded
    f = cfg.score_dtype
    alloc = (best_fit_gpus if cfg.gpu_allocator == "best_fit"
             else first_fit_gpus)
    packed = _packable(n, g)
    totals = _cluster_totals(c)
    denom = totals.clamp(min=1).to(f)
    zero_f = torch.zeros((), dtype=f, device=dev)
    g_iota = torch.arange(g, dtype=i64, device=dev)
    g_pow = torch.ones((), dtype=i64, device=dev) << g_iota
    n_iota = torch.arange(n, dtype=i32, device=dev)
    if pod_rows is None:
        ktable = lane_table(torch.as_tensor(ktable, dtype=i32, device=dev),
                            lane_trace)
    klen = int(ktable.shape[-1])
    tix = lane_trace

    # pod features permuted into slot (tie-rank) order: one row per pod
    perm = rank_perm(p.pod_mask, p.tie_rank)  # [Q], or [T, Q]

    def slot_order(x):
        return x.gather(-1, perm)

    # [Q, 5], or [T, Q, 5]
    feat = pod_table(p) if pod_rows is None else pod_rows
    if cfg.validate_invariants:  # the audit's pods, in slot order
        p_slot = dataclasses.replace(p, **{
            k: lane_table(slot_order(getattr(p, k)), lane_trace)
            for k in ("cpu", "mem", "num_gpu", "gpu_milli")})
    has_faults = workload.faults is not None
    if has_faults:
        flt_node = lane_table(workload.faults.node.long(), lane_trace)
        flt_up = lane_table(workload.faults.kind == KIND_NODE_UP, lane_trace)

    every = runs_every_branch(dev)
    prefilter_k = cfg.resolve_prefilter_k(n)

    def needed(mask: torch.Tensor) -> bool:
        return every or bool(mask.any())

    def step(s: FlatState) -> FlatState:
        lanes = s.lanes
        act = lane_active(s, max_steps)[:, None]
        no = torch.zeros((lanes, 1), dtype=torch.bool, device=dev)

        # ---- pop: lexicographic (time, slot) minimum; torch.min returns
        # the first index among equal minima
        t, col = torch.min(s.ev_time, dim=1, keepdim=True)
        node_avail, place_mask = s.node_avail, c.node_mask
        if has_faults:
            # the earliest unconsumed fault wins ties against equal-time
            # pod events; among equal-time faults the first index wins
            ft, fidx = torch.min(s.fault_time, dim=1, keepdim=True)
            take_fault = act & (ft <= t)
            fault_node = _take(flt_node, fidx)
            fault_is_up = _take(flt_up, fidx)
            pod_act = act & ~take_fault
            s.fault_time.scatter_(1, fidx, torch.where(take_fault, INF, ft))
            node_avail = torch.where((n_iota == fault_node) & take_fault,
                                     fault_is_up, node_avail)
            # a cordoned node scores 0, "cannot/refuse", until its NODE_UP
            place_mask = place_mask & node_avail
        else:
            pod_act = act
        pcpu, pmem, pngpu, pmilli, pdur = _pod_rows(
            feat, col[:, 0], tix).split(1, dim=1)
        aux_s = s.aux.gather(1, col).to(i32)  # state_pack: widen
        is_del = pod_act & (aux_s >= 0)
        create = pod_act & (aux_s < 0)
        was_waiting = aux_s == AUX_WAITING
        gpu_pod = pngpu > 0
        held_node = aux_s >> g if packed else aux_s

        # ---- DELETION: refund the held node and GPUs. Arithmetic runs in
        # int32 whatever the stored widths (state_pack), so the policy sees
        # int32 views
        cpu_left, mem_left = s.cpu_left, s.mem_left
        gpu_left, gml = s.gpu_left.to(i32), s.gpu_milli_left.to(i32)
        if needed(is_del):
            if packed:
                held_bits = (aux_s & ((1 << g) - 1)).to(i64)
            else:
                held_bits = _wide_bits(s.aux_gpus.gather(1, col))
            oh_a = ((n_iota == held_node) & is_del).to(i32)  # [L, N]
            cpu_left = cpu_left + oh_a * pcpu
            mem_left = mem_left + oh_a * pmem
            gpu_left = gpu_left + oh_a * pngpu
            sel_bits = ((held_bits >> g_iota) & 1).to(i32)  # [L, G]
            gml = gml + (oh_a[:, :, None] * sel_bits[:, None, :]
                         * pmilli[:, :, None])

        # ---- CREATION: strict argmax placement, ties to the lowest node
        placed = pl = alloc_fail = no
        w = wk = torch.zeros((lanes, 1), dtype=torch.int64, device=dev)
        scores = torch.zeros((lanes, prefilter_k or n), dtype=i32,
                             device=dev)
        new_bits = torch.zeros((lanes, 1), dtype=i64, device=dev)
        numeric_flags = s.numeric_flags
        if needed(create):
            pod = PodView(pcpu, pmem, pngpu, pmilli, t, pdur)
            nodes = _node_view(c, cpu_left, mem_left, gpu_left, gml)
            if prefilter_k:
                # the cordon mask feeds the ranking itself
                cand = prefilter_candidates(pod, nodes, place_mask,
                                            prefilter_k)
                nodes = gather_node_view(nodes, cand)
            raw, numeric_flags = guard_scores(
                policy(pod, nodes), create[:, 0], numeric_flags,
                enabled=cfg.watchdog)
            if prefilter_k:
                # re-mask through the gather: a short list's tail is padding
                scores = torch.where(_take(place_mask, cand), raw, 0)
            else:
                scores = torch.where(place_mask, raw, 0)
            # wk indexes the scored view, w is the global node index
            wk = scores.argmax(dim=1, keepdim=True)  # first maximal index
            w = cand.gather(1, wk) if prefilter_k else wk
            placed = create & (scores.gather(1, wk) > 0)
        if needed(placed):
            rows = torch.arange(lanes, device=dev)
            sel, ok = alloc(gml[rows, w[:, 0]], _node_rows(c.gpu_mask, w),
                            pmilli[:, 0], pngpu[:, 0])
            alloc_fail = placed & gpu_pod & ~ok[:, None]  # reference raises
            pl = placed & ~alloc_fail
            oh_w = ((n_iota == w) & pl).to(i32)  # [L, N]
            cpu_left = cpu_left - oh_w * pcpu
            mem_left = mem_left - oh_w * pmem
            gpu_left = gpu_left - oh_w * pngpu
            gml = gml - (oh_w[:, :, None] * sel.to(i32)[:, None, :]
                         * pmilli[:, :, None])
            new_bits = (sel * g_pow).sum(dim=1, keepdim=True)

        # ---- failed creation: waiting histogram + fragmentation + retry
        failp = create & ~placed
        any_fail = needed(failp)
        hist = s.wait_hist
        if any_fail or needed(pl):
            hdelta = ((failp & ~was_waiting & gpu_pod).to(i32)
                      - (pl & was_waiting & gpu_pod).to(i32))
            hist.scatter_add_(1, pmilli.clamp(0, hist.shape[1] - 1),
                              hdelta.to(hist.dtype))
        frag_sum = s.frag_sum
        retry = dropped = no
        rt = t  # any value: only read where retry
        if any_fail:  # frag_score and the retry rule only count where failp
            hvals = hist > 0
            has_w = hvals.any(dim=1)
            min_needed = hvals.to(i32).argmax(dim=1)  # first waiting bucket
            frag_free = gml * (c.gpu_mask & (gml > 0)
                               & (gml < min_needed[:, None, None]))
            frag_score = torch.where(
                has_w & (totals[..., 3] > 0),
                frag_free.sum(dim=(1, 2)).to(f) / denom[..., 3], zero_f)
            frag_sum = frag_sum + torch.where(failp[:, 0], frag_score, zero_f)
            # retry at 1 + the earliest pending DELETE (queue not yet
            # rewritten this step), or drop when none is pending
            next_del = torch.where(s.aux >= 0, s.ev_time, INF).amin(
                dim=1, keepdim=True)
            found = next_del < INF
            retry, dropped = failp & found, failp & ~found
            rt = next_del + 1

        # ---- slot rewrite (lanes that popped a pod event only; the slot
        # held time t)
        new_t = torch.where(pl, t + pdur, torch.where(retry, rt, INF))
        enc = (w.to(i32) << g) | new_bits.to(i32) if packed else w.to(i32)
        new_aux = torch.where(pl, enc, torch.where(failp, AUX_WAITING, aux_s))
        s.ev_time.scatter_(1, col, torch.where(pod_act, new_t, t))
        s.aux.scatter_(1, col, torch.where(pod_act, new_aux, aux_s).to(
            s.aux.dtype))
        if not packed:
            s.aux_gpus.scatter_(1, col, torch.where(
                pl, new_bits, _wide_bits(s.aux_gpus.gather(1, col))).to(
                    s.aux_gpus.dtype))
        if cfg.track_ctime:
            s.pod_ctime.scatter_(1, col, torch.where(
                retry, rt, s.pod_ctime.gather(1, col)))
        pending = s.pending - (is_del | dropped)[:, 0].to(i32)

        # ---- evaluator bookkeeping; a fault step is a control event, not
        # counted (pod_act excludes it)
        valid = (pod_act & ~alloc_fail)[:, 0]
        events = s.events_processed + valid.to(i32)
        fire = valid & (s.snap_idx < klen) & (events >= _take(
            ktable, s.snap_idx.clamp(max=klen - 1).long()[:, None])[:, 0])
        snap_sums, snap_idx = s.snap_sums, s.snap_idx
        if needed(fire):
            used = torch.stack([
                totals[..., 0] - cpu_left.sum(dim=1, dtype=i64),
                totals[..., 1] - mem_left.sum(dim=1, dtype=i64),
                (c.num_gpus - gpu_left).sum(dim=1, dtype=i64),
                totals[..., 3] - gml.sum(dim=(1, 2), dtype=i64),
            ], dim=1).to(f)
            utils = torch.where(totals <= 0, zero_f, used / denom)
            snap_sums = snap_sums + torch.where(fire[:, None], utils, zero_f)
            snap_idx = snap_idx + fire.to(i32)
        active_nodes = (c.node_mask & (
            (cpu_left < c.cpu_total) | (mem_left < c.mem_total)
            | (gpu_left < c.num_gpus))).sum(dim=1, dtype=i32)
        max_nodes = torch.maximum(s.max_nodes, active_nodes * valid)

        violations = s.violations
        if cfg.validate_invariants:  # slots still holding a DELETE
            an, ag = decode_assignment(s.aux, s.aux_gpus, g, packed)
            violations = violations + act[:, 0].to(i32) * _audit(
                c, p_slot, (s.aux >= 0) & (s.ev_time < INF), cpu_left,
                mem_left, gpu_left, gml, an, ag)

        trace = s.trace
        if cfg.decision_trace:
            # input-order pod ids (perm[slot]), so rows align with the
            # exact engine's; pending counts unconsumed faults too, like
            # the exact engine's heap size
            tpod = _pod_rows(perm, col[:, 0], tix)
            tnode = torch.where(is_del, held_node,
                                torch.where(pl, w.to(i32), -1))[:, 0]
            trace_pending = pending
            fault_kw = {}
            if has_faults:
                tpod = torch.where(take_fault[:, 0], -1, tpod)
                tnode = torch.where(take_fault[:, 0], fault_node[:, 0],
                                    tnode)
                trace_pending = pending + (s.fault_time < INF).sum(
                    dim=1, dtype=i32)
                fault_kw = dict(fault_down=(take_fault & ~fault_is_up)[:, 0],
                                fault_up=(take_fault & fault_is_up)[:, 0])
            trace = trace_append(
                trace, active=act[:, 0], create=create[:, 0],
                is_del=is_del[:, 0], was_waiting=was_waiting[:, 0],
                pod=tpod, node=tnode, scores=scores, winner=wk,
                pending=trace_pending, cpu_left=cpu_left, mem_left=mem_left,
                gpu_left=gpu_left, gpu_milli_left=gml, **fault_kw)

        return dataclasses.replace(
            s, pending=pending, cpu_left=cpu_left, mem_left=mem_left,
            gpu_left=gpu_left.to(s.gpu_left.dtype),
            gpu_milli_left=gml.to(s.gpu_milli_left.dtype),
            events_processed=events,
            snap_idx=snap_idx, snap_sums=snap_sums, frag_sum=frag_sum,
            frag_count=s.frag_count + failp[:, 0].to(i32),
            max_nodes=max_nodes, failed=s.failed | alloc_fail[:, 0],
            steps=s.steps + act[:, 0].to(i32), violations=violations,
            numeric_flags=numeric_flags, trace=trace, node_avail=node_avail)

    return step


def run_lanes(step, s: FlatState, max_steps: int) -> FlatState:
    """Drive self-masking lanes until none is active: the host checks every
    ``SYNC_EVERY`` steps (the extra steps are no-ops); on CUDA the steps
    between checks are one replayed CUDA graph (``engine.GraphedChunk``)."""
    return run_batched_lanes(step, s, max_steps, active_fn=lane_active)


def decode_assignment(aux, aux_gpus, g: int, packed: bool):
    """(assigned_node i32, assigned_gpus i64) from the aux encoding, slot
    order. Placed pods keep aux >= 0 after their DELETE fires."""
    aux = aux.to(torch.int32)  # state_pack: widen
    placed = aux >= 0
    if packed:
        an = torch.where(placed, aux >> g, -1)
        ag = torch.where(placed, aux & ((1 << g) - 1), 0).to(torch.int64)
    else:
        an = torch.where(placed, aux, -1)
        ag = torch.where(placed, _wide_bits(aux_gpus), 0)
    return an.to(torch.int32), ag


def finalize(workload: Workload, cfg: SimConfig, s: FlatState,
             lane_trace=None) -> SimResult:
    """Fitness + results with per-pod arrays back in input order.
    Unconsumed faults count as pending events, as in the exact engine."""
    c, p = workload.cluster, workload.pods
    # each lane's slot of every input-order pod
    inv = lane_table(torch.argsort(rank_perm(p.pod_mask, p.tie_rank)),
                     lane_trace).expand(s.lanes, -1)
    an, ag = decode_assignment(s.aux, s.aux_gpus, c.g_padded,
                               _packable(c.n_padded, c.g_padded))
    view = FinalView(
        assigned_node=an.gather(1, inv), assigned_gpus=ag.gather(1, inv),
        pod_ctime=s.pod_ctime.gather(1, inv), cpu_left=s.cpu_left,
        mem_left=s.mem_left,
        # widen packed columns: result dtypes do not depend on state_pack
        gpu_left=s.gpu_left.to(torch.int32),
        gpu_milli_left=s.gpu_milli_left.to(torch.int32),
        events_processed=s.events_processed, snap_idx=s.snap_idx,
        snap_sums=s.snap_sums, frag_sum=s.frag_sum,
        frag_count=s.frag_count, max_nodes=s.max_nodes, failed=s.failed,
        violations=s.violations, numeric_flags=s.numeric_flags,
        trace=s.trace)
    pending = s.pending > 0
    if s.fault_time is not None:
        pending = pending | (s.fault_time.amin(dim=1) < INF)
    return finalize_fields(workload, cfg, pending=pending, s=view,
                           lane_trace=lane_trace)


def make_param_run_fn(workload: Workload, param_policy,
                      cfg: SimConfig = SimConfig()):
    """``run(params, state) -> SimResult``: drives every lane of ``state``
    with ``param_policy(params, pod, nodes)`` and finalizes."""
    ktable, max_steps = loop_tables(workload, cfg)

    def run(params, state: FlatState) -> SimResult:
        step = bind_step(build_step, workload, param_policy, params, cfg,
                         ktable, max_steps)
        return finalize(workload, cfg, run_batched_lanes(
            step, state, max_steps, lane_active))

    return run


def make_run_fn(workload: Workload, policy: PolicyFn,
                cfg: SimConfig = SimConfig()):
    """``run(state) -> SimResult`` for a plain policy."""
    run = make_param_run_fn(workload, lambda _p, pod, nodes:
                            policy(pod, nodes), cfg)
    return lambda state: run(None, state)


def make_population_run_fn(workload: Workload, param_policy,
                           cfg: SimConfig = SimConfig()):
    """``run(params[P, ...], state0) -> SimResult`` over P lanes: one host
    loop whose body is the lane-batched self-masking step. ``state0`` is a
    one-lane ``initial_state``; ``param_policy(params, pod, nodes)``. On
    CUDA one captured ``GraphedChunk`` per population size, as in the
    exact engine (``engine.population_runner``)."""
    return population_runner(workload, param_policy, cfg, build_step,
                             finalize, lane_active)


def make_segmented_population_run(workload: Workload, param_policy,
                                  cfg: SimConfig = SimConfig(),
                                  seg_steps: int = 4096, on_segment=None,
                                  double_buffer: bool = True):
    """``make_population_run_fn`` with a bounded device-call length
    (fks_tpu.sim.flat.make_segmented_population_run): the lanes advance
    one segment of at most ``seg_steps`` events (rounded up to whole
    graph replays) at a time, and the host decides between segments
    whether to go on.

    On CUDA a segment is a run of replays of the population's
    ``GraphedChunk`` (captured at the first segment, reused by later runs
    of the same population size). After each replay the any-active flag
    is copied to pinned host memory behind a CUDA event; the host waits
    only on the flag of the replay two back, so two replays stay queued
    and the card never waits for the host, and a segment whose lanes
    have drained ends there, as fks_tpu's segment loop does. On the CPU a
    segment runs ``SYNC_EVERY`` eager steps at a time and ends when no
    lane is active. The steps are self-masking, so the results equal the
    unsegmented runner's.

    ``double_buffer`` (default on) enqueues segment i+1 before it reads
    segment i's flag, so the loop runs one segment past the draining one
    (a no-op, since ``lane_active`` is monotonic, which ends after its
    first replays). ``double_buffer=False`` reads each segment's flag
    before enqueuing the next.

    ``on_segment`` (zero-argument callable) fires on the host after every
    segment is enqueued. The number of segments is bounded by
    ``utils.segments.segment_budget``; reaching it with a lane still
    active raises RuntimeError instead of finalizing a partial state.

    The returned ``run(params, state0)`` exposes ``run.advance(params,
    state) -> (state, flag)`` (one segment; ``flag`` a device bool
    tensor), ``run.finalize_pop(state)``, ``run.seg_steps`` and
    ``run.graphs`` (the captured chunks by ``engine.graph_key``)."""
    seg_steps = validate_seg_steps(seg_steps, zero_disables=False)
    ktable, max_steps = loop_tables(workload, cfg)
    graphs = {}

    def build(params):
        return bind_step(build_step, workload, param_policy, params, cfg,
                         ktable, max_steps)

    def any_active(state):
        return lane_active(state, max_steps).any()

    def advance(params, state: FlatState):
        """One segment from ``state`` (advanced in place on CUDA, where it
        becomes the population graph's own state): ``(state, flag)``."""
        if not state.ev_time.is_cuda:
            step = build(params)
            for _ in range(-(-seg_steps // SYNC_EVERY)):
                for _ in range(SYNC_EVERY):
                    state = step(state)
                if not bool(any_active(state)):
                    break
            return state, any_active(state)
        key = graph_key(state.lanes, params)
        chunk = graphs.get(key)
        done = 0
        if chunk is None:
            # construction runs the chunk once eagerly (its warm-up)
            chunk = GraphedChunk(build(clone_tensors(params)), state,
                                 max_steps, lane_active)
            graphs[key] = chunk
            done = 1
        else:
            copy_tensors_(chunk.step.params, params)
            if chunk.state is not state:
                copy_state_(chunk.state, state)
        flags = []
        for _ in range(done, -(-seg_steps // chunk.steps)):
            chunk.replay()
            flags.append(_observe(any_active(chunk.state)))
            if len(flags) > 2 and not _read(flags.pop(0)):
                break  # drained two replays ago
        return chunk.state, any_active(chunk.state)

    def finalize_pop(state: FlatState) -> SimResult:
        return finalize(workload, cfg, state)

    def run(params, state0: FlatState) -> SimResult:
        states = [broadcast_state(state0, batch_size(params))]

        def advance_all():
            states[0], flag = advance(params, states[0])
            return flag

        run_segments(advance_all, max_steps, seg_steps, on_segment,
                     double_buffer, "the flat engine")
        res = finalize_pop(states[0])
        return map_tensors(torch.clone, res) if states[0].ev_time.is_cuda \
            else res

    run.advance = advance
    run.finalize_pop = finalize_pop
    run.seg_steps = seg_steps
    run.graphs = graphs
    return run


def run_segments(advance, max_steps: int, seg_steps: int, on_segment=None,
                 double_buffer: bool = True, what: str = "the flat engine"
                 ) -> int:
    """The host loop of a segmented run: ``advance()`` moves the lanes
    one segment on and returns the device flag "any lane still active"
    (one population, or every shard of a mesh folded into one flag).
    Double-buffered, segment i+1 is enqueued before segment i's flag is
    read, so the loop runs one no-op segment past the draining one and
    the budget (``segment_budget``) carries one more observation segment
    (slack 2). ``on_segment`` fires after every enqueued segment.
    Reaching the budget with a lane still active raises RuntimeError.
    Returns the number of segments run."""
    pending = []  # observed segment flags not yet read
    segments = 0
    for _ in range(segment_budget(max_steps, seg_steps,
                                  slack=2 if double_buffer else 1)):
        pending.append(_observe(advance()))
        segments += 1
        if on_segment is not None:
            on_segment()
        # double buffered: read segment i's flag once i+1 is enqueued
        if len(pending) == (2 if double_buffer else 1) \
                and not _read(pending.pop(0)):
            return segments
    # budget spent: the newest segment's flag decides; the budget is
    # exact for lockstep lanes, so a live lane means the step and the
    # predicate diverged
    if _read(pending[-1]):
        raise RuntimeError(
            "segmented runner exhausted its segment budget with lanes "
            f"still active — cond/step divergence in {what}")
    return segments


def _observe(flag: torch.Tensor):
    """Start reading a device flag: a non-blocking copy to pinned host
    memory and an event behind it (the CPU tensor as it is)."""
    if not flag.is_cuda:
        return flag
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _read(obs) -> bool:
    """Finish reading an observed flag (waits on its event only)."""
    if isinstance(obs, torch.Tensor):
        return bool(obs)
    host, event = obs
    event.synchronize()
    return bool(host)


def simulate(workload: Workload, policy: PolicyFn,
             cfg: SimConfig = SimConfig(), device=None) -> SimResult:
    """One policy, one lane, on ``device`` (default ``cuda``): the result
    of lane 0 (no lane axis)."""
    wl = workload.to(resolve_device(device))
    return make_run_fn(wl, policy, cfg)(initial_state(wl, cfg)).lane(0)
