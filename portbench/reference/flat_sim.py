"""One candidate's replay of a trace, event by event, in plain Python.

The semantics are the flat engine's, which the configurations state
(``"retry": "earliest_pending_delete"``):

- events pop in (time, name rank) order; a pod's DELETE returns its CPU,
  memory, GPU count and the milli it holds on each of its GPUs;
- a CREATE scores every node (``score.Scorer``) and goes to the first
  node of the highest score if that score is above 0, taking the GPUs
  with the least free milli that fit it (ties to the lower slot);
- a CREATE that finds no node waits: it is retried at one past the
  earliest pending DELETE, or dropped when none is pending. A waiting
  GPU pod counts in the waiting set, and every failed CREATE records the
  fragmentation of the cluster: the free milli of GPUs that hold less
  than the smallest waiting request, over the cluster's milli;
- every processed pod event may take a utilisation snapshot: the k-th
  when events / pods first reaches k x the interval;
- the replay stops when nothing is pending or after ``factor x pods``
  events (truncated);
- the fitness is the mean utilisation over the snapshots, less the mean
  fragmentation capped at 0.1, clipped to [0, 1], and 0 unless every pod
  was placed, the replay was not truncated and a snapshot was taken.

Float accumulations are float32, in event order. ``precision`` selects
the policy arithmetic (``score.Arith``) and the rounding of the
evaluator's float results: ``"bfloat16"`` is the benchmark's control.
"""
from __future__ import annotations

import heapq
from collections import Counter

import numpy as np

from portbench.reference import score as sc
from portbench.reference.parse import Cluster, Pods

F32 = np.float32


class _Lane:
    """One candidate's event queue and evaluator state."""

    def __init__(self, heap, total):
        self.heap = list(heap)
        self.dels = []  # (time, rank, pod) of pending DELETEs
        self.node = np.full(total, -1, np.int64)
        self.bits = np.zeros(total, np.int64)
        self.waiting = np.zeros(total, bool)
        self.wait_set: Counter = Counter()  # gpu_milli of waiting GPU pods
        self.pending = total
        self.events = self.steps = self.frag_count = self.max_nodes = 0
        self.snap = 0
        self.snap_sums = [F32(0)] * 4
        self.frag_sum = F32(0)
        self.used = [0, 0, 0, 0]
        self.active = 0
        self.event = None


def run(cluster: Cluster, pods: Pods, weights, *, max_steps_factor: int = 8,
        snapshot_interval: float = 0.05, precision: str = "float32") -> list:
    """Replay the trace for every row of ``weights`` f32[L, 16]; a list of
    L result dicts. The lanes advance one event each per round, so one
    scoring call serves the CREATEs of all of them."""
    ar = sc.Arith(precision)
    rd = _rounding(precision)
    w = np.asarray(weights, F32).reshape(-1, len(sc.FEATURES))
    lanes, n, g = w.shape[0], cluster.n, cluster.g
    total = pods.count
    max_steps = max(64, max_steps_factor * total)
    cl = np.repeat(cluster.cpu[None], lanes, 0)
    ml = np.repeat(cluster.mem[None], lanes, 0)
    gl = np.repeat(cluster.declared[None], lanes, 0)
    gm, gmt = cluster.gpu_mask, cluster.gpu_milli
    gml = np.repeat(np.where(gm, gmt, 0)[None], lanes, 0)
    node_total = (cluster.cpu, cluster.mem, cluster.num_gpus)
    totals = (int(cluster.cpu.sum()), int(cluster.mem.sum()),
              int(cluster.num_gpus.sum()), int(np.where(gm, gmt, 0).sum()))
    denom = [F32(max(t, 1)) for t in totals]
    slot_of = np.arange(g)
    scorer = sc.Scorer(w, node_total, gmt, gm, ar)

    rank = np.empty(total, np.int64)
    rank[pods.order] = np.arange(total)
    heap0 = [(int(pods.ctime[i]), int(rank[i]), i) for i in range(total)]
    heapq.heapify(heap0)
    state = [_Lane(heap0, total) for _ in range(lanes)]
    for l, st in enumerate(state):
        st.used[2] = int((cluster.num_gpus - gl[l]).sum())

    def busy(l, i):
        return bool((cl[l, i] < cluster.cpu[i]) | (ml[l, i] < cluster.mem[i])
                    | (gl[l, i] < cluster.num_gpus[i]))

    for l, st in enumerate(state):
        st.active = sum(busy(l, i) for i in range(n))
    thresholds = [snapshot_interval]
    live = [st.pending > 0 for st in state]
    pod_cols = np.zeros((4, lanes, 1), np.int64)
    while any(live):
        creates = []
        for l, st in enumerate(state):
            if not live[l]:
                continue
            st.event = heapq.heappop(st.heap)
            st.steps += 1
            i = st.event[2]
            if st.node[i] < 0:
                creates.append(l)
                pod_cols[:, l, 0] = (pods.cpu[i], pods.mem[i],
                                     pods.num_gpu[i], pods.gpu_milli[i])
        s = {}
        if creates:
            rows = np.array(creates)
            s = dict(zip(creates, scorer(rows, tuple(pod_cols[:, rows]),
                                         cl[rows], ml[rows], gl[rows],
                                         gml[rows])))
        for l, st in enumerate(state):
            if not live[l]:
                continue
            t, rk, i = st.event
            pcpu, pmem = int(pods.cpu[i]), int(pods.mem[i])
            png, pmi = int(pods.num_gpu[i]), int(pods.gpu_milli[i])
            used = st.used
            if st.node[i] >= 0:  # DELETE
                heapq.heappop(st.dels)
                h = st.node[i]
                was_busy = busy(l, h)
                held = [k for k in range(g) if st.bits[i] >> k & 1]
                cl[l, h] += pcpu
                ml[l, h] += pmem
                gl[l, h] += png
                gml[l, h, held] += pmi
                used[0] -= pcpu
                used[1] -= pmem
                used[2] -= png
                used[3] -= pmi * len(held)
                st.pending -= 1
                st.active += int(busy(l, h)) - int(was_busy)
            else:  # CREATE
                h = int(np.argmax(s[l]))
                if s[l][h] > 0:
                    elig = gm[h] & (gml[l, h] >= pmi)
                    key = np.where(elig, gml[l, h] * g + slot_of,
                                   np.iinfo(np.int64).max)
                    take = np.argsort(key, kind="stable")[:png]
                    was_busy = busy(l, h)
                    cl[l, h] -= pcpu
                    ml[l, h] -= pmem
                    gl[l, h] -= png
                    gml[l, h, take] -= pmi
                    used[0] += pcpu
                    used[1] += pmem
                    used[2] += png
                    used[3] += pmi * len(take)
                    st.active += int(busy(l, h)) - int(was_busy)
                    st.node[i] = h
                    st.bits[i] = sum(1 << int(k) for k in take)
                    if st.waiting[i] and png > 0:
                        st.wait_set[pmi] -= 1
                    st.waiting[i] = False
                    end = (t + int(pods.dur[i]), rk, i)
                    heapq.heappush(st.heap, end)
                    heapq.heappush(st.dels, end)
                else:
                    if not st.waiting[i] and png > 0:
                        st.wait_set[pmi] += 1
                    st.waiting[i] = True
                    need = [m for m, c in st.wait_set.items() if c > 0]
                    frag = F32(0)
                    if need and totals[3] > 0:
                        low = min(need)
                        free = int(np.where(gm & (gml[l] > 0)
                                            & (gml[l] < low), gml[l], 0).sum())
                        frag = rd(rd(free) / rd(denom[3]))
                    st.frag_sum = rd(st.frag_sum + frag)
                    st.frag_count += 1
                    if st.dels:
                        heapq.heappush(st.heap, (st.dels[0][0] + 1, rk, i))
                    else:
                        st.pending -= 1
            st.events += 1
            while len(thresholds) <= st.snap:
                thresholds.append(thresholds[-1] + snapshot_interval)
            if st.events / total >= thresholds[st.snap]:
                for k in range(4):
                    u = (F32(0) if totals[k] <= 0
                         else rd(rd(used[k]) / rd(denom[k])))
                    st.snap_sums[k] = rd(st.snap_sums[k] + u)
                st.snap += 1
            st.max_nodes = max(st.max_nodes, st.active)
            live[l] = st.pending > 0 and st.steps < max_steps
    return [_result(st, rd) for st in state]


def _rounding(precision: str):
    """The rounding of the evaluator's float results: float32, or for the
    control bfloat16 (carried in float32)."""
    if precision == "bfloat16":
        return lambda x: F32(sc.to_bf16(F32(x)))
    return F32


def _result(st: _Lane, rd=F32) -> dict:
    truncated = st.pending > 0
    snap = st.snap
    avg = [rd(x / rd(max(snap, 1))) for x in st.snap_sums]
    frag_mean = (rd(st.frag_sum / rd(st.frag_count)) if st.frag_count
                 else F32(0))
    overall = rd(rd(rd(rd(avg[0] + avg[1]) + avg[2]) + avg[3]) / F32(4))
    raw = min(max(rd(overall - min(frag_mean, rd(0.1))), F32(0)), F32(1))
    ok = snap > 0 and bool((st.node >= 0).all()) and not truncated
    return {
        "policy_score": float(raw if ok else F32(0)),
        "avg_cpu_utilization": float(avg[0]),
        "avg_memory_utilization": float(avg[1]),
        "avg_gpu_count_utilization": float(avg[2]),
        "avg_gpu_memory_utilization": float(avg[3]),
        "gpu_fragmentation_score": float(frag_mean),
        "num_snapshots": snap, "num_fragmentation_events": st.frag_count,
        "events_processed": st.events,
        "scheduled_pods": int((st.node >= 0).sum()),
        "max_nodes": st.max_nodes, "failed": False, "truncated": truncated,
        "assigned_node": st.node, "assigned_gpus": st.bits,
    }
