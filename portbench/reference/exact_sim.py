"""One candidate's replay of a trace under the reference simulator's own
semantics, event by event, in plain Python.

The semantics are those of ttanv/funsearch-kubernetes-simulator's event
loop (simulator/main.py, simulator/event_simulator.py), which a
configuration states with ``"semantics": "exact"``:

- the event queue is a ``heapq`` of ``(time, name rank, kind, pod)``
  entries, built by ``heapify`` from the pods in input order; (time, name
  rank) is unique among the queued events, so the entries compare as the
  simulator's events do and the heap's array layout is the simulator's;
- a DELETE returns the pod's CPU, memory, GPU count and the milli it holds
  on each of its GPUs;
- a CREATE scores every node and goes to the first node of the highest
  score if that score is above 0, taking the GPUs with the least free
  milli that fit it (ties to the lower slot). Where fewer GPUs fit than it
  asks for, the candidate is aborted (``failed``) before the event counts;
- a CREATE that finds no node waits: it is pushed again at 1 + the time of
  the first DELETE met in the raw array order of the heap after the pop
  (event_simulator.py:51-58), and that time becomes its creation time; it
  is dropped when no DELETE is queued. A waiting GPU pod counts in the
  waiting set, and every failed CREATE records the fragmentation of the
  cluster: the free milli of GPUs that hold less than the smallest waiting
  request, over the cluster's milli;
- every counted event may take a utilisation snapshot: the k-th when
  events / pods first reaches k x the interval;
- the replay stops when the queue is empty, the candidate failed, or after
  ``factor x pods`` pops (truncated);
- the fitness is the mean utilisation over the snapshots, less the mean
  fragmentation capped at 0.1, clipped to [0, 1], and 0 unless every pod
  was placed, the candidate did not fail, the replay was not truncated and
  a snapshot was taken.

Float accumulations are in the evaluator's precision, in event order:
float32 as configured, bfloat16 (carried in float32) for the benchmark's
control, float64 for the simulator's own Python floats. ``run`` scores
with the parametric policy (``score.Scorer``); ``replay`` takes any
scorer of the same signature.
"""
from __future__ import annotations

import heapq
from collections import Counter

import numpy as np

from portbench.reference import score as sc
from portbench.reference.parse import Cluster, Pods

F32 = np.float32
CREATE, DELETE = 0, 1

#: the evaluator's rounding of its float results, by precision
ROUNDING = {"float32": F32, "float64": np.float64,
            "bfloat16": lambda x: F32(sc.to_bf16(F32(x)))}


class _Lane:
    """One candidate's event queue and evaluator state."""

    def __init__(self, heap, pods: Pods, zero):
        total = pods.count
        self.heap = list(heap)
        self.node = np.full(total, -1, np.int64)
        self.bits = np.zeros(total, np.int64)
        self.ctime = pods.ctime.copy()
        self.waiting = np.zeros(total, bool)
        self.wait_set: Counter = Counter()  # gpu_milli of waiting GPU pods
        self.steps = self.events = self.frag_count = self.max_nodes = 0
        self.failed = False
        self.snap = 0
        self.snap_sums = [zero] * 4
        self.frag_sum = zero
        self.snapshots = []  # (cpu, mem, GPU count, GPU milli, progress)
        self.frags = []
        self.used = [0, 0, 0, 0]
        self.active = 0
        self.event = None


def run(cluster: Cluster, pods: Pods, weights, *, max_steps_factor: int = 8,
        snapshot_interval: float = 0.05, precision: str = "float32") -> list:
    """Replay the trace for every row of ``weights`` f32[L, 16] under the
    parametric policy computed in ``precision`` (float32, or bfloat16 for
    the control); a list of L result dicts."""
    w = np.asarray(weights, F32).reshape(-1, len(sc.FEATURES))
    scorer = sc.Scorer(w, (cluster.cpu, cluster.mem, cluster.num_gpus),
                       cluster.gpu_milli, cluster.gpu_mask,
                       sc.Arith(precision))
    return replay(cluster, pods, scorer, len(w),
                  max_steps_factor=max_steps_factor,
                  snapshot_interval=snapshot_interval, precision=precision)


def replay(cluster: Cluster, pods: Pods, scorer, lanes: int, *,
           max_steps_factor: int = 8, snapshot_interval: float = 0.05,
           precision: str = "float32") -> list:
    """Replay the trace in ``lanes`` lanes. ``scorer(rows, pod, cl, ml,
    gl, gml)`` gives the node scores int64[len(rows), N] of lanes ``rows``
    for their pods ``pod`` = (cpu, mem, num_gpu, gpu_milli), each int[R,
    1], on the nodes' free CPU, memory and GPU count [R, N] and free milli
    per GPU slot [R, N, G]. The lanes advance one event each per round, so
    one scoring call serves the CREATEs of all of them."""
    rd = ROUNDING[precision]
    n, g = cluster.n, cluster.g
    total = pods.count
    max_steps = max(64, max_steps_factor * total)
    cl = np.repeat(cluster.cpu[None], lanes, 0)
    ml = np.repeat(cluster.mem[None], lanes, 0)
    gl = np.repeat(cluster.declared[None], lanes, 0)
    gm, gmt = cluster.gpu_mask, cluster.gpu_milli
    gml = np.repeat(np.where(gm, gmt, 0)[None], lanes, 0)
    totals = (int(cluster.cpu.sum()), int(cluster.mem.sum()),
              int(cluster.num_gpus.sum()), int(np.where(gm, gmt, 0).sum()))
    denom = [rd(max(t, 1)) for t in totals]
    slot_of = np.arange(g)

    rank = np.empty(total, np.int64)
    rank[pods.order] = np.arange(total)
    heap0 = [(int(pods.ctime[i]), int(rank[i]), CREATE, i)
             for i in range(total)]
    heapq.heapify(heap0)
    state = [_Lane(heap0, pods, rd(0)) for _ in range(lanes)]

    def busy(l, i):
        return bool((cl[l, i] < cluster.cpu[i]) | (ml[l, i] < cluster.mem[i])
                    | (gl[l, i] < cluster.num_gpus[i]))

    def move(l, st, i, h, sign, gpus):
        """Return (``sign`` 1) or take (-1) pod ``i``'s resources on node
        ``h`` and its GPU slots ``gpus``."""
        pcpu, pmem = int(pods.cpu[i]), int(pods.mem[i])
        png, pmi = int(pods.num_gpu[i]), int(pods.gpu_milli[i])
        was_busy = busy(l, h)
        cl[l, h] += sign * pcpu
        ml[l, h] += sign * pmem
        gl[l, h] += sign * png
        gml[l, h, gpus] += sign * pmi
        for k, x in enumerate((pcpu, pmem, png, pmi * len(gpus))):
            st.used[k] -= sign * x
        st.active += int(busy(l, h)) - int(was_busy)

    def wait(l, st, i, rk):
        """A failed CREATE: the waiting set, the fragmentation, the retry
        at the first DELETE in the heap's array order (after the pop)."""
        png, pmi = int(pods.num_gpu[i]), int(pods.gpu_milli[i])
        if not st.waiting[i] and png > 0:
            st.wait_set[pmi] += 1
        st.waiting[i] = True
        need = [m for m, c in st.wait_set.items() if c > 0]
        frag = rd(0)
        if need and totals[3] > 0:
            low = min(need)
            free = int(np.where(gm & (gml[l] > 0) & (gml[l] < low), gml[l],
                                0).sum())
            frag = rd(rd(free) / denom[3])
        st.frag_sum = rd(st.frag_sum + frag)
        st.frag_count += 1
        st.frags.append(frag)
        retry = next((e[0] + 1 for e in st.heap if e[2] == DELETE), None)
        if retry is not None:
            st.ctime[i] = retry
            heapq.heappush(st.heap, (retry, rk, CREATE, i))

    for l, st in enumerate(state):
        st.used[2] = int((cluster.num_gpus - gl[l]).sum())
        st.active = sum(busy(l, i) for i in range(n))
    thresholds = [snapshot_interval]
    live = [bool(st.heap) for st in state]
    pod_cols = np.zeros((4, lanes, 1), np.int64)
    while any(live):
        creates = []
        for l, st in enumerate(state):
            if not live[l]:
                continue
            st.event = heapq.heappop(st.heap)
            st.steps += 1
            i = st.event[3]
            if st.event[2] == CREATE:
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
            t, rk, kind, i = st.event
            counted = True
            if kind == DELETE:
                move(l, st, i, st.node[i], 1,
                     [k for k in range(g) if st.bits[i] >> k & 1])
            elif s[l].max() > 0:
                h = int(np.argmax(s[l]))
                png, pmi = int(pods.num_gpu[i]), int(pods.gpu_milli[i])
                elig = gm[h] & (gml[l, h] >= pmi)
                if int(elig.sum()) < png:  # the simulator raises
                    st.failed, counted = True, False
                else:
                    key = np.where(elig, gml[l, h] * g + slot_of,
                                   np.iinfo(np.int64).max)
                    take = np.argsort(key, kind="stable")[:png]
                    move(l, st, i, h, -1, take)
                    st.node[i] = h
                    st.bits[i] = sum(1 << int(k) for k in take)
                    if st.waiting[i] and png > 0:
                        st.wait_set[pmi] -= 1
                    st.waiting[i] = False
                    heapq.heappush(st.heap, (t + int(pods.dur[i]), rk,
                                             DELETE, i))
            else:
                wait(l, st, i, rk)
            if counted:
                st.events += 1
                while len(thresholds) <= st.snap:
                    thresholds.append(thresholds[-1] + snapshot_interval)
                if st.events / total >= thresholds[st.snap]:
                    u = [rd(0) if totals[k] <= 0
                         else rd(rd(st.used[k]) / denom[k]) for k in range(4)]
                    st.snap_sums = [rd(a + b) for a, b in zip(st.snap_sums,
                                                              u)]
                    st.snapshots.append(u + [st.events / total])
                    st.snap += 1
                st.max_nodes = max(st.max_nodes, st.active)
            live[l] = bool(st.heap) and not st.failed and st.steps < max_steps
    return [_result(st, rd) for st in state]


def _result(st: _Lane, rd) -> dict:
    truncated = bool(st.heap) and not st.failed
    snap = st.snap
    avg = [rd(x / rd(max(snap, 1))) for x in st.snap_sums]
    frag_mean = (rd(st.frag_sum / rd(st.frag_count)) if st.frag_count
                 else rd(0))
    overall = rd(rd(rd(rd(avg[0] + avg[1]) + avg[2]) + avg[3]) / rd(4))
    raw = min(max(rd(overall - min(frag_mean, rd(0.1))), rd(0)), rd(1))
    ok = (snap > 0 and bool((st.node >= 0).all()) and not st.failed
          and not truncated)
    return {
        "policy_score": float(raw if ok else rd(0)),
        "avg_cpu_utilization": float(avg[0]),
        "avg_memory_utilization": float(avg[1]),
        "avg_gpu_count_utilization": float(avg[2]),
        "avg_gpu_memory_utilization": float(avg[3]),
        "gpu_fragmentation_score": float(frag_mean),
        "num_snapshots": snap, "num_fragmentation_events": st.frag_count,
        "events_processed": st.events,
        "scheduled_pods": int((st.node >= 0).sum()),
        "max_nodes": st.max_nodes, "failed": st.failed,
        "truncated": truncated, "steps": st.steps,
        "assigned_node": st.node, "assigned_gpus": st.bits,
        "pod_ctime": st.ctime,
        "snapshots": [[float(x) for x in u] for u in st.snapshots],
        "fragmentation_events": [float(x) for x in st.frags],
    }
