"""Field-by-field comparison of a port result with a reference, and the
small workloads the comparisons run on.

The split and tolerances are fks_tpu's own bar between its fused kernel
and its flat engine (tests/test_fused.py:24-45): integer observables must
be equal; float accumulators may differ by a few ulp (rtol = atol = 2e-6).
Against the reference's golden fixtures (tests/fixtures/golden_*.json) the
bar is fks_tpu's parity test (tests/test_engine_parity.py): integers
exact, floats within 1e-9.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

INT_FIELDS = (
    "events_processed", "scheduled_pods", "num_snapshots",
    "num_fragmentation_events", "assigned_node", "assigned_gpus",
    "cpu_left", "mem_left", "gpu_left", "gpu_milli_left", "max_nodes",
    "truncated", "failed", "invariant_violations",
)
FLOAT_FIELDS = (
    "policy_score", "avg_cpu_utilization", "avg_memory_utilization",
    "avg_gpu_count_utilization", "avg_gpu_memory_utilization",
    "gpu_fragmentation_score",
)
RTOL = ATOL = 2e-6


@contextlib.contextmanager
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the engine's per-event tensors
    are tiny, so intra-op threads only spin and contend with other
    processes (as parallel test workers do)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def port_workload(ref, device="cpu"):
    """The port's copy of a reference workload object (anything with
    fks_tpu's ``cluster``/``pods``/``faults`` field names), through
    numpy."""
    from fks_tpu_torch.convert import (
        CLUSTER_FIELDS, POD_FIELDS, workload_from_numpy,
    )
    from fks_tpu_torch.data.entities import FaultEvents

    cluster = {k: np.asarray(getattr(ref.cluster, k)) for k in CLUSTER_FIELDS}
    pods = {k: np.asarray(getattr(ref.pods, k)) for k in POD_FIELDS}
    cluster["node_ids"] = ref.cluster.node_ids
    pods["pod_ids"] = ref.pods.pod_ids
    wl = workload_from_numpy(cluster, pods, device=device)
    fe = getattr(ref, "faults", None)
    if fe is not None:
        wl = dataclasses.replace(wl, faults=FaultEvents(**{
            k: torch.from_numpy(np.array(getattr(fe, k), copy=True))
            for k in ("time", "node", "kind", "mask")}).to(device))
    return wl


def roomy_workload():
    """4 roomy 8-GPU nodes x 48 pods: every pod places (fks_tpu's
    tests/test_fused.py ``_roomy``, same seed and specs)."""
    from fks_tpu_torch.data.build import make_workload

    rng = np.random.default_rng(11)
    nodes = [{"node_id": f"n{i}", "cpu_milli": 64000, "memory_mib": 262144,
              "gpus": [1000] * 8, "gpu_memory_mib": 16384} for i in range(4)]
    pods = [{"pod_id": f"pod-{i:04d}",
             "cpu_milli": int(rng.integers(100, 1500)),
             "memory_mib": int(rng.integers(100, 4000)),
             "num_gpu": int(rng.integers(0, 3)),
             "gpu_milli": int(rng.integers(1, 300)),
             "creation_time": int(rng.integers(0, 1000)),
             "duration_time": int(rng.integers(0, 500))}
            for i in range(48)]
    for p in pods:
        if p["num_gpu"] == 0:
            p["gpu_milli"] = 0
    return make_workload(nodes, pods, pad_nodes_to=4, pad_gpus_to=8,
                         pad_pods_to=64)


def contended_workload():
    """4 small 2-GPU nodes x 96 pods: retries, fragmentation events, silent
    drops and (under a tight max_steps) truncation (fks_tpu's
    tests/test_fused.py ``_contended``, same seed and specs)."""
    from fks_tpu_torch.data.build import make_workload

    rng = np.random.default_rng(7)
    nodes = [{"node_id": f"n{i}", "cpu_milli": 16000, "memory_mib": 32000,
              "gpus": [1000] * 2, "gpu_memory_mib": 8000} for i in range(4)]
    pods = [{"pod_id": f"pod-{i:04d}",
             "cpu_milli": int(rng.integers(500, 6000)),
             "memory_mib": int(rng.integers(500, 12000)),
             "num_gpu": int(rng.integers(0, 3)),
             "gpu_milli": int(rng.integers(100, 1000)),
             "creation_time": int(rng.integers(0, 300)),
             "duration_time": int(rng.integers(10, 200))}
            for i in range(96)]
    for p in pods:
        if p["num_gpu"] == 0:
            p["gpu_milli"] = 0
    return make_workload(nodes, pods, pad_nodes_to=4, pad_gpus_to=2,
                         pad_pods_to=128)


def tied_workload_specs():
    """Node and pod specs of ``tied_workload`` (seed 5) and its padding, for
    building the same workload with either package's ``make_workload``."""
    rng = np.random.default_rng(5)
    nodes = [{"node_id": f"n{i}", "cpu_milli": 32000, "memory_mib": 64000,
              "gpus": [1000] * 4, "gpu_memory_mib": 8000} for i in range(4)]
    pods = []
    for i in range(1000):
        ngpu = int(rng.integers(0, 3))
        pods.append({
            "pod_id": f"pod-{int(rng.integers(0, 10**6)):06d}-{i:04d}",
            "cpu_milli": int(rng.integers(500, 2000)),
            "memory_mib": int(rng.integers(250, 6000)),
            "num_gpu": ngpu,
            "gpu_milli": int(rng.integers(100, 1000)) if ngpu else 0,
            "creation_time": int(rng.choice((0, 100, 200, 300, 400))),
            # t + duration ends one before a creation time, so a retry at
            # next DELETE + 1 lands on a time that other slots hold
            "duration_time": int(rng.choice((99, 199, 299)))})
    return nodes, pods, dict(pad_nodes_to=4, pad_gpus_to=4, pad_pods_to=1024)


def tied_workload():
    """4 small 4-GPU nodes x 1,000 pods (Q = 1,024 slots, 32 chunks of the
    fused kernel's queue): creation times from five values, so equal-time
    ties span chunk boundaries, and durations that put retries on times
    other slots hold. Fragmentation events and retries occur, and the
    retry storm runs into the step budget (truncation)."""
    from fks_tpu_torch.data.build import make_workload

    nodes, pods, pad = tied_workload_specs()
    return make_workload(nodes, pods, **pad)


def golden_micro_workload():
    """The reference's 2-node x 4-pod micro scenario (reference
    tests/test_simulator.py; fks_tpu tests/test_engine_micro.py), which
    ``golden_micro.json`` records with ``micro_best_fit``."""
    from fks_tpu_torch.data.build import make_workload

    nodes = [
        {"node_id": "node1", "cpu_milli": 8000, "memory_mib": 16000,
         "gpus": [1000, 1000], "gpu_memory_mib": 8000},
        {"node_id": "node2", "cpu_milli": 4000, "memory_mib": 8000,
         "gpus": []},
    ]
    pods = [
        {"pod_id": "pod1", "cpu_milli": 1000, "memory_mib": 2000,
         "num_gpu": 0, "gpu_milli": 0, "creation_time": 0,
         "duration_time": 10},
        {"pod_id": "pod2", "cpu_milli": 2000, "memory_mib": 4000,
         "num_gpu": 1, "gpu_milli": 500, "creation_time": 5,
         "duration_time": 15},
        {"pod_id": "pod3", "cpu_milli": 3000, "memory_mib": 6000,
         "num_gpu": 0, "gpu_milli": 0, "creation_time": 10,
         "duration_time": 8},
        {"pod_id": "pod4", "cpu_milli": 1500, "memory_mib": 3000,
         "num_gpu": 2, "gpu_milli": 400, "creation_time": 15,
         "duration_time": 12},
    ]
    return make_workload(nodes, pods, pad_nodes_to=4, pad_gpus_to=4,
                         pad_pods_to=8)


def random_policy_views(seed: int, lanes: int = 256, n: int = 16,
                        g: int = 8, gpu_heavy: bool = False,
                        scattered_masks: bool = False,
                        milli_total: Optional[int] = 1000,
                        unfit_lanes: int = 0):
    """``(PodView, NodeView, weights f32[lanes, 16])`` on the CPU, drawn
    with numpy from ``seed``: one pod per lane against ``n`` shared nodes
    of up to ``g`` GPUs (some CPU-only, some with every GPU free, one
    padding node when ``n > 1``); ``gpu_heavy`` makes every pod ask for
    1-3 GPUs. Options that change the draw: ``scattered_masks`` gives each
    node a random subset of its GPU slots (not a prefix);
    ``milli_total`` is every GPU's total milli (``None``: drawn per GPU
    from 200-2,000); the first ``unfit_lanes`` lanes' pods ask for more
    CPU than any node has, so they fit nowhere."""
    from fks_tpu_torch.sim.types import NodeView, PodView

    rng = np.random.default_rng(seed)
    gm = np.zeros((n, g), bool)
    ngpu = rng.integers(0, g + 1, n)
    ngpu[:3] = (0, g, 1)[:n]
    for i, k in enumerate(ngpu):
        if scattered_masks:
            gm[i, rng.permutation(g)[:k]] = True
        else:
            gm[i, :k] = True
    top = (rng.integers(200, 2001, (n, g)) if milli_total is None
           else np.full((n, g), milli_total))
    gmt = np.where(gm, top, 0).astype(np.int32)
    ct = rng.integers(2000, 128000, n).astype(np.int32)
    mt = rng.integers(4000, 786432, n).astype(np.int32)
    nm = np.ones(n, bool)
    if n > 1:
        nm[-1] = False
    used = rng.random((lanes, n))
    free = (rng.integers(0, 1001, (lanes, n, g)) if milli_total == 1000
            else (rng.random((lanes, n, g)) * (top + 1)).astype(np.int64))
    gml = np.where(gm, free, 0).astype(np.int32)
    gml[:, :, :2] = np.where(gm[:, :2], top[:, :2], 0)  # some full GPUs free
    t = torch.from_numpy
    nodes = NodeView(
        t((ct * (1 - used)).astype(np.int32)), t(ct),
        t((mt * (1 - rng.random((lanes, n)))).astype(np.int32)), t(mt),
        t(np.minimum(rng.integers(0, g + 2, (lanes, n)),
                     ngpu + 1).astype(np.int32)),
        t(ngpu.astype(np.int32)), t(gml), t(gmt), t(gmt.copy()), t(gm),
        t(nm))
    cpu = rng.integers(0, 8000, lanes)
    cpu[:unfit_lanes] = 200000  # above every node's 128,000 total
    pod = PodView(*(t(x.astype(np.int32))[:, None] for x in (
        cpu, rng.integers(0, 30000, lanes),
        rng.integers(1, 4, lanes) if gpu_heavy else rng.integers(0, 3, lanes),
        rng.integers(0, 1001, lanes),
        rng.integers(0, 10**6, lanes), rng.integers(0, 10**4, lanes))))
    w = rng.standard_normal((lanes, 16)).astype(np.float32)
    w[:, 13] += 1.0  # best_fit-like weights keep scores in a real range
    return pod, nodes, t(w)


#: the shapes csrc/param_score.cu is held to (lanes, nodes, GPUs): one
#: node, a ragged 16-node group on either side of 16, the 1,000-node
#: sweep; one GPU, the default cluster's 8, the kernel's 32
PARAM_SCORE_LANES = (1, 3, 256)
PARAM_SCORE_NODES = (1, 15, 16, 17, 1000)
PARAM_SCORE_GPUS = (1, 8, 32)


_GPU_GRID = ("gpu_milli_left", "gpu_milli_total", "gpu_mem_total",
             "gpu_mask")


def _slice_of_wider(x: torch.Tensor) -> torch.Tensor:
    """x as a view into a tensor one wider in its last axis, at offset 1:
    not contiguous, and for int32 not 16-byte aligned."""
    return torch.cat([x[..., :1], x], dim=-1)[..., 1:]


def param_score_cases(n: int):
    """``(label, pod, nodes, weights)`` on the CPU for every lane count and
    GPU count of the ``PARAM_SCORE_*`` shapes at ``n`` nodes. The cases
    take turns over shared and per-lane node tables, per-lane and shared
    weights, prefix and scattered GPU masks, GPU milli totals of 1,000,
    750 and drawn ones, GPU pods, a lane whose pod fits nowhere and, every
    third case, the remnants as slices of wider tensors (the kernel's
    strided path)."""
    from fks_tpu_torch.sim.types import NodeView

    i = 0
    for lanes in PARAM_SCORE_LANES:
        for g in PARAM_SCORE_GPUS:
            i += 1
            total = (1000, 750, None)[i % 3]
            scattered, per_lane = i % 2 == 0, (i // 2) % 2 == 1
            shared_w, sliced = (i // 4) % 2 == 1, (i + 1) % 3 == 0
            unfit = int(lanes > 1 and i % 4 in (2, 3))
            pod, nodes, w = random_policy_views(
                100 + i, lanes=lanes, n=n, g=g, gpu_heavy=i % 4 == 1,
                scattered_masks=scattered, milli_total=total,
                unfit_lanes=unfit)
            if per_lane:
                nodes = NodeView(*(
                    x.expand((lanes,) + tuple(x.shape)).contiguous()
                    if x.dim() == (2 if name in _GPU_GRID else 1) else x
                    for name, x in zip(NodeView._fields, nodes)))
            if sliced:
                nodes = nodes._replace(
                    cpu_milli_left=_slice_of_wider(nodes.cpu_milli_left),
                    gpu_milli_left=_slice_of_wider(nodes.gpu_milli_left))
            label = (f"L={lanes} N={n} G={g} "
                     f"{'per-lane' if per_lane else 'shared'} nodes, "
                     f"{'shared' if shared_w else 'per-lane'} weights, "
                     f"{'scattered' if scattered else 'prefix'} masks, "
                     f"milli total {total or 'drawn'}"
                     f"{', an unfit pod' if unfit else ''}"
                     f"{', sliced remnants' if sliced else ''}")
            yield label, pod, nodes, w[0] if shared_w else w


def _gpu_indices(bits) -> list:
    return [i for i in range(64) if (int(bits) >> i) & 1]


def assert_golden_micro(res, golden: Mapping, wl) -> None:
    """One-lane ``res`` of ``micro_best_fit`` on ``golden_micro_workload``
    equals ``golden_micro.json``: placements, GPU picks, final state."""
    n_pods, n = wl.num_pods, wl.num_nodes
    assert not bool(res.failed) and not bool(res.truncated)
    assert res.assigned_node[:n_pods].tolist() == golden["assignments"]
    assert [_gpu_indices(b) for b in res.assigned_gpus[:n_pods].tolist()] \
        == golden["assigned_gpus"]
    assert int(res.scheduled_pods) == golden["scheduled_pods"]
    assert int(res.max_nodes) == golden["max_nodes"]
    for key, got in (("final_cpu_left", res.cpu_left),
                     ("final_mem_left", res.mem_left),
                     ("final_gpu_left", res.gpu_left)):
        assert got[:n].tolist() == golden[key], key
    gml = res.gpu_milli_left.tolist()
    for i, row in enumerate(golden["final_gpu_milli_left"]):
        assert gml[i][:len(row)] == row


def assert_golden_parity(res, ref: Mapping, wl, tol: float = 1e-9) -> None:
    """One-lane ``res`` equals a policy's record in ``golden_default.json``
    or ``golden_alt_traces.json``: event, snapshot and fragmentation
    counts, placements, retry-mutated creation times and final remnants
    exact; fitness and utilizations within ``tol``."""
    assert not bool(res.failed) and not bool(res.truncated)
    for key in ("events_processed", "num_snapshots",
                "num_fragmentation_events", "scheduled_pods", "max_nodes"):
        assert int(getattr(res, key)) == ref[key], key
    n_pods, n = wl.num_pods, wl.num_nodes
    assert res.assigned_node[:n_pods].tolist() == ref["assignments"]
    assert res.pod_ctime[:n_pods].tolist() == ref["final_creation_time"]
    assert res.cpu_left[:n].tolist() == ref["final_cpu_left"]
    gml = res.gpu_milli_left.tolist()
    for i, row in enumerate(ref["final_gpu_milli_left"]):
        assert gml[i][:len(row)] == row
    for key in ("policy_score", "avg_cpu_utilization",
                "avg_memory_utilization", "avg_gpu_count_utilization",
                "avg_gpu_memory_utilization", "gpu_fragmentation_score"):
        assert abs(float(getattr(res, key)) - ref[key]) < tol, key


def result_fields(result) -> dict:
    """The compared fields of any result object (a port ``SimResult`` or
    fks_tpu's) as numpy arrays."""
    out = {}
    for f in INT_FIELDS + FLOAT_FIELDS:
        v = getattr(result, f)
        out[f] = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
    return out


def assert_result_matches(result, ref: Mapping[str, np.ndarray],
                          rtol: float = RTOL, atol: float = ATOL) -> None:
    """Integer fields exact, float fields within rtol/atol."""
    got = result_fields(result)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(ref[f]), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(ref[f]), rtol=rtol,
                                   atol=atol, err_msg=f)
