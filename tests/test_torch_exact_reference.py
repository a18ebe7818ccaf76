"""The benchmark's plain reference of the exact semantics
(``portbench/reference/exact_sim.py``) against the port's exact heap
engine and against the original simulator's recorded output.

- Seeded random parametric weights on the first pods of the default
  trace, float32, a population of 8: every integer field, and every
  pod's node, GPUs and final (retry-rewritten) creation time exactly,
  on lanes that retry; the fitness and the utilisations within 1e-6.
- The reference's event loop under a plain float64 best_fit scorer
  against ``golden_default.json``'s best_fit record: counts, every
  snapshot, every fragmentation event, the placements and the final
  creation times.
- ``sim.engine.drain`` counts ``lane_steps``, the sum of the lanes'
  ``steps``, under an open span.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from fks_tpu_torch.models import parametric
from fks_tpu_torch.obs import spans
from fks_tpu_torch.parallel import make_population_eval
from fks_tpu_torch.sim import engine
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import one_torch_thread
from portbench import harness
from portbench.loops import inputs
from portbench.reference import exact_sim

GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "golden_default.json"
INT_FIELDS = ("num_snapshots", "num_fragmentation_events",
              "events_processed", "scheduled_pods", "max_nodes", "failed",
              "truncated")
FLOAT_FIELDS = ("policy_score", "avg_cpu_utilization",
                "avg_memory_utilization", "avg_gpu_count_utilization",
                "avg_gpu_memory_utilization", "gpu_fragmentation_score")
POD_FIELDS = ("assigned_node", "assigned_gpus", "pod_ctime")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def _inputs(max_pods):
    cfg = harness.load_json("configs", "openb16-exact")
    cluster, pods, _ = inputs.reference_inputs(cfg, max_pods)
    return cluster, pods, inputs.port_workload(cfg, max_pods)


@pytest.mark.parametrize("max_pods,seed,noise", [(200, 1, 0.3),
                                                 (400, 2, 0.3),
                                                 (400, 0, 0.1)])
def test_reference_equals_the_exact_engine(max_pods, seed, noise):
    cluster, pods, wl = _inputs(max_pods)
    w = parametric.init_population(torch.Generator().manual_seed(seed), 8,
                                   noise=noise)
    res = make_population_eval(wl, device="cpu")(w)
    refs = exact_sim.run(cluster, pods, w.numpy())
    retried = 0
    for lane, ref in enumerate(refs):
        for k in INT_FIELDS:
            assert int(getattr(res, k)[lane]) == int(ref[k]), (lane, k)
        for k in POD_FIELDS:
            got = getattr(res, k)[lane, :pods.count].numpy()
            np.testing.assert_array_equal(got, ref[k], err_msg=f"{lane} {k}")
        for k in FLOAT_FIELDS:
            assert abs(float(getattr(res, k)[lane]) - ref[k]) <= 1e-6, \
                (lane, k)
        retried += int((ref["pod_ctime"] != pods.ctime).any())
    assert retried > 0  # the retry rule and its rewritten times are held


def _best_fit_f64(cluster):
    """The reference simulator's best_fit in Python floats: 1 - (0.33
    remaining CPU + 0.33 remaining memory + 0.34 remaining GPUs, each over
    the node's total), times 10,000, truncated, at least 1 where the pod
    fits."""
    gm = cluster.gpu_mask
    cpu, mem = cluster.cpu.astype(float), cluster.mem.astype(float)
    gpus = np.maximum(cluster.num_gpus, 1).astype(float)

    def scorer(rows, pod, cl, ml, gl, gml):
        pcpu, pmem, png, pmi = pod
        eligible = (gm & (gml >= pmi[..., None])).sum(axis=-1)
        fits = ((pcpu <= cl) & (pmem <= ml) & (png <= gl)
                & ((png <= 0) | (eligible >= png)))
        norm = ((cl - pcpu) / cpu * 0.33 + (ml - pmem) / mem * 0.33
                + (gl - png) / gpus * 0.34)
        score = np.maximum(np.trunc((1 - norm) * 10000).astype(np.int64), 1)
        return np.where(fits, score, 0)

    return scorer


def test_reference_event_loop_equals_the_original_simulator():
    cluster, pods, _ = _inputs(None)
    ref = json.loads(GOLDEN.read_text())["policies"]["best_fit"]
    (r,) = exact_sim.replay(cluster, pods, _best_fit_f64(cluster), 1,
                            precision="float64")
    assert not r["failed"] and not r["truncated"]
    for k in ("events_processed", "num_snapshots", "num_fragmentation_events",
              "scheduled_pods", "max_nodes"):
        assert r[k] == ref[k], k
    assert r["assigned_node"].tolist() == ref["assignments"]
    assert [[k for k in range(cluster.g) if b >> k & 1]
            for b in r["assigned_gpus"].tolist()] == ref["assigned_gpus"]
    assert r["pod_ctime"].tolist() == ref["final_creation_time"]
    np.testing.assert_allclose(r["snapshots"], ref["snapshots"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(r["fragmentation_events"],
                               ref["fragmentation_events"], rtol=0,
                               atol=1e-12)
    for k in FLOAT_FIELDS:
        assert abs(r[k] - ref[k]) < 1e-9, k


def test_drain_counts_the_steps_of_active_lanes():
    _, _, wl = _inputs(120)
    cfg = SimConfig()
    w = parametric.init_population(torch.Generator().manual_seed(4), 6,
                                   noise=0.3)
    run = engine.make_population_run_fn(wl, parametric.score, cfg)
    job = run.start(w, engine.initial_state(wl, cfg))
    spans.ring().clear()
    with spans.span("drain"):
        engine.drain([job])
    c = list(spans.ring())[-1].counters
    steps = job.state.steps
    assert c["lane_steps"] == int(steps.sum())
    assert c["lane_slots"] == job.advances * engine.SYNC_EVERY * 6
    assert int(steps.min()) < int(steps.max())  # lanes end apart
    spans.ring().clear()
