"""The plain reference against itself and against hand-worked cases, on
the CPU at tiny sizes."""
from fractions import Fraction

import numpy as np
import pytest

from portbench.loops import inputs
from portbench.harness import load_json
from portbench.reference import flat_sim, parse
from portbench.reference import score as sc


def _exact_fma(a, b, c):
    """float32(a * b + c) rounded once, from exact rationals (ties to
    even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(exact))
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    best = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                     int(np.float32(x).view(np.uint32)) & 1))
    return best


def test_fma_is_rounded_once():
    rng = np.random.default_rng(0)
    a = rng.normal(size=400).astype(np.float32)
    b = rng.normal(size=400).astype(np.float32)
    c = rng.normal(size=400).astype(np.float32)
    # cases whose float64 sum lands exactly halfway between two float32
    a[:4] = np.float32(1 + 2 ** -23)
    b[:4] = np.float32(1 + 2 ** -23)
    c[:4] = np.float32(2 ** -24)
    got = sc.fma_f32(a, b, c)
    want = np.array([_exact_fma(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_bfloat16_rounds_to_nearest_even():
    x = np.array([1.0, 1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -7 + 2 ** -9,
                  -2.5], np.float32)
    assert sc.to_bf16(x).tolist() == [1.0, 1.0, 1 + 2 ** -6, 1 + 2 ** -7,
                                      -2.5]


def _one_node():
    cluster = parse.Cluster([{"name": "n0", "cpu": 1000, "mem": 1000,
                              "declared": 0, "gpus": []}])
    pods = parse.Pods([
        {"name": "a", "cpu": 800, "mem": 100, "num_gpu": 0, "gpu_milli": 0,
         "ctime": 0, "dur": 10},
        {"name": "b", "cpu": 800, "mem": 100, "num_gpu": 0, "gpu_milli": 0,
         "ctime": 5, "dur": 10}])
    return cluster, pods


def test_a_failed_create_retries_after_the_earliest_delete():
    """a runs 0-10; b finds no room at 5, retries at 11 (one past a's
    delete) and runs to 21: five events, one snapshot each, one failed
    CREATE, mean CPU use (0.8 + 0.8 + 0 + 0.8 + 0) / 5."""
    cluster, pods = _one_node()
    w = np.zeros(16, np.float32)
    w[0] = 0.1  # first fit
    (r,) = flat_sim.run(cluster, pods, w[None])
    assert r["events_processed"] == 5 and r["num_snapshots"] == 5
    assert r["num_fragmentation_events"] == 1
    assert r["assigned_node"].tolist() == [0, 0]
    assert not r["truncated"] and r["max_nodes"] == 1
    assert r["avg_cpu_utilization"] == pytest.approx(0.48, abs=1e-6)
    assert r["avg_memory_utilization"] == pytest.approx(0.06, abs=1e-6)
    assert r["policy_score"] == pytest.approx((0.48 + 0.06) / 4, abs=1e-6)


def test_a_replay_that_runs_out_of_steps_is_truncated():
    cluster, _ = _one_node()
    w = np.zeros((1, 16), np.float32)
    (r,) = flat_sim.run(cluster, parse.Pods([
        {"name": f"p{i}", "cpu": 800, "mem": 1, "num_gpu": 0,
         "gpu_milli": 0, "ctime": 0, "dur": 10 ** 6} for i in range(40)]),
        w + np.float32(0.1), max_steps_factor=1)
    assert r["truncated"] and r["events_processed"] == 64
    assert r["policy_score"] == 0.0


@pytest.fixture(scope="module")
def small_trace():
    cluster, pods, _ = inputs.reference_inputs(load_json("configs",
                                                         "openb16"), 300)
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(3, 16)) * 0.3).astype(np.float32)
    w[:, 13] += 1.0
    return cluster, pods, w


def test_lanes_together_equal_lanes_alone(small_trace):
    cluster, pods, w = small_trace
    together = flat_sim.run(cluster, pods, w)
    for lane in range(len(w)):
        (alone,) = flat_sim.run(cluster, pods, w[lane:lane + 1])
        for k, v in alone.items():
            assert np.array_equal(np.asarray(v), np.asarray(together[lane][k])), k


def test_every_pod_is_placed_and_counted(small_trace):
    cluster, pods, w = small_trace
    for r in flat_sim.run(cluster, pods, w):
        assert r["events_processed"] >= pods.count + r["scheduled_pods"] \
            or r["truncated"]
        assert 0.0 <= r["policy_score"] <= 1.0
        placed = r["assigned_node"] >= 0
        assert (r["assigned_gpus"][~placed] == 0).all()
