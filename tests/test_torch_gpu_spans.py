"""The port's spans on the card: the CUDA events around the fused kernel's
launch and around each graph replay of the drain loop, and the count of
synchronising calls in one instrumented generation.

Marked ``gpu``: these need a CUDA card and skip without one. Run them on
the GPU machine with

    python -m pytest -p no:cacheprovider -m gpu tests/test_torch_gpu_spans.py

A generation of ``ParametricEvolution`` synchronises with the host at
its seed draw, at each round's flag read of the drain loop (flat and
exact engines) and at its two read-backs (best and mean score); the
instrumentation adds none inside the drain's rounds, and one read of the
lanes' steps (``lane_steps``) once its job is done
(``torch.cuda.set_sync_debug_mode`` counts them).
"""
import warnings

import pytest
import torch

from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
from fks_tpu_torch.obs import spans
from fks_tpu_torch.sim.engine import SimConfig

pytestmark = pytest.mark.gpu

#: synchronising calls of a generation besides the seed draw, the flag
#: reads and the two read-backs: none, before the instrumentation as
#: after it (on an H100 the test's fused generation makes 3, its flat
#: generation of 13 rounds 16)
OTHER_SYNCS = {"fused": 0, "flat": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA events time the card's work")
    spans.ring().clear()
    yield torch.device("cuda")
    spans.ring().clear()


def _search(engine, dev):
    pe = ParametricEvolution(synthetic_workload(8, 96, seed=5), pop_size=16,
                             elite_k=4, engine=engine,
                             cfg=SimConfig(track_ctime=False), device=dev)
    pe.run(1)  # builds the kernel or captures the graph
    torch.cuda.synchronize()
    spans.ring().clear()
    return pe


@pytest.mark.parametrize("engine", ["fused", "flat"])
def test_engine_event_times_fit_inside_their_generation(cuda, engine):
    from fks_tpu_torch.sim.fused import fused_sim

    pe = _search(engine, cuda)
    launches = fused_sim.launches
    pe.run(3)
    gens = [r for r in spans.ring() if r.label == "gen"]
    assert len(gens) == 3
    for g in gens:
        c = g.counters
        assert 0 < c["engine_device_s"] <= g.seconds
        if engine == "fused":
            assert "replays" not in c and "rounds" not in c
        else:
            assert c["replays"] == c["rounds"] - 1 > 0
            assert c["round_gap_s"] > 0
            assert c["steps"] == 16 * c["replays"]
            assert 0 < c["lane_steps"] <= c["lane_slots"]
            assert c["lane_slots"] == pe.params.shape[0] * c["steps"]
            assert (c["engine_device_s"] + c["round_gap_s"]
                    <= g.seconds)
    assert fused_sim.launches - launches == (3 if engine == "fused" else 0)
    if engine == "flat":
        drains = [r for r in spans.ring() if r.path == "gen/eval/drain"]
        assert len(drains) == 3
        for r, g in zip(drains, gens):
            assert (r.counters["engine_device_s"]
                    == g.counters["engine_device_s"])


def _syncs(fn) -> int:
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("engine", ["fused", "flat"])
def test_an_instrumented_generation_adds_no_synchronisation(cuda, engine):
    pe = _search(engine, cuda)
    count = _syncs(lambda: pe.run(1))
    (g,) = [r for r in spans.ring() if r.label == "gen"]
    rounds = g.counters.get("rounds", 0)
    lane_reads = 1 if rounds else 0  # the drain's one job, once it is done
    assert count == 1 + rounds + lane_reads + 2 + OTHER_SYNCS[engine], (
        count, rounds)
