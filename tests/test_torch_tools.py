"""The port's profiling tools (fks_tpu_torch.tools), on the CPU at tiny
widths: each tool's JSON has exactly the keys of fks_tpu's
``tools/profile_step.py`` and ``tools/measure_tiers.py`` (read from their
sources), and every variant is present. The timings here are CPU
timings of the plain path; the card's are chip_smoke.py phase 16's.
"""
import ast
import contextlib
import io
import json
import pathlib

import pytest
import torch

from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.tools import measure_tiers, profile_step

ROOT = pathlib.Path(__file__).resolve().parent.parent


def fks_tpu_keys(tool):
    """The string keys fks_tpu's tool writes: those of its dict literals
    and of its ``name["..."] = ...`` assignments."""
    tree = ast.parse((ROOT / "tools" / tool).read_text())
    keys = {k.value for d in ast.walk(tree) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return {k for k in keys if isinstance(k, str)}


@pytest.fixture(scope="module")
def profile_json():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = profile_step.main(["--cpu", "--steps", "8", "--lanes", "1,2",
                                "--json"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    return lines, json.loads(lines[-1])


def test_profile_step_json_has_fks_tpu_keys(profile_json):
    _, doc = profile_json
    fk = fks_tpu_keys("profile_step.py")
    assert set(doc) == {"device", "steps", "rows", "lanes1", "lanes2",
                        "device_profile"}
    assert set(doc) - {"lanes1", "lanes2"} <= fk
    for lanes in ("lanes1", "lanes2"):
        assert set(doc[lanes]) == {"flat_us", "basis_us", "alloc_us",
                                   "ctime_us", "exact_full_us"} <= fk
    for row in doc["rows"]:
        assert set(row) == {"lanes", "name", "us_per_step"} <= fk
    assert doc["device"] == "cpu:cpu" and doc["steps"] == 8


def test_profile_step_runs_every_variant(profile_json):
    lines, doc = profile_json
    got = [(r["lanes"], r["name"]) for r in doc["rows"]]
    assert got == [(ln, n) for ln in (1, 2) for n in profile_step.VARIANTS]
    src = (ROOT / "tools" / "profile_step.py").read_text()
    for name in profile_step.VARIANTS:
        assert f'"{name}"' in src  # fks_tpu's variant names
    assert all(r["us_per_step"] > 0 for r in doc["rows"])
    assert "per-step cost summary (us):" in lines
    stages = {s["stage"] for s in doc["device_profile"]["stages"]}
    assert {f"{n}@l{ln}:{part}" for ln in (1, 2)
            for n in profile_step.VARIANTS
            for part in ("compile", "steady")} == stages


def test_step_loop_restarts_from_the_same_state():
    """Each call starts from the start state: two calls end equal, and
    equal to the body run eagerly."""
    from fks_tpu_torch.sim import engine

    wl = synthetic_workload(4, 24, seed=3)
    state0 = engine.initial_state(wl, engine.SimConfig())
    body = profile_step.heap_bodies()["2pop+2push"]
    loop = profile_step.StepLoop(body, state0.heap, 5)
    a = torch.clone(loop().data), torch.clone(loop.state.size)
    b = loop()
    assert torch.equal(a[0], b.data) and torch.equal(a[1], b.size)
    h = engine.map_tensors(torch.clone, state0.heap)
    for _ in range(5):
        h = body(h)
    assert torch.equal(h.data, b.data) and loop.steps_run == 5


@pytest.fixture(scope="module")
def tiers():
    return measure_tiers.measure(synthetic_workload(4, 24, seed=3),
                                 pop=4, candidates=3, device="cpu")


def test_measure_tiers_has_fks_tpu_keys(tiers):
    want = fks_tpu_keys("measure_tiers.py") - {"exact_error"}
    assert set(tiers) == want
    assert tiers["device"] == "cpu:cpu" and tiers["workload"] == "4x24"
    assert tiers["vm_tier_hits"] == 3 and tiers["vm_batch_pop"] == 3
    assert tiers["parametric_pop"] == 4
    assert tiers["exact_events"] > 0 and tiers["evolve_gen_candidates"] > 0
    # the CPU captures no graph
    assert tiers["evolve_xla_compiles"] == 0


def test_measure_tiers_without_the_generation():
    """``generation=False`` leaves out exactly the ``evolve_*`` keys."""
    got = measure_tiers.measure(synthetic_workload(4, 24, seed=3), pop=4,
                                candidates=3, generation=False,
                                device="cpu")
    want = fks_tpu_keys("measure_tiers.py") - {"exact_error"}
    assert set(got) == {k for k in want if not k.startswith("evolve_")}
    assert got["vm_skipped_candidates"] == 0 and got["exact_events"] > 0


def test_measure_tiers_needs_three_candidates():
    with pytest.raises(ValueError, match="candidates 2 < 3"):
        measure_tiers.measure(synthetic_workload(4, 24, seed=3),
                              candidates=2, device="cpu")


def test_tools_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less "
                    "path")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_step.main(["--steps", "8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_tiers.measure(synthetic_workload(4, 24, seed=3))
