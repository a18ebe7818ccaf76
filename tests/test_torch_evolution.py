"""The port's FunSearch evolution loop against fks_tpu's, on the CPU.

The same ``FakeLLM(seed=7)`` drafts, ``max_workers=1`` (a shared-RNG fake
LLM with more workers can permute which draw lands on which future), the
micro workload (tests/test_engine_micro.py) through ``port_workload`` and
``SimConfig(score_dtype=float64)`` in both packages. Each run compares the
per-generation ``GenerationStats`` (time fields removed), the final
population (code, score), ``best`` and every ledger row written through a
capturing ``NullRecorder`` subclass in each package: scores within 1e-9,
everything else exact.

Also here: ``CodeEvaluator`` against fks_tpu's on seeds and junk,
checkpoint and WAL resumes (the port's own, and fks_tpu's files resumed
in the port), ``ParametricEvolution``'s checkpoint, ``init_from_weights``
and ``convert.device_evolution_state_from_npz``, the options that wait
for later slices, and ``fks_tpu_evolve_pins``, which makes
tests/fixtures/evolve_prefix256_pins.json (chip_smoke.py phase 11).
"""
import dataclasses
import hashlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.funsearch import FakeLLM as JaxFakeLLM
from fks_tpu.funsearch import evolution as jevo
from fks_tpu.funsearch.backend import CodeEvaluator as JaxCodeEvaluator
from fks_tpu.funsearch.device_evolution import (
    ParametricEvolution as JaxParametricEvolution,
)
from fks_tpu.funsearch.transpiler import canonical_key as jax_canonical_key
from fks_tpu.obs.recorder import NullRecorder as JaxNullRecorder
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch import convert
from fks_tpu_torch.funsearch import (
    CodeEvaluator, EvolutionConfig, FakeLLM, FunSearch, seed_policies,
    transpiler,
)
from fks_tpu_torch.funsearch import evolution as evo
from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
from fks_tpu_torch.models import parametric
from fks_tpu_torch.obs.recorder import NullRecorder
from fks_tpu_torch.resilience import GenerationWAL
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import one_torch_thread, port_workload
from tests.test_engine_micro import micro_workload

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINS = ROOT / "tests" / "fixtures" / "evolve_prefix256_pins.json"
TIME_FIELDS = ("eval_seconds", "llm_seconds", "budget_device_seconds",
               "evals_per_sec", "device_seconds")
TOL = 1e-9
BASE = dict(population_size=8, generations=2, elite_size=2,
            candidates_per_generation=4, max_workers=1, seed=7,
            early_stop_threshold=1.1)  # never early-stop


class Capture(NullRecorder):
    """The port's recorder API, keeping every metric and event row."""

    def __init__(self):
        self.rows = []

    def event(self, kind, **fields):
        self.rows.append(("event", kind, fields))

    def metric(self, kind, record=None, **fields):
        self.rows.append(("metric", kind, dict(record or {}, **fields)))


class JaxCapture(JaxNullRecorder):
    """fks_tpu's recorder API, keeping every metric and event row."""

    def __init__(self):
        self.rows = []

    def event(self, kind, **fields):
        self.rows.append(("event", kind, fields))

    def metric(self, kind, record=None, **fields):
        self.rows.append(("metric", kind, dict(record or {}, **fields)))


class KillSwitch(Exception):
    """A simulated kill of the process."""


class CountingLLM(FakeLLM):
    """The port's FakeLLM, counting completions."""

    def __init__(self, seed):
        super().__init__(seed=seed)
        self.calls = 0

    def complete(self, prompt):
        self.calls += 1
        return super().complete(prompt)


def quiet(_msg):
    pass


def untimed(row):
    """A stats or ledger row without its wall-clock fields."""
    if dataclasses.is_dataclass(row):
        row = dataclasses.asdict(row)
    return {k: v for k, v in row.items() if k not in TIME_FIELDS}


def assert_close(got, want, where="row"):
    """Floats within TOL, everything else exact, recursively."""
    if isinstance(want, float) and isinstance(got, float):
        assert abs(got - want) <= TOL, f"{where}: {got} vs {want}"
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            f"{where}: keys {sorted(got)} vs {sorted(want)}"
        for k in want:
            assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{where}: {got} vs {want}"
        for i, (a, b) in enumerate(zip(got, want)):
            assert_close(a, b, f"{where}[{i}]")
    else:
        assert got == want, f"{where}: {got!r} vs {want!r}"


def ledger(rows):
    return [(kind, name, untimed(fields)) for kind, name, fields in rows]


def assert_runs_match(fs, jfs, rec=None, jrec=None):
    assert_close([untimed(h) for h in fs.history],
                 [untimed(h) for h in jfs.history], "history")
    assert [c for c, _ in fs.population] == [c for c, _ in jfs.population]
    assert_close([s for _, s in fs.population],
                 [s for _, s in jfs.population], "population")
    assert fs.best[0] == jfs.best[0]
    assert_close(fs.best[1], jfs.best[1], "best")
    assert_close(fs.best_exact, jfs.best_exact, "best_exact")
    assert fs.generation == jfs.generation
    if rec is not None:
        assert_close(ledger(rec.rows), ledger(jrec.rows), "ledger")


@pytest.fixture(scope="module")
def micro():
    return micro_workload()


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def both_runs(micro, engine="exact", **overrides):
    """One ``evolution.run`` per package with the same config; returns
    (port driver, fks_tpu driver, port capture, fks_tpu capture)."""
    cfg = dict(BASE, **overrides)
    rec, jrec = Capture(), JaxCapture()
    jfs = jevo.run(micro, jevo.EvolutionConfig(**cfg),
                   backend=JaxFakeLLM(seed=7),
                   sim_config=JaxConfig(score_dtype=jnp.float64),
                   engine=engine, log=quiet, recorder=jrec)
    fs = evo.run(port_workload(micro), EvolutionConfig(**cfg),
                 backend=FakeLLM(seed=7),
                 sim_config=SimConfig(score_dtype=torch.float64),
                 engine=engine, log=quiet, recorder=rec, device="cpu")
    return fs, jfs, rec, jrec


# ------------------------------------------------------------ evaluator

def test_evaluator_matches_fks_tpu_on_seeds_and_junk(micro):
    codes = list(seed_policies().values()) + [
        "import os", "def priority_function(pod, node:",
        "def priority_function(pod, node):\n    return pod.nope\n",
        seed_policies()["best_fit"].replace("max(1, int(score))",
                                            "max(1,  int(score))")]
    ev = CodeEvaluator(port_workload(micro),
                       SimConfig(score_dtype=torch.float64), device="cpu")
    jev = JaxCodeEvaluator(micro, JaxConfig(score_dtype=jnp.float64))
    got, want = ev.evaluate(codes), jev.evaluate(codes)
    assert [r.error for r in got] == [r.error for r in want]
    assert_close([r.score for r in got], [r.score for r in want], "scores")
    assert ev.last_eval_stats == jev.last_eval_stats
    for counter in ("compile_count", "vm_count", "vm_batch_count",
                    "preflight_rejected", "preflight_duplicates"):
        assert getattr(ev, counter) == getattr(jev, counter), counter
    # the transpiled tier: one runner per canonical key, the reformatted
    # source hits the cache
    ref = CodeEvaluator(port_workload(micro),
                        SimConfig(score_dtype=torch.float64), use_vm=False,
                        device="cpu")
    a = ref.evaluate_one(codes[1])
    b = ref.evaluate_one(codes[-1])
    assert ref.compile_count == 1 and a.score == b.score == got[1].score


def test_batched_vm_tier_matches_one_by_one(micro):
    """The batched tier (the card's default) gives the one-by-one tier's
    records, in input order."""
    codes = list(seed_policies().values())
    fake = FakeLLM(seed=2, junk_rate=0.0)
    from fks_tpu_torch.funsearch import template
    codes += [template.fill_template(fake.complete("")) for _ in range(3)]
    wl = port_workload(micro)
    cfg = SimConfig(score_dtype=torch.float64)
    batched = CodeEvaluator(wl, cfg, vm_batch=True, device="cpu")
    single = CodeEvaluator(wl, cfg, vm_batch=False, device="cpu")
    a, b = batched.evaluate(codes), single.evaluate(codes)
    assert [r.score for r in a] == [r.score for r in b]
    assert batched.vm_batch_count == 1 and batched.vm_batch_fallbacks == 0
    assert batched.last_eval_stats["vm_batch_lanes"] == len(codes)
    assert batched.last_eval_stats["fallback_lanes"] == 0


def test_unported_options_raise(micro):
    wl = port_workload(micro)
    # mesh= runs (tests/test_torch_mesh.py); what is not a Mesh raises
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        CodeEvaluator(wl, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ParametricEvolution(wl, pop_size=4, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="queue 1 item 6"):
        evo.run(wl, EvolutionConfig(**BASE), profile=True, device="cpu")
    with pytest.raises(ValueError, match="requires suite mode"):
        from fks_tpu_torch.funsearch import BudgetConfig
        CodeEvaluator(wl, budget=BudgetConfig(schedule="halving"),
                      device="cpu")


def test_entry_points_default_to_the_card(micro):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    wl = port_workload(micro)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodeEvaluator(wl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evo.run(wl, EvolutionConfig(**BASE), log=quiet)


# ------------------------------------------------------ evolution runs

@pytest.fixture(scope="module")
def exact_runs(micro):
    """The exact-engine run in both packages, shared by the tests that
    read it."""
    with one_torch_thread():
        return both_runs(micro)


def test_exact_engine_run_matches_fks_tpu(exact_runs):
    fs, jfs, rec, jrec = exact_runs
    assert_runs_match(fs, jfs, rec, jrec)
    assert fs.history[-1].vm_coverage == 1.0


def test_flat_engine_with_exact_rescoring_matches_fks_tpu(micro):
    fs, jfs, rec, jrec = both_runs(micro, engine="flat")
    assert_runs_match(fs, jfs, rec, jrec)
    assert fs.evaluator.engine == "flat"
    assert fs._exact_eval is not None and fs._exact_eval.engine == "exact"
    assert sorted(fs._exact_memo.values()) == sorted(
        jfs._exact_memo.values())


def test_budget_halving_matches_fks_tpu(micro):
    """smoke3 probe rung -> default8 full rung, one generation: the rung
    records, the pruned/survivor scores, the champion audit and every
    ledger row equal fks_tpu's."""
    fs, jfs, rec, jrec = both_runs(
        micro, generations=1, scenario_suite="default8",
        budget_schedule="halving", probe_suite="smoke3")
    assert_runs_match(fs, jfs, rec, jrec)
    st = fs.history[-1]
    assert st.budget_pruned > 0 and st.scenario_suite == "default8"
    rungs = [r for r in rec.rows if r[1] == "budget_rung"]
    assert [r[2]["rung"] for r in rungs] == [0, 1]


def test_save_policies_write_fks_tpu_schema(exact_runs, tmp_path):
    fs, jfs, _, _ = exact_runs
    top = json.loads(pathlib.Path(
        fs.save_top_policies(str(tmp_path / "p"), k=3)).read_text())
    jtop = json.loads(pathlib.Path(
        jfs.save_top_policies(str(tmp_path / "j"), k=3)).read_text())
    drop = lambda e: {k: v for k, v in e.items() if k != "timestamp"}  # noqa: E731
    assert [drop(e) for e in top] == [drop(e) for e in jtop]
    best = json.loads(pathlib.Path(
        fs.save_best_policy(str(tmp_path / "p"))).read_text())
    jbest = json.loads(pathlib.Path(
        jfs.save_best_policy(str(tmp_path / "j"))).read_text())
    assert sorted(best) == sorted(jbest)
    assert drop(best) == drop(jbest)


def test_checkpoint_round_trip_continues_identically(micro, exact_runs,
                                                    tmp_path):
    """Checkpoint after generation 1, restore into a fresh driver, run
    generation 2: equal to the uninterrupted run, and to fks_tpu's."""
    wl = port_workload(micro)
    ev = CodeEvaluator(wl, SimConfig(score_dtype=torch.float64),
                       device="cpu")

    def make():
        return FunSearch(ev, EvolutionConfig(**BASE),
                         backend=FakeLLM(seed=7), log=quiet)

    ck = str(tmp_path / "evo.json")
    fs = make()
    fs.initialize_population()
    fs.evolve_generation()
    fs.checkpoint(ck)
    fs.evolve_generation()
    fs2 = make()
    fs2.restore(ck)
    assert fs2.generation == 1
    fs2.evolve_generation()
    assert (fs2.best, fs2.population) == (fs.best, fs.population)
    _, jfs, _, _ = exact_runs
    assert fs2.best[0] == jfs.best[0]
    assert [c for c, _ in fs2.population] == [c for c, _ in jfs.population]


def _killed_then_resumed(run, wl, tmp_path, backend_cls, **kw):
    """Run to a kill inside generation 2 (after its drafts and evals are
    in the WAL, before its commit), then resume with the same paths."""
    ck, wal = str(tmp_path / "evo.json"), str(tmp_path / "wal.jsonl")

    def kill_in_gen2(stats):
        if stats.generation == 2:
            raise KillSwitch("killed mid-generation")

    with pytest.raises(KillSwitch):
        run(wl, backend=backend_cls(seed=7), checkpoint_path=ck,
            wal_path=wal, on_generation=kill_in_gen2, log=quiet, **kw)
    return ck, wal


def test_wal_resume_after_kill_matches_uninterrupted(micro, tmp_path):
    wl = port_workload(micro)
    kw = dict(sim_config=SimConfig(score_dtype=torch.float64), device="cpu")

    def run(w, **a):
        return evo.run(w, EvolutionConfig(**BASE), **a, **kw)

    ck, wal = _killed_then_resumed(run, wl, tmp_path, CountingLLM)
    assert not GenerationWAL(wal).committed(2)
    llm = CountingLLM(seed=7)
    fs = run(wl, backend=llm, checkpoint_path=ck, wal_path=wal, log=quiet)
    assert llm.calls == 0  # the drafts came back from the WAL
    assert fs.wal_replayed_codes > 0 and fs.wal_replayed_evals > 0
    assert GenerationWAL(wal).committed(2)
    ref = run(wl, backend=FakeLLM(seed=7), log=quiet)
    assert fs.best == ref.best and fs.population == ref.population


def test_fks_tpu_checkpoint_and_wal_resume_in_the_port(micro, tmp_path):
    """A checkpoint and a WAL written by fks_tpu (killed inside generation
    2) resume in the port to fks_tpu's own resumed result."""
    jkw = dict(sim_config=JaxConfig(score_dtype=jnp.float64))

    def jrun(w, **a):
        return jevo.run(w, jevo.EvolutionConfig(**BASE), **a, **jkw)

    ck, wal = _killed_then_resumed(jrun, micro, tmp_path, JaxFakeLLM)
    # the port resumes from copies, fks_tpu from the originals
    pck, pwal = tmp_path / "port_evo.json", tmp_path / "port_wal.jsonl"
    pck.write_bytes(pathlib.Path(ck).read_bytes())
    pwal.write_bytes(pathlib.Path(wal).read_bytes())
    llm = CountingLLM(seed=7)
    fs = evo.run(port_workload(micro), EvolutionConfig(**BASE), backend=llm,
                 checkpoint_path=str(pck), wal_path=str(pwal), log=quiet,
                 sim_config=SimConfig(score_dtype=torch.float64),
                 device="cpu")
    jfs = jrun(micro, backend=JaxFakeLLM(seed=7), checkpoint_path=ck,
               wal_path=wal, log=quiet)
    assert llm.calls == 0
    assert fs.wal_replayed_evals == jfs.wal_replayed_evals > 0
    assert_runs_match(fs, jfs)
    # and the files the port rewrote read back in fks_tpu
    assert GenerationWAL(str(pwal)).summary()["committed"] == [1, 2]
    state = json.loads(pck.read_text())
    assert state["generation"] == 2
    assert state["rng_state"] == json.loads(
        pathlib.Path(ck).read_text())["rng_state"]


# ------------------------------------------------ parametric evolution

def test_parametric_checkpoint_restore_continues_bit_identically(
        micro, tmp_path):
    wl = port_workload(micro)

    def make():
        return ParametricEvolution(wl, pop_size=8, elite_k=2, seed=3,
                                   engine="flat", device="cpu")

    full = make()
    full.run(3)
    half = make()
    half.run(2)
    path = half.save_checkpoint(str(tmp_path / "pe"))
    assert path.endswith(".npz")
    with np.load(path) as d:
        assert sorted(d.files) == ["best_params", "best_score",
                                   "generation", "history", "key",
                                   "params", "real_count"]
        assert d["key"].dtype == np.uint8
    resumed = make()
    resumed.restore_checkpoint(path)
    assert resumed.generation == 2
    resumed.run(1)
    assert torch.equal(resumed.params, full.params)
    assert resumed.best_score == full.best_score
    assert torch.equal(resumed.best_params, full.best_params)
    assert [dataclasses.astuple(h) for h in resumed.history] == \
        [dataclasses.astuple(h) for h in full.history]
    code = resumed.best_code()
    assert transpiler.transpile(code) is not None
    assert CodeEvaluator(wl, device="cpu").evaluate_one(code).ok


def test_init_from_weights_keeps_lane_zero(micro):
    pe = ParametricEvolution(port_workload(micro), pop_size=6,
                             device="cpu")
    w = parametric.seed_weights("best_fit")
    pe.init_from_weights(w, 0.05, seed=1)
    assert torch.equal(pe.params[0], w)
    assert pe.params.shape == (6, w.shape[0])
    assert not torch.equal(pe.params[1], w)
    again = ParametricEvolution(port_workload(micro), pop_size=6,
                                device="cpu")
    again.init_from_weights(w, 0.05, seed=1)
    assert torch.equal(again.params, pe.params)
    with pytest.raises(ValueError, match="expects"):
        pe.init_from_weights(w[:3], 0.05)
    # fks_tpu keeps the champion in lane 0 the same way
    jpe = JaxParametricEvolution(micro, pop_size=8)
    jpe.init_from_weights(np.asarray(w), 0.05)
    assert np.array_equal(np.asarray(jpe.params[0]), w.numpy())


def test_device_evolution_state_from_fks_tpu_npz(micro, tmp_path):
    jpe = JaxParametricEvolution(micro, pop_size=8, elite_k=2, seed=2,
                                 engine="flat")
    jpe.run(2)
    path = jpe.save_checkpoint(str(tmp_path / "jax_pe"))
    state = convert.device_evolution_state_from_npz(path, device="cpu")
    pe = ParametricEvolution(port_workload(micro), pop_size=8, elite_k=2,
                             engine="flat", device="cpu")
    pe.load_state(state)
    assert np.array_equal(pe.params.numpy(), np.asarray(jpe.params))
    assert np.array_equal(pe.best_params.numpy(),
                          np.asarray(jpe.best_params))
    assert pe.best_score == jpe.best_score
    assert pe.generation == jpe.generation == 2
    assert [dataclasses.astuple(h) for h in pe.history] == \
        [dataclasses.astuple(h) for h in jpe.history]
    assert pe.best_code() == jpe.best_code()
    with pytest.raises(ValueError, match="device_evolution_state_from_npz"):
        pe.restore_checkpoint(path)
    pe.run(1)  # continues from the converted population
    assert pe.generation == 3


# --------------------------------------------- the phase-11 pins' source

def _canonical_sha(code: str) -> str:
    return hashlib.sha1(jax_canonical_key(code).encode()).hexdigest()


def _pin_run(fs) -> dict:
    return {
        "generations": [untimed(h) for h in fs.history],
        "population": [[_canonical_sha(c), s] for c, s in fs.population],
        "best": [_canonical_sha(fs.best[0]), fs.best[1]],
    }


def fks_tpu_evolve_pins(pods: int = 256) -> dict:
    """tests/fixtures/evolve_prefix256_pins.json from fks_tpu on the CPU
    (under x64): ``evolution.run`` with ``FakeLLM(seed=7)`` on the default
    cluster with the first ``pods`` pods of openb_pod_list_default.csv,
    the exact engine, ``SimConfig(score_dtype=float64)``; ``evolve`` as
    configured, ``budget`` with the default8 suite, halving over smoke3
    and one generation."""
    from tests.test_torch_scale import jax_make_workload_prefix

    evolve = dict(population_size=8, generations=2, elite_size=2,
                  candidates_per_generation=8, max_workers=1, seed=7,
                  early_stop_threshold=1.1)
    budget = dict(evolve, generations=1, scenario_suite="default8",
                  budget_schedule="halving", probe_suite="smoke3")
    wl = jax_make_workload_prefix(pods)
    out = {
        "about": (
            "fks_tpu's evolve-loop pins for chip_smoke.py phase 11: "
            "fks_tpu.funsearch.evolution.run(wl, EvolutionConfig(**config),"
            " backend=FakeLLM(seed=7), sim_config=SimConfig(score_dtype="
            "float64), engine='exact') under x64 on the CPU, wl the default"
            " cluster (16 nodes, G=8) with the first `pods` rows of "
            "openb_pod_list_default.csv. Per generation the GenerationStats"
            " without eval_seconds/llm_seconds/budget_device_seconds; the "
            "final population and best as [sha1 of the canonical key "
            "(ast.dump), score]. Made by tests/test_torch_evolution.py::"
            "fks_tpu_evolve_pins and checked there by "
            "test_evolve_pins_hold_on_fks_tpu."),
        "pods": pods,
    }
    for name, cfg in (("evolve", evolve), ("budget", budget)):
        fs = jevo.run(wl, jevo.EvolutionConfig(**cfg),
                      backend=JaxFakeLLM(seed=7),
                      sim_config=JaxConfig(score_dtype=jnp.float64),
                      engine="exact", log=quiet)
        out[name] = {"config": cfg, **_pin_run(fs)}
    return out


@pytest.mark.slow
def test_evolve_pins_hold_on_fks_tpu():
    """The fixture is what fks_tpu computes today (a few minutes: the
    budget run scores default8 through fks_tpu's batched VM on the
    CPU)."""
    want = json.loads(PINS.read_text())
    assert_close(fks_tpu_evolve_pins(), want, "pins")


def test_pins_fixture_is_well_formed():
    pins = json.loads(PINS.read_text())
    assert pins["pods"] == 256
    for name in ("evolve", "budget"):
        run = pins[name]
        gens = run["config"]["generations"]
        assert [g["generation"] for g in run["generations"]] == \
            list(range(1, gens + 1))
        assert len(run["population"]) <= run["config"]["population_size"]
        assert run["best"][1] == max(s for _, s in run["population"])
    assert pins["budget"]["generations"][0]["budget_pruned"] > 0


def test_config_from_json_equals_fks_tpu():
    path = str(ROOT / "configs" / "llm_config.json")
    assert dataclasses.asdict(EvolutionConfig.from_json(path)) == \
        dataclasses.asdict(jevo.EvolutionConfig.from_json(path))
