"""fks_tpu_torch.parallel.mesh (and its layout and telemetry rows) vs fks_tpu.

fks_tpu's mesh runs on the 8 virtual CPU devices of tests/conftest.py;
the port's on logical shards of the one CPU device (``[cpu] * 8``, a
``(2, 4)`` hybrid and a ``(4, 2)`` layout mesh). On the same inputs, made
from a seed:

- ``make_sharded_eval`` (exact, flat and fused) gives fks_tpu's scores
  and elites, with pad lanes and ``real_count`` (tests/test_population.py
  :74, :126), and the port's unsharded eval bit for bit; the hybrid mesh
  gives the flat mesh's; the decision trace rides out per lane;
- ``make_sharded_generation_step``: fks_tpu's scores for the same
  params, elites in the leading slots, pad lanes never parents, one seed
  one population; ``ParametricEvolution(mesh=)`` likewise, with its
  checkpoint and ``init_from_weights``;
- ``make_sharded_code_eval`` with ``seg_steps`` 0 and 3 against fks_tpu's
  (tests/test_vm_batch.py:136), and ``CodeEvaluator(mesh=)``;
- ``make_sharded_suite_eval`` on both layouts against fks_tpu's
  (tests/test_scenarios.py:342);
- ``LayoutSpec``, ``record_layout`` with a mesh, ``mesh_layout_label``,
  ``mesh_snapshot`` and the pad/occupancy rows field by field
  (tests/test_layout.py:191-245, tests/test_obs.py:179);
- mesh-sharded serving: answers equal the plain engine's and fks_tpu's
  sharded engine's, per-lane isolation, snapshot-cache hits, no new graph
  on the warm path, the VM swap (tests/test_serve_sharded.py,
  tests/test_vm_serve.py:368-392);
- the refusals: missing cards, shard counts that do not divide, specs
  without a scenario axis, ``init_distributed`` half-specified.

Floats are held to the port's bars: 1e-9 in float64 against fks_tpu's
exact engine, rtol/atol 2e-6 for the flat and fused engines.
"""
import jax
import numpy as np
import pytest
import torch

from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.models import parametric as jpar
from fks_tpu.parallel import mesh as jmesh
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.funsearch import template, vm
from fks_tpu_torch.models import parametric
from fks_tpu_torch.obs import layout, memory, telemetry
from fks_tpu_torch.parallel import (
    Mesh, hybrid_population_mesh, init_distributed, layout_mesh,
    make_population_eval, make_sharded_code_eval, make_sharded_eval,
    make_sharded_generation_step, num_shards, pad_population, pad_stats,
    population_mesh, shard_population,
)
from fks_tpu_torch.parallel import mesh as pmesh
from fks_tpu_torch.parallel.population import occupancy_stats
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, port_workload, result_fields,
)
from tests.test_population import micro_workload as jax_micro

CPU8 = ["cpu"] * 8
TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def micro():
    jwl = jax_micro()
    return jwl, port_workload(jwl)


def pop6_best_last():
    """fks_tpu's pad-lane case (tests/test_population.py:126): six
    candidates, the last one best_fit, so its pad duplicates would win
    elite slots unless masked."""
    pop = np.array(jpar.init_population(jax.random.PRNGKey(2), 6,
                                        noise=0.3), np.float32)
    pop[5] = np.asarray(jpar.seed_weights("best_fit"))
    return pop


def fks_sharded(jwl, pop, real, engine, cfg=None, elite_k=4):
    mesh = jmesh.population_mesh()
    padded, _ = jmesh.pad_population(jax.numpy.asarray(pop), mesh)
    ev = jmesh.make_sharded_eval(jwl, mesh, cfg=cfg or JaxConfig(),
                                 elite_k=elite_k, engine=engine)
    return [np.asarray(x) for x in ev(padded, real)]


# --------------------------------------------------------------- meshes


def test_meshes_mirror_fks_tpu_shapes():
    flat = population_mesh(CPU8)
    assert flat.axis_names == ("pop",) and dict(flat.shape) == {"pop": 8}
    hyb = hybrid_population_mesh(CPU8, num_slices=2)
    jhyb = jmesh.hybrid_population_mesh(num_slices=2)
    assert hyb.axis_names == jhyb.axis_names
    assert dict(hyb.shape) == dict(jhyb.shape)
    lay = layout_mesh(CPU8, scenario_shards=2)
    jlay = jmesh.layout_mesh(jax.devices(), scenario_shards=2)
    assert lay.axis_names == jlay.axis_names
    assert dict(lay.shape) == dict(jlay.shape)
    for m, jm in ((flat, jmesh.population_mesh()), (hyb, jhyb), (lay, jlay)):
        assert num_shards(m) == jmesh.num_shards(jm)
        assert memory.mesh_layout_label(m) == \
            __import__("fks_tpu.obs.memory", fromlist=["x"]) \
            .mesh_layout_label(jm)
    assert layout_mesh(CPU8, 1).axis_names == ("pop",)
    assert memory.mesh_layout_label(None) == ""


def test_mesh_refusals():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="does not exist"):
        population_mesh([f"cuda:{have}"])
    with pytest.raises(ValueError, match="CUDA devices"):
        pmesh.cuda_devices(have + 1)
    with pytest.raises(ValueError, match="slices"):
        hybrid_population_mesh(["cpu"] * 6, num_slices=4)
    with pytest.raises(ValueError, match="scenario shards"):
        layout_mesh(["cpu"] * 6, scenario_shards=4)
    with pytest.raises(ValueError, match="2-D device grid"):
        Mesh(np.array(CPU8, dtype=object).reshape(2, 4), ("pop",))
    with pytest.raises(ValueError, match="pad_population"):
        shard_population(torch.zeros(6, 16), population_mesh(CPU8))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        make_sharded_eval(synthetic_workload(4, 8, seed=0), object())
    with pytest.raises(ValueError, match="no scenario axis"):
        make_sharded_eval(
            synthetic_workload(4, 8, seed=0), population_mesh(CPU8),
            layout=layout.LayoutSpec(shard=("candidates", "scenarios"),
                                     vmap=("candidates", "scenarios")))


def test_shard_population_order_and_placement():
    params = torch.arange(32.0).reshape(8, 4)
    parts = shard_population(params, hybrid_population_mesh(CPU8, 2))
    assert len(parts) == 8
    assert torch.equal(torch.cat(parts), params)
    prog = vm.stack_programs([vm.compile_policy(
        template.seed_policies()["best_fit"], 8, 8)] * 4)
    parts = shard_population(prog, population_mesh(["cpu"] * 2))
    assert [p.opcode.shape[0] for p in parts] == [2, 2]


def test_init_distributed_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 1  # auto-detection: no cluster
    with pytest.raises(ValueError, match="together"):
        init_distributed("localhost:1", num_processes=2)


# ------------------------------------------------------------ sharded eval


@pytest.mark.parametrize("engine", ["exact", "flat", "fused"])
def test_sharded_eval_matches_fks_tpu(micro, engine):
    jwl, wl = micro
    pop = pop6_best_last()
    f64 = engine == "exact"
    jcfg = JaxConfig(score_dtype=jax.numpy.float64) if f64 else JaxConfig()
    cfg = SimConfig(score_dtype=torch.float64) if f64 else SimConfig()
    want_s, want_i, want_e = fks_sharded(jwl, pop, 6, engine, jcfg)
    mesh = population_mesh(CPU8)
    padded, real = pad_population(torch.from_numpy(pop), mesh)
    assert padded.shape[0] == 8 and real == 6
    ev = make_sharded_eval(wl, mesh, cfg=cfg, elite_k=4, engine=engine)
    scores, idx, elite = ev(padded, real)
    tol = dict(rtol=0, atol=1e-9) if f64 else TOL
    np.testing.assert_allclose(scores.numpy(), want_s, **tol)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_allclose(elite.numpy(), want_e, **tol)
    assert bool((idx < real).all()) and len(set(idx.tolist())) == 4
    # the sharded lanes are the unsharded eval's, bit for bit
    alone = make_population_eval(wl, cfg=cfg, engine=engine,
                                 device="cpu")(padded)
    assert_result_matches(ev.results(padded), result_fields(alone),
                          rtol=0, atol=0)


def test_hybrid_mesh_matches_flat_mesh(micro):
    jwl, wl = micro
    pop = torch.from_numpy(np.array(jpar.init_population(
        jax.random.PRNGKey(0), 8, noise=0.2), np.float32))
    flat = make_sharded_eval(wl, population_mesh(CPU8), elite_k=4)(pop)
    hyb = make_sharded_eval(wl, hybrid_population_mesh(CPU8, 2),
                            elite_k=4)(pop)
    for a, b in zip(flat, hyb):
        assert torch.equal(a, b)
    ref = np.asarray(jmesh.make_sharded_eval(
        jwl, jmesh.hybrid_population_mesh(num_slices=2), elite_k=4)(
        jax.numpy.asarray(pop.numpy()))[1])
    np.testing.assert_array_equal(hyb[1].numpy(), ref)


def test_sharded_eval_decision_trace_rides_per_lane(micro):
    _, wl = micro
    pop = torch.from_numpy(pop6_best_last())
    cfg = SimConfig(decision_trace=True)
    padded, real = pad_population(pop, 4)
    out = make_sharded_eval(wl, population_mesh(["cpu"] * 4), cfg=cfg,
                            elite_k=2)(padded, real)
    assert len(out) == 4
    alone = make_population_eval(wl, cfg=cfg, device="cpu")(padded)
    for a, b in zip((out[3].data, out[3].scores, out[3].count),
                    (alone.trace.data, alone.trace.scores,
                     alone.trace.count)):
        assert torch.equal(a, b)
    assert torch.equal(out[0], alone.policy_score)


# ------------------------------------------------------- generation step


def test_generation_step_invariants(micro):
    jwl, wl = micro
    pop = torch.from_numpy(pop6_best_last())
    mesh = population_mesh(["cpu"] * 4)
    padded, real = pad_population(pop, mesh)
    step = make_sharded_generation_step(wl, mesh, elite_k=3, noise=0.05)
    new, scores, elite = step(padded, 11, real)
    # fks_tpu's evaluation of the same params
    jres = jax.jit(lambda p: __import__(
        "fks_tpu.parallel.population", fromlist=["x"]).make_population_eval(
        jwl)(p))(jax.numpy.asarray(padded.numpy()))
    np.testing.assert_allclose(scores.numpy(),
                               np.asarray(jres.policy_score), **TOL)
    top = pmesh.top_k_real(scores, real, 3)[1]
    assert bool((top < real).all())  # pad lanes never become parents
    assert torch.equal(new[:3], padded[top])  # elites lead
    assert new.shape == padded.shape
    again, _, _ = step(padded, 11, real)
    other, _, _ = step(padded, 12, real)
    assert torch.equal(again, new) and not torch.equal(other, new)
    # offspring are elites plus noise: every row sits near some elite
    dist = torch.cdist(new[3:], padded[top]).min(dim=1).values
    assert bool((dist < 1.0).all())


def test_parametric_evolution_on_a_mesh(micro, tmp_path):
    from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution

    _, wl = micro
    mesh = population_mesh(["cpu"] * 4)

    def make():
        return ParametricEvolution(wl, pop_size=6, elite_k=2, seed=3,
                                   engine="flat", mesh=mesh)

    pe = make()
    assert pe.params.shape == (8, 16) and pe.real_count == 6
    assert pe.device == torch.device("cpu")
    before = pe.params.clone()
    scores = pe.eval(before).policy_score
    pe.run(1)
    lead = pmesh.top_k_real(scores, 6, 2)[1]
    assert torch.equal(pe.params[:2], before[lead])
    full = make()
    full.run(3)
    bests = [h.best_score for h in full.history]
    assert all(b >= a for a, b in zip(bests, bests[1:]))
    half = make()
    half.run(2)
    resumed = make()
    resumed.restore_checkpoint(half.save_checkpoint(str(tmp_path / "pe")))
    resumed.run(1)
    assert torch.equal(resumed.params, full.params)
    assert resumed.real_count == 6
    w = parametric.seed_weights("best_fit")
    resumed.init_from_weights(w, 0.05, seed=1)
    assert resumed.params.shape == (8, 16) and resumed.real_count == 6
    assert torch.equal(resumed.params[0], w)


# ------------------------------------------------------------ code eval


def _corpus(n, c):
    codes = list(template.seed_policies().values()) + [
        template.fill_template(lg) for lg in (
            "score = node.cpu_milli_left - pod.cpu_milli",
            "score = pod.cpu_milli - node.cpu_milli_left",
            "score = node.memory_mib_left - pod.memory_mib",
            "score = 1000")]
    return codes[:n], [vm.compile_policy(code, c.n_padded, c.g_padded)
                       for code in codes[:n]]


@pytest.mark.parametrize("seg_steps", [0, 3])
def test_sharded_code_eval_matches_fks_tpu(micro, seg_steps):
    from fks_tpu.funsearch import vm as jvm

    jwl, wl = micro
    codes, progs = _corpus(6, wl.cluster)
    mesh = population_mesh(CPU8)
    padded, real = pad_population(vm.stack_programs(progs), mesh)
    assert real == 6 and padded.opcode.shape[0] == 8
    ev = make_sharded_code_eval(wl, mesh, cfg=SimConfig(
        score_dtype=torch.float64), elite_k=3, engine="flat",
        seg_steps=seg_steps)
    res, idx, elite = ev(padded, real)
    jc = jwl.cluster
    jstack = jvm.stack_programs([jvm.compile_policy(code, jc.n_padded,
                                                    jc.g_padded)
                                 for code in codes])
    jmesh_ = jmesh.population_mesh()
    jpadded, _ = jmesh.pad_population(jstack, jmesh_)
    jres, jidx, jelite = jmesh.make_sharded_code_eval(
        jwl, jmesh_, cfg=JaxConfig(score_dtype=jax.numpy.float64),
        elite_k=3, engine="flat", seg_steps=seg_steps)(jpadded, real)
    np.testing.assert_allclose(res.policy_score.numpy()[:real],
                               np.asarray(jres.policy_score)[:real],
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(elite.numpy(), np.asarray(jelite),
                               rtol=0, atol=1e-9)
    assert bool((idx < real).all())


@pytest.mark.parametrize("double_buffer", [True, False])
def test_segment_loop_is_shared_by_flat_and_the_mesh(micro, double_buffer):
    """Flat's segmented runner and the sharded segmented code eval run one
    segment loop (``sim.flat.run_segments``): on 1 and 4 shards the code
    eval gives the unsegmented scores and dispatches as many segments as
    flat's runner, double-buffered or not."""
    from fks_tpu_torch.sim import flat

    _, wl = micro
    _, progs = _corpus(4, wl.cluster)
    stacked = vm.stack_programs(progs)
    cfg = SimConfig(score_dtype=torch.float64)
    state0 = flat.initial_state(wl, cfg)
    want = flat.make_population_run_fn(wl, vm.score_static, cfg)(
        stacked, state0).policy_score
    ticks = []
    run = flat.make_segmented_population_run(
        wl, vm.score_static, cfg, seg_steps=3,
        on_segment=lambda: ticks.append("flat"),
        double_buffer=double_buffer)
    assert torch.equal(run(stacked, state0).policy_score, want)
    segments = len(ticks)
    # double-buffered, the loop runs one segment past the draining one
    assert segments >= (2 if double_buffer else 1)
    for shards in (1, 4):
        ticks.clear()
        ev = make_sharded_code_eval(
            wl, population_mesh(["cpu"] * shards), cfg=cfg, engine="flat",
            seg_steps=3, on_segment=lambda: ticks.append(shards),
            double_buffer=double_buffer)
        res, _, _ = ev(stacked)
        assert torch.equal(res.policy_score, want)
        assert len(ticks) == segments


def test_without_a_mesh_one_shard_runs_the_same_path(serve_pair, micro):
    """``ServeEngine`` and ``CodeEvaluator`` without a mesh run a one-shard
    mesh over their device: one graph per program, the code eval's
    graphs per shard, and the same answers as a one-shard mesh passed in."""
    from fks_tpu_torch.funsearch.backend import CodeEvaluator
    from fks_tpu_torch.serve import ServeEngine

    plain, _ = serve_pair
    assert plain.mesh is None and plain._shards == 1
    queries = [_query(40 + i) for i in range(3)]
    got = plain.answer_batch(queries)
    assert all(len(prog.graphs) == 1 for prog in plain._graphs.values())
    meshed = ServeEngine(plain.champion, synthetic_workload(8, 16, seed=0),
                         envelope=plain.envelope, engine="flat",
                         mesh=population_mesh(["cpu"]))
    assert meshed.answer_batch(queries) == got
    _, wl = micro
    codes, _ = _corpus(5, wl.cluster)
    ev = CodeEvaluator(wl, vm_batch=True, device="cpu")
    assert ev._n_shards == 1
    scores = [r.score for r in ev.evaluate(codes)]
    assert len(ev._vm_pop_run.graphs) == 1 and ev.vm_batch_count == 1
    one = CodeEvaluator(wl, vm_batch=False, device="cpu")
    assert scores == [r.score for r in one.evaluate(codes)]


def test_code_evaluator_on_a_mesh(micro):
    from fks_tpu_torch.funsearch.backend import CodeEvaluator

    _, wl = micro
    codes, _ = _corpus(5, wl.cluster)
    sharded = CodeEvaluator(wl, mesh=population_mesh(["cpu"] * 2))
    assert sharded.vm_batch and sharded.device == torch.device("cpu")
    single = CodeEvaluator(wl, vm_batch=False, device="cpu")
    a, b = sharded.evaluate(codes), single.evaluate(codes)
    assert [r.score for r in a] == [r.score for r in b]
    assert sharded.vm_batch_count == 1 and sharded.vm_batch_fallbacks == 0


# ----------------------------------------------------------- suite eval


@pytest.mark.parametrize("layout_name", ["candidates", "scenarios"])
def test_sharded_suite_eval_matches_fks_tpu(layout_name):
    from fks_tpu.obs.layout import LayoutSpec as JaxSpec
    from fks_tpu.scenarios import RobustConfig as JaxRobust
    from fks_tpu.scenarios import get_suite as jax_get_suite
    from fks_tpu.scenarios import make_sharded_suite_eval as jax_sharded
    from fks_tpu_torch.scenarios import (
        RobustConfig, get_suite, make_sharded_suite_eval, make_suite_eval,
    )

    base = dict(num_nodes=4, num_pods=24, seed=3)
    suite = get_suite("smoke3", synthetic_workload(**base))
    jsuite = jax_get_suite("smoke3", jax_synthetic(**base))
    pop = np.array(jpar.init_population(jax.random.PRNGKey(1), 8,
                                        noise=0.3), np.float32)
    rc = RobustConfig(aggregation="cvar", cvar_alpha=0.5)
    jrc = JaxRobust(aggregation="cvar", cvar_alpha=0.5)
    if layout_name == "scenarios":
        # 3 scenarios over 3 scenario shards: a (pop, scn) = (2, 3) mesh
        spec = dict(shard=("candidates", "scenarios"),
                    vmap=("candidates", "scenarios"))
        mesh = layout_mesh(["cpu"] * 6, scenario_shards=3)
        jm = jmesh.layout_mesh(jax.devices()[:6], scenario_shards=3)
        lay, jlay = layout.LayoutSpec(**spec), JaxSpec(**spec)
    else:
        mesh, jm = population_mesh(CPU8), jmesh.population_mesh()
        lay = jlay = None
    robust, per, idx, elite = make_sharded_suite_eval(
        suite, mesh, rc=rc, elite_k=3, layout=lay)(torch.from_numpy(pop))
    jr, jper, jidx, jelite = jax_sharded(jsuite, jm, rc=jrc, elite_k=3,
                                         layout=jlay)(pop, 8)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), **TOL)
    np.testing.assert_allclose(robust.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(elite.numpy(), np.asarray(jelite), **TOL)
    # and the port's unsharded suite eval, bit for bit
    alone = make_suite_eval(suite, population=True, device="cpu")(
        torch.from_numpy(pop)).policy_score
    assert torch.equal(per, alone)


def test_sharded_suite_eval_refusals():
    from fks_tpu_torch.scenarios import get_suite, make_sharded_suite_eval

    suite = get_suite("smoke3", synthetic_workload(4, 24, seed=3))
    scn = layout.LayoutSpec(shard=("candidates", "scenarios"),
                            vmap=("candidates", "scenarios"))
    with pytest.raises(ValueError, match="no 'scn' axis"):
        make_sharded_suite_eval(suite, population_mesh(CPU8), layout=scn)
    with pytest.raises(ValueError, match="does not divide"):
        make_sharded_suite_eval(suite, layout_mesh(CPU8, 2), layout=scn)
    with pytest.raises(ValueError, match="does not shard scenarios"):
        make_sharded_suite_eval(suite, layout_mesh(CPU8, 2))


# ------------------------------------------------- layouts and telemetry


class Rec:
    enabled = True

    def __init__(self):
        self.events, self.metrics = [], []

    def event(self, kind, **f):
        self.events.append({"kind": kind, **f})

    def metric(self, kind, *a, **f):
        self.metrics.append({"kind": kind, **(a[0] if a else {}), **f})


def test_layout_spec_matches_fks_tpu():
    from fks_tpu.obs import layout as jl

    for scen in (False, True):
        for seg in (0, 64):
            assert layout.default_spec(scenarios=scen, seg_steps=seg).key \
                == jl.default_spec(scenarios=scen, seg_steps=seg).key
    spec = layout.LayoutSpec(shard=["scenarios", "candidates"],
                             vmap=("scenarios", "candidates"), seg_steps=8)
    jspec = jl.LayoutSpec(shard=["scenarios", "candidates"],
                          vmap=("scenarios", "candidates"), seg_steps=8)
    assert spec.key == jspec.key and spec.describe() == jspec.describe()
    assert layout.parse_layout_key(spec.key).key == spec.key
    assert layout.parse_layout_key(spec.key).describe() == \
        jl.parse_layout_key(spec.key).describe()
    assert layout.DEFAULT_LAYOUT_KEY == jl.default_spec().key
    for bad in (dict(shard=("scenarios",)), dict(shard=("segments",)),
                dict(vmap=()), dict(seg_steps=-1),
                dict(shard=("candidates", "nope"))):
        with pytest.raises(ValueError):
            layout.LayoutSpec(**bad)
        with pytest.raises(ValueError):
            jl.LayoutSpec(**bad)
    fn = layout.tag_layout(lambda: 0, spec.key)
    assert fn._fks_layout_key == spec.key


def test_record_layout_with_a_mesh_matches_fks_tpu():
    from fks_tpu.obs import layout as jl

    layout.LEDGER.clear()
    jl.LEDGER.clear()
    rec, jrec = Rec(), Rec()
    spec = layout.default_spec(scenarios=True)
    jspec = jl.default_spec(scenarios=True)
    for mesh, jm, real in (
            (population_mesh(CPU8), jmesh.population_mesh(), 6),
            (hybrid_population_mesh(CPU8, 2),
             jmesh.hybrid_population_mesh(num_slices=2), 5),
            (layout_mesh(CPU8, 2), jmesh.layout_mesh(jax.devices(), 2), 3)):
        got = layout.record_layout("suite_eval", spec, mesh=mesh,
                                   workload_key="w", real_count=real,
                                   scenarios=8, recorder=rec)
        want = jl.record_layout("suite_eval", jspec, mesh=jm,
                                workload_key="w", real_count=real,
                                scenarios=8, recorder=jrec)
        assert got == want
        assert layout.record_layout("suite_eval", spec, mesh=mesh,
                                    workload_key="w", real_count=real,
                                    scenarios=8, recorder=rec) is None
    assert rec.metrics == jrec.metrics
    layout.LEDGER.clear()
    jl.LEDGER.clear()


def test_mesh_snapshot_and_pad_rows_match_fks_tpu():
    from fks_tpu import obs as jobs

    for mesh, jm in ((population_mesh(CPU8), jmesh.population_mesh()),
                     (hybrid_population_mesh(CPU8, 2),
                      jmesh.hybrid_population_mesh(num_slices=2))):
        for real in (None, 0, 5, 8, 13):
            assert telemetry.mesh_snapshot(mesh, real) == \
                jobs.mesh_snapshot(jm, real)
        for real in (0, 5, 8, 13):
            assert pad_stats(real, mesh) == jmesh.pad_stats(real, jm)
            assert occupancy_stats(real, mesh, 3, 2) == \
                jmesh.occupancy_stats(real, jm, 3, 2)
    rec = Rec()
    snap = telemetry.record_mesh(population_mesh(CPU8), 5, recorder=rec)
    assert rec.events == [{"kind": "mesh", **snap}]
    assert snap["pad_lanes"] == 3


# -------------------------------------------------------------- serving


def _query(i, n=3):
    return [{"cpu_milli": 10 + 7 * i + j, "memory_mib": 50 + 11 * j,
             "creation_time": j, "duration_time": 40} for j in range(n)]


@pytest.fixture(scope="module")
def serve_pair():
    from fks_tpu_torch.serve import ChampionSpec, ServeEngine, ShapeEnvelope

    wl = synthetic_workload(8, 16, seed=0)
    champ = ChampionSpec(code=template.fill_template("score = 1000"),
                         score=0.5)
    env = ShapeEnvelope(max_pods=8, min_pod_bucket=8, max_batch=2,
                        max_gpu_milli=1000)
    plain = ServeEngine(champ, wl, envelope=env, engine="flat",
                        device="cpu")
    sharded = ServeEngine(champ, wl, envelope=env, engine="flat",
                          mesh=population_mesh(CPU8), state_pack=True)
    return plain, sharded


def test_sharded_serving_matches_plain_and_fks_tpu(serve_pair):
    from fks_tpu.serve import ChampionSpec as JChamp
    from fks_tpu.serve import ServeEngine as JServe
    from fks_tpu.serve import ShapeEnvelope as JEnv

    plain, sharded = serve_pair
    assert sharded._shards == 8 and sharded.device == torch.device("cpu")
    queries = [_query(i) for i in range(4)]
    a, b = plain.answer_batch(queries), sharded.answer_batch(queries)
    jeng = JServe(JChamp(code=template.fill_template("score = 1000"),
                         score=0.5), jax_synthetic(8, 16, seed=0),
                  envelope=JEnv(max_pods=8, min_pod_bucket=8, max_batch=2,
                                max_gpu_milli=1000),
                  engine="flat", mesh=jmesh.population_mesh(),
                  state_pack=True)
    c = jeng.answer_batch(queries)
    for pa, pb, pc in zip(a, b, c):
        assert pa["score"] == pb["score"]
        assert pa["placements"] == pb["placements"] == pc["placements"]
        assert pb["score"] == pytest.approx(pc["score"], abs=2e-6)
        assert pb["bucket_lanes"] == pc["bucket_lanes"] == 8
    for q, ans in zip(queries[:2], b):
        ref = sharded.reference_answer(q)
        assert ans["placements"] == ref["placements"]
        assert ans["score"] == ref["score"]


def test_sharded_serving_isolation_cache_and_warm_path(serve_pair):
    _, sharded = serve_pair
    queries = [_query(20 + i) for i in range(4)]
    together = sharded.answer_batch(queries)
    alone = [sharded.answer_batch([q])[0] for q in queries]
    for t, s in zip(together, alone):
        assert t["score"] == s["score"]
        assert t["placements"] == s["placements"]
    graphs = len(sharded._graphs)
    s0 = sharded.snapshot_cache_stats()
    sharded.answer_batch(queries)
    s1 = sharded.snapshot_cache_stats()
    assert len(sharded._graphs) == graphs  # the warm path builds nothing
    assert s1["hits"] > s0["hits"] and s1["misses"] == s0["misses"]
    prog = sharded.compiled_for(8, 8)
    assert len(prog.graphs) == 8 and all(g.lanes == 1 for g in prog.graphs)
    assert sharded.warmup() == len(sharded._graphs)


def test_sharded_vm_serving_swaps_in_every_shard():
    from fks_tpu_torch.serve import ChampionSpec, ShapeEnvelope, VMServeEngine
    from fks_tpu_torch.serve.service import selftest

    wl = synthetic_workload(8, 16, seed=0)
    env = ShapeEnvelope(max_pods=8, min_pod_bucket=8, max_batch=2,
                        max_gpu_milli=1000)
    a = ChampionSpec(code=template.fill_template(
        "score = node.cpu_milli_left - pod.cpu_milli"), score=0.4)
    b = ChampionSpec(code=template.fill_template(
        "score = pod.cpu_milli - node.cpu_milli_left"), score=0.9)
    eng = VMServeEngine(a, wl, envelope=env, engine="flat",
                        mesh=population_mesh(["cpu"] * 4))
    st = selftest(eng, count=4, pods_per_query=3)
    assert st["ok"] and st["max_drift"] == 0.0 and st["mesh_devices"] == 4
    queries = [_query(i) for i in range(6)]
    before = eng.answer_batch(queries)
    graphs = len(eng._graphs)
    assert eng.swap_program(b).code == a.code
    swapped = eng.answer_batch(queries)
    fresh = VMServeEngine(b, wl, envelope=env, engine="flat",
                          device="cpu").answer_batch(queries)
    assert [x["placements"] for x in swapped] == \
        [x["placements"] for x in fresh]
    assert [x["placements"] for x in swapped] != \
        [x["placements"] for x in before]
    eng.swap_program(a)
    assert [x["placements"] for x in eng.answer_batch(queries)] == \
        [x["placements"] for x in before]
    assert len(eng._graphs) == graphs  # swaps build no graph


def test_sharded_serve_fns_split_and_join():
    mesh = population_mesh(["cpu"] * 2)
    sh = pmesh.serve_sharding(mesh)
    assert pmesh.serve_lane_count(4, mesh) == 8
    assert pmesh.serve_lane_count(4) == 4
    x = torch.arange(8)
    parts = sh.split(x)
    calls = []

    def serve_fn(s, prog, a):
        calls.append((s, prog))
        return a * 10

    fn = pmesh.make_sharded_vm_serve_fn(serve_fn, mesh)
    assert fn._fks_layout_key == layout.DEFAULT_LAYOUT_KEY
    assert torch.equal(fn(["p0", "p1"], parts).result(), x * 10)
    assert calls == [(0, "p0"), (1, "p1")]
    with pytest.raises(ValueError, match="one value per shard"):
        fn(["p0"], parts)
    with pytest.raises(ValueError, match="do not split"):
        sh.split(torch.arange(5))


def test_load_onto_a_mesh_and_cli_devices(serve_pair, tmp_path, capsys):
    """``ServeEngine.load(mesh=)`` rebuilds a saved engine sharded (the
    mesh is the loading process's, never saved), and ``cli serve --cpu
    --devices N`` serves on N logical CPU shards."""
    import json

    from fks_tpu_torch import cli
    from fks_tpu_torch.serve import ServeEngine

    plain, _ = serve_pair
    plain.save(str(tmp_path))
    loaded = ServeEngine.load(str(tmp_path),
                              mesh=population_mesh(["cpu"] * 2))
    assert loaded._shards == 2
    queries = [_query(40 + i) for i in range(3)]
    for a, b in zip(loaded.answer_batch(queries),
                    plain.answer_batch(queries)):
        assert a["placements"] == b["placements"] and a["score"] == b["score"]
    assert cli.main(["serve", "--cpu", "--devices", "2", "--artifact",
                     str(tmp_path), "--selftest", "2",
                     "--pods-per-query", "3"]) == 0
    out = capsys.readouterr().out
    result = json.loads(out[out.index("{"):])
    assert result["ok"] and result["mesh_devices"] == 2
