"""The large-cluster tier of fks_tpu_torch vs fks_tpu's
(tests/test_scale_tier.py, every case that is not a jaxpr pin).

- ``SimConfig.resolve_prefilter_k``, ``segment_budget`` and
  ``validate_seg_steps`` answer and word their errors as fks_tpu's;
- the fused engine refuses both scale knobs with fks_tpu's messages;
- ``prefilter_candidates`` picks fks_tpu's candidates (the first k
  feasible nodes, cordoned and padding nodes never), ``gather_node_view``
  gathers its shapes;
- prefiltered runs equal fks_tpu's on the default trace and on a faulted
  ``smoke3`` scenario, in both engines, and equal the dense sweep for
  first_fit;
- ``state_pack`` narrows the flat state and changes no result bit;
- trace rows carry the global node index; numeric flags survive the
  prefilter;
- the segmented runner equals the unsegmented one with the double buffer
  on and off, the prefilter holds under a population;
- ``auto_prefilter_k`` and ``resolve_auto_prefilter`` decide as fks_tpu's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.data.build import make_workload as jax_make_workload
from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.models import parametric as jparametric
from fks_tpu.models import zoo as jzoo
from fks_tpu.scenarios import get_suite as jax_get_suite
from fks_tpu.sim import engine as jengine
from fks_tpu.sim import flat as jflat
from fks_tpu.sim import fused as jfused
from fks_tpu.sim.types import NodeView as JNodeView
from fks_tpu.sim.types import PodView as JPodView
from fks_tpu.utils import segments as jsegments
from fks_tpu_torch.data import TraceParser
from fks_tpu_torch.data.build import make_workload
from fks_tpu_torch.data.synthetic import synthetic_workload
from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.obs.recorder import NullRecorder
from fks_tpu_torch.scenarios import get_suite
from fks_tpu_torch.sim import engine, flat, fused
from fks_tpu_torch.sim.engine import (
    SimConfig, gather_node_view, prefilter_candidates,
)
from fks_tpu_torch.sim.types import NodeView, PodView, TraceBuffer
from fks_tpu_torch.testing import (
    INT_FIELDS, assert_golden_parity, assert_result_matches,
    one_torch_thread, port_workload, result_fields,
)
from fks_tpu_torch.utils import segments

ENGINES = [("exact", engine, jengine), ("flat", flat, jflat)]
CLEAN = parametric.seed_weights("first_fit")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def jcfg(**kw):
    return jengine.SimConfig(**kw)


def assert_identical(a, b):
    """Every integer field and the score bit for bit."""
    for f in INT_FIELDS + ("policy_score",):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ------------------------------------------------------------ config API

@pytest.mark.parametrize("k,n", [(0, 16), (8, 16), (16, 16), (64, 16),
                                 (3, 4), (64, 1000)])
def test_resolve_prefilter_k(k, n):
    want = jcfg(node_prefilter_k=k).resolve_prefilter_k(n)
    assert SimConfig(node_prefilter_k=k).resolve_prefilter_k(n) == want


def test_resolve_prefilter_k_rejects_negative():
    with pytest.raises(ValueError) as jerr:
        jcfg(node_prefilter_k=-1).resolve_prefilter_k(16)
    with pytest.raises(ValueError) as err:
        SimConfig(node_prefilter_k=-1).resolve_prefilter_k(16)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="node_prefilter_k"):
        flat.initial_state(synthetic_workload(4, 8, seed=0),
                           SimConfig(node_prefilter_k=-1))


@pytest.mark.parametrize("max_steps,seg,slack", [
    (100, 10, 1), (100, 10, 2), (101, 10, 1), (1, 4096, 1), (65216, 8192, 2)])
def test_segment_budget(max_steps, seg, slack):
    assert segments.segment_budget(max_steps, seg, slack=slack) == \
        jsegments.segment_budget(max_steps, seg, slack=slack)


@pytest.mark.parametrize("value,zero_disables", [
    ("x", True), (-1, True), (0, False), (None, False)])
def test_validate_seg_steps_messages(value, zero_disables):
    with pytest.raises(ValueError) as jerr:
        jsegments.validate_seg_steps(value, zero_disables=zero_disables)
    with pytest.raises(ValueError) as err:
        segments.validate_seg_steps(value, zero_disables=zero_disables)
    assert str(err.value) == str(jerr.value)
    assert segments.validate_seg_steps("12") == 12
    assert segments.validate_seg_steps(0) == 0


@pytest.mark.parametrize("knob", [{"node_prefilter_k": 1},
                                  {"state_pack": True}])
def test_fused_rejects_scale_knobs(micro_workload, knob):
    with pytest.raises(ValueError) as jerr:
        jfused._build_plan(micro_workload, jcfg(**knob))
    with pytest.raises(ValueError) as err:
        fused._build_plan(port_workload(micro_workload), SimConfig(**knob),
                          device="cpu")
    assert str(err.value) == str(jerr.value)


# ------------------------------------------------- candidate-list kernel

def _node_view_8(lanes=1):
    """8 nodes, 2 GPUs each; nodes 0-5 tiny (cpu 100), 6-7 roomy; node
    tables as numpy (shared by both packages)."""
    n, g = 8, 2
    cpu = np.asarray([100] * 6 + [64000] * 2, np.int32)
    mem = np.full((n,), 262144, np.int32)
    milli = np.full((n, g), 1000, np.int32)
    return dict(cpu=cpu, mem=mem, gl=np.full((n,), g, np.int32),
                milli=milli, gmem=np.full((n, g), 16384, np.int32),
                gm=np.ones((n, g), bool), nm=np.ones((n,), bool))


def _port_nodes(v, lanes):
    t = torch.from_numpy

    def per_lane(x):
        return t(x)[None].expand((lanes,) + x.shape).contiguous()

    return NodeView(per_lane(v["cpu"]), t(v["cpu"]), per_lane(v["mem"]),
                    t(v["mem"]), per_lane(v["gl"]), t(v["gl"]),
                    per_lane(v["milli"]), t(v["milli"]), t(v["gmem"]),
                    t(v["gm"]), t(v["nm"]))


def _jax_nodes(v):
    a = jnp.asarray
    return JNodeView(a(v["cpu"]), a(v["cpu"]), a(v["mem"]), a(v["mem"]),
                     a(v["gl"]), a(v["gl"]), a(v["milli"]), a(v["milli"]),
                     a(v["gmem"]), a(v["gm"]), a(v["nm"]))


PODS = [dict(cpu=50), dict(cpu=4000), dict(cpu=999999),
        dict(cpu=50, num_gpu=2, gpu_milli=500),
        dict(cpu=50, num_gpu=3, gpu_milli=500)]


def _pods(pods):
    cols = [[p.get("cpu", 4000), 1024, p.get("num_gpu", 0),
             p.get("gpu_milli", 0), 0, 10] for p in pods]
    port = PodView(*(torch.tensor(c, dtype=torch.int32)[:, None]
                     for c in zip(*cols)))
    jax = [JPodView(*(jnp.int32(x) for x in c)) for c in cols]
    return port, jax


@pytest.mark.parametrize("cordon", [(), (0, 6)])
def test_prefilter_candidates_first_k_feasible(cordon):
    """Lane l holds pod l: candidates equal fks_tpu's (first k feasible in
    ascending index, short lists repeat the first, none feasible -> node
    0), and a cordoned node never enters a slot."""
    v = _node_view_8()
    place = np.ones(8, bool)
    place[list(cordon)] = False
    pod, jpods = _pods(PODS)
    nodes = _port_nodes(v, len(PODS))
    got = prefilter_candidates(pod, nodes, torch.from_numpy(place), 4)
    for lane, jp in enumerate(jpods):
        want = np.asarray(jengine._prefilter_candidates(
            jp, _jax_nodes(v), jnp.asarray(place), 4))
        np.testing.assert_array_equal(got[lane].numpy(), want, err_msg=lane)
    assert not set(got[:2].flatten().tolist()) & set(cordon)
    if cordon:
        assert got[1].tolist() == [7, 7, 7, 7]
    else:
        assert got[0].tolist() == [0, 1, 2, 3]
        assert got[1].tolist() == [6, 7, 6, 6]
    assert got[2].tolist() == [0, 0, 0, 0]


def test_gather_node_view_shapes():
    v = _node_view_8()
    nodes = _port_nodes(v, 2)
    cand = torch.tensor([[6, 7, 6], [1, 2, 3]])
    sub = gather_node_view(nodes, cand)
    jsub = jengine._gather_node_view(_jax_nodes(v), jnp.asarray([6, 7, 6]))
    for name, x, jx in zip(NodeView._fields, sub, jsub):
        assert tuple(x.shape[1:]) == jx.shape, name
        np.testing.assert_array_equal(x[0].numpy(), np.asarray(jx),
                                      err_msg=name)
    assert sub.cpu_milli_left[1].tolist() == [100, 100, 100]


# ------------------------------------------------------- parity: default

@pytest.mark.slow
def test_prefilter_parity_default_trace(golden_default, default_workload):
    """k = 8 on the full default trace (16 nodes: the filter really
    filters): the exact engine holds the golden first_fit pins in float64,
    the flat engine equals fks_tpu's flat k = 8 run field by field; k = 64
    >= 16 is the dense sweep. About a minute on one CPU thread, so slow;
    the fast tier holds the first 768 pods below."""
    wl = port_workload(default_workload)
    f64 = SimConfig(node_prefilter_k=8, score_dtype=torch.float64)
    ex = engine.simulate(wl, zoo.ZOO["first_fit"](torch.float64), f64,
                         device="cpu")
    assert_golden_parity(ex, golden_default["policies"]["first_fit"], wl)
    policy = zoo.ZOO["first_fit"]()
    cfg = SimConfig(node_prefilter_k=8)
    fl = flat.simulate(wl, policy, cfg, device="cpu")
    ref = jflat.simulate(default_workload, jzoo.ZOO["first_fit"](),
                         jcfg(node_prefilter_k=8))
    assert_result_matches(fl, result_fields(ref))
    assert SimConfig(node_prefilter_k=64).resolve_prefilter_k(
        wl.cluster.n_padded) == 0


@pytest.mark.parametrize("name,mod,jmod", ENGINES)
def test_prefilter_parity_default_prefix(name, mod, jmod):
    """k = 3 on the first 768 pods of the default trace equals the dense
    sweep and fks_tpu's prefiltered run."""
    wl = TraceParser().parse_workload(max_pods=768)
    jwl = jax_make_workload_prefix(768)
    policy = zoo.ZOO["first_fit"]()
    dense = mod.simulate(wl, policy, SimConfig(), device="cpu")
    got = mod.simulate(wl, policy, SimConfig(node_prefilter_k=3),
                       device="cpu")
    assert_identical(got, dense)
    ref = jmod.simulate(jwl, jzoo.ZOO["first_fit"](),
                        jcfg(node_prefilter_k=3))
    assert_result_matches(got, result_fields(ref))


def jax_make_workload_prefix(max_pods):
    """fks_tpu's default workload cut to its first pod rows, as the port's
    ``TraceParser.parse_workload(max_pods=...)`` cuts them (before any
    array is made)."""
    from fks_tpu.data.traces import TraceParser as JaxParser

    class Prefix(JaxParser):
        @staticmethod
        def _read_csv(path):
            rows = JaxParser._read_csv(path)
            return rows[:max_pods] if "pod_list" in str(path) else rows

    return Prefix().parse_workload()


# ------------------------------------------------------- parity: faulted

@pytest.mark.parametrize("name,mod,jmod", ENGINES)
def test_prefilter_parity_faulted_smoke3(name, mod, jmod):
    """Cordon events flow through place_mask into the prefilter: k in {1,
    2} on smoke3's fault1 equals the dense sweep and fks_tpu."""
    suite = get_suite("smoke3", synthetic_workload(4, 24, seed=3))
    jsuite = jax_get_suite("smoke3", jax_synthetic(4, 24, seed=3))
    assert suite.names[2] == "fault1"
    wl, jwl = suite.workloads[2], jsuite.workloads[2]
    policy = zoo.ZOO["first_fit"]()
    dense = mod.simulate(wl, policy, SimConfig(), device="cpu")
    for k in (1, 2):
        got = mod.simulate(wl, policy, SimConfig(node_prefilter_k=k),
                           device="cpu")
        ref = jmod.simulate(jwl, jzoo.ZOO["first_fit"](),
                            jcfg(node_prefilter_k=k))
        assert_result_matches(got, result_fields(ref))
        assert_identical(got, dense)


# ----------------------------------------------------------- state_pack

@pytest.mark.parametrize("policy", ["best_fit", "first_fit"])
def test_state_pack_bit_identical(policy):
    """Packed dtypes are exact integer narrowing: every observable equals
    the unpacked run bit for bit (dtypes included) and fks_tpu's."""
    wl = synthetic_workload(8, 60, seed=2)
    a = flat.simulate(wl, zoo.ZOO[policy](), SimConfig(), device="cpu")
    b = flat.simulate(wl, zoo.ZOO[policy](), SimConfig(state_pack=True),
                      device="cpu")
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if va is None:
            assert vb is None
            continue
        assert va.dtype == vb.dtype and torch.equal(va, vb), f.name
    ref = jflat.simulate(jax_synthetic(8, 60, seed=2), jzoo.ZOO[policy](),
                         jcfg(state_pack=True))
    assert_result_matches(b, result_fields(ref))


def test_state_pack_unpacked_aux():
    """A node axis too wide to pack (node bits + G > 31) keeps the GPU
    bits in ``aux_gpus`` (here G = 32, so it stays 64-bit wide): packed
    and unpacked runs agree bit for bit, and with fks_tpu."""
    nodes = [{"node_id": f"n{i}", "cpu_milli": 8000, "memory_mib": 65536,
              "gpus": [1000] * 2} for i in range(3)]
    pods = [{"pod_id": f"p{i}", "cpu_milli": 500, "memory_mib": 512,
             "num_gpu": 1 + i % 2, "gpu_milli": 600, "creation_time": i,
             "duration_time": 7} for i in range(20)]
    wl = make_workload(nodes, pods, pad_gpus_to=32, pad_pods_to=32)
    jwl = jax_make_workload(nodes, pods, pad_gpus_to=32, pad_pods_to=32)
    assert not flat._packable(wl.cluster.n_padded, wl.cluster.g_padded)
    s = flat.initial_state(wl, SimConfig(state_pack=True))
    assert s.aux_gpus is not None and s.aux_gpus.dtype == torch.int64
    assert s.aux.dtype == torch.int16  # a bare node index fits
    a = flat.simulate(wl, zoo.ZOO["best_fit"](), SimConfig(), device="cpu")
    b = flat.simulate(wl, zoo.ZOO["best_fit"](), SimConfig(state_pack=True),
                      device="cpu")
    assert_identical(a, b)
    ref = jflat.simulate(jwl, jzoo.ZOO["best_fit"](), jcfg(state_pack=True))
    assert_result_matches(b, result_fields(ref))


def test_packed_gpu_bits_widen():
    """A 16-bit GPU mask column stores uint16 bit patterns in int16 (G <=
    16, fks_tpu's uint16): widening recovers every bit, bit 15 included."""
    bits = torch.tensor([0, 1, 0x8000, 0xFFFF, 0x8001], dtype=torch.int64)
    stored = bits.to(torch.int16)
    assert stored.tolist()[2] < 0
    assert flat._wide_bits(stored).tolist() == bits.tolist()
    an, ag = flat.decode_assignment(torch.tensor([[3, -1, 0, 2, 1]]),
                                    stored[None], 16, packed=False)
    assert ag.tolist() == [[0, 0, 0x8000, 0xFFFF, 0x8001]]
    assert an.tolist() == [[3, -1, 0, 2, 1]]


def test_state_pack_narrows_state():
    wl = synthetic_workload(8, 60, seed=2)
    s = flat.initial_state(wl, SimConfig(state_pack=True))
    js = jflat.initial_state(jax_synthetic(8, 60, seed=2),
                             jcfg(state_pack=True))
    for f in ("aux", "gpu_left", "gpu_milli_left", "wait_hist"):
        width = np.dtype(getattr(js, f).dtype).itemsize
        assert getattr(s, f).element_size() == width, f
    assert s.gpu_milli_left.dtype == torch.int16
    assert s.wait_hist.dtype == torch.int16
    s0 = flat.initial_state(wl, SimConfig())
    assert s0.gpu_milli_left.dtype == torch.int32
    assert flat.state_bytes(s) < flat.state_bytes(s0)
    # the exact engine ignores the flag, as fks_tpu's does
    ex = engine.initial_state(wl, SimConfig(state_pack=True))
    assert ex.gpu_milli_left.dtype == torch.int32


# ------------------------------------------- trace + watchdog invariants

def _skewed(builder):
    """6 tiny nodes then 2 roomy ones; pods fit only on nodes >= 6, so a
    k=2 prefilter must map the winner back to a global index >= 6."""
    nodes = [{"node_id": f"n{i}", "cpu_milli": 100, "memory_mib": 262144,
              "gpus": [], "gpu_memory_mib": 0} for i in range(6)]
    nodes += [{"node_id": f"n{i}", "cpu_milli": 64000,
               "memory_mib": 262144, "gpus": [1000] * 2,
               "gpu_memory_mib": 16384} for i in (6, 7)]
    pods = [{"pod_id": f"p{i}", "cpu_milli": 4000, "memory_mib": 1024,
             "num_gpu": 0, "gpu_milli": 0, "creation_time": i,
             "duration_time": 50} for i in range(4)]
    return builder(nodes, pods)


@pytest.mark.parametrize("name,mod,jmod", ENGINES)
def test_trace_records_global_node_index(name, mod, jmod):
    wl = _skewed(make_workload)
    cfg = SimConfig(node_prefilter_k=2, decision_trace=True)
    res = mod.simulate(wl, zoo.ZOO["first_fit"](), cfg, device="cpu")
    ref = jmod.simulate(_skewed(jax_make_workload), jzoo.ZOO["first_fit"](),
                        jcfg(node_prefilter_k=2, decision_trace=True))
    count = int(res.trace.count)
    assert count == int(ref.trace.count)
    np.testing.assert_array_equal(res.trace.data[:count].numpy(),
                                  np.asarray(ref.trace.data)[:count])
    np.testing.assert_array_equal(res.trace.scores[:count].numpy(),
                                  np.asarray(ref.trace.scores)[:count])
    data = res.trace.data[:count]
    creates = data[data[:, TraceBuffer.COL_KIND] == 0]
    assert len(creates) == 4
    assert set(creates[:, TraceBuffer.COL_NODE].tolist()) <= {6, 7}
    dense = mod.simulate(wl, zoo.ZOO["first_fit"](), SimConfig(),
                         device="cpu")
    assert torch.equal(res.assigned_node, dense.assigned_node)


@pytest.mark.parametrize("name,mod,jmod", ENGINES)
def test_numeric_flags_survive_prefilter(name, mod, jmod):
    """The watchdog sees the gathered [k] score vector: a NaN-emitting
    policy sets the same sticky flags as under the dense sweep, and as
    fks_tpu's."""
    wl = _skewed(make_workload)

    def nan_policy(pod, nodes):
        return torch.full(nodes.cpu_milli_left.shape, float("nan"))

    def jax_nan(pod, nodes):
        return jnp.full(nodes.cpu_milli_left.shape, jnp.nan, jnp.float32)

    dense = mod.simulate(wl, nan_policy, SimConfig(watchdog=True),
                         device="cpu")
    pre = mod.simulate(wl, nan_policy,
                       SimConfig(watchdog=True, node_prefilter_k=2),
                       device="cpu")
    ref = jmod.simulate(_skewed(jax_make_workload), jax_nan,
                        jcfg(watchdog=True, node_prefilter_k=2))
    assert int(dense.numeric_flags) != 0
    assert int(pre.numeric_flags) == int(dense.numeric_flags) == \
        int(ref.numeric_flags)


# ----------------------------------------- segmented runner / population

@pytest.mark.parametrize("scale", [False, True], ids=["plain", "k4-packed"])
def test_segmented_matches_unsegmented(scale):
    """The segmented runner, double-buffered or not, equals the
    unsegmented runner bit for bit, and fks_tpu's segmented run."""
    wl = synthetic_workload(8, 96, seed=4)
    kw = dict(node_prefilter_k=4, state_pack=True) if scale else {}
    cfg = SimConfig(track_ctime=False, **kw)
    params = CLEAN[None].repeat(3, 1)
    base = flat.make_population_run_fn(wl, parametric.score, cfg)(
        params, flat.initial_state(wl, cfg))
    for dbuf in (True, False):
        segments_seen = []
        run = flat.make_segmented_population_run(
            wl, parametric.score, cfg, seg_steps=32, double_buffer=dbuf,
            on_segment=lambda: segments_seen.append(1))
        seg = run(params, flat.initial_state(wl, cfg))
        assert_identical(seg, base)
        assert run.seg_steps == 32 and len(segments_seen) >= 2
    jwl = jax_synthetic(8, 96, seed=4)
    jc = jcfg(track_ctime=False, **kw)
    ref = jflat.make_segmented_population_run(
        jwl, jparametric.score, jc, seg_steps=32)(
        jnp.tile(jnp.asarray(np.asarray(CLEAN))[None], (3, 1)),
        jflat.initial_state(jwl, jc))
    assert_result_matches(base, result_fields(ref))


def test_segmented_rejects_zero_and_budget_overrun():
    wl = synthetic_workload(4, 16, seed=0)
    with pytest.raises(ValueError, match="make_population_run_fn"):
        flat.make_segmented_population_run(wl, parametric.score,
                                           seg_steps=0)

    # a predicate that never turns off (a step/predicate divergence): the
    # segment budget must stop the loop
    cfg = SimConfig(max_steps=64)
    run = flat.make_segmented_population_run(wl, parametric.score, cfg,
                                             seg_steps=16)
    real = flat.lane_active
    try:
        flat.lane_active = lambda s, m: torch.ones(s.lanes, dtype=torch.bool)
        with pytest.raises(RuntimeError, match="segment budget"):
            run(CLEAN[None], flat.initial_state(wl, cfg))
    finally:
        flat.lane_active = real


def test_prefilter_under_population():
    """A population of identical first_fit lanes scores identically with
    and without the prefilter (and packing), and as fks_tpu's."""
    wl = synthetic_workload(16, 64, seed=1)
    params = CLEAN[None].repeat(4, 1)
    dense = flat.make_population_run_fn(wl, parametric.score, SimConfig())(
        params, flat.initial_state(wl, SimConfig()))
    cfg = SimConfig(node_prefilter_k=8, state_pack=True)
    pre = flat.make_population_run_fn(wl, parametric.score, cfg)(
        params, flat.initial_state(wl, cfg))
    assert_identical(pre, dense)
    ex = engine.make_population_run_fn(wl, parametric.score, cfg)(
        params, engine.initial_state(wl, cfg))
    jwl = jax_synthetic(16, 64, seed=1)
    jc = jcfg(node_prefilter_k=8)
    ref = jengine.make_population_run_fn(jwl, jparametric.score, jc)(
        jnp.tile(jnp.asarray(np.asarray(CLEAN))[None], (4, 1)),
        jengine.initial_state(jwl, jc))
    assert_result_matches(ex, result_fields(ref))


# --------------------------------------------------- auto-prefilter

@pytest.mark.parametrize("n,cost,override", [
    (1000, 1e-3, None), (1000, 1e-5, None), (1000, None, None),
    (100, 1e-3, None), (16, 1.0, None), (1000, 1e-5, 32), (16, 1e-3, 0),
    (256, 2e-4, None), (256, 2.0001e-4, None)])
def test_auto_prefilter_k_decision_table(n, cost, override):
    assert engine.auto_prefilter_k(n, cost, override=override) == \
        jengine.auto_prefilter_k(n, cost, override=override)
    assert (engine.PREFILTER_AUTO_K, engine.PREFILTER_COST_THRESHOLD_S,
            engine.PREFILTER_MIN_NODES, engine.PREFILTER_WORK_HINT_MIN) == (
        jengine.PREFILTER_AUTO_K, jengine.PREFILTER_COST_THRESHOLD_S,
        jengine.PREFILTER_MIN_NODES, jengine.PREFILTER_WORK_HINT_MIN)


class Recorder(NullRecorder):
    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))


def test_resolve_auto_prefilter_skip_paths(monkeypatch):
    """An override, a small node axis or a cheap work hint skips the
    probe; a probed decision records a ``prefilter_auto`` event."""
    def boom(*a, **kw):
        raise AssertionError("the probe ran")

    monkeypatch.setattr(engine, "probe_policy_cost", boom)
    rec = Recorder()
    kw = dict(recorder=rec, device="cpu")
    assert engine.resolve_auto_prefilter(
        parametric.score, CLEAN, 1000, 8, override=7, **kw) == 7
    assert engine.resolve_auto_prefilter(
        parametric.score, CLEAN, 64, 8, **kw) == 0
    assert engine.resolve_auto_prefilter(
        parametric.score, CLEAN, 1000, 8, work_hint=3, **kw) == 0
    assert rec.events == [("prefilter_auto", dict(
        policy_cost_s=None, work_hint=3, chosen_k=0, n_padded=1000))]
    monkeypatch.setattr(engine, "probe_policy_cost",
                        lambda *a, **k: 5e-4)
    assert engine.resolve_auto_prefilter(
        parametric.score, CLEAN, 1000, 8, **kw) == 64
    assert rec.events[-1] == ("prefilter_auto", dict(
        policy_cost_s=5e-4, chosen_k=64, n_padded=1000))


def test_probe_policy_cost_runs_the_policy():
    calls = []

    def policy(prm, pod, nodes):
        calls.append(nodes.cpu_milli_left.shape)
        return parametric.score(prm, pod, nodes)

    cost = engine.probe_policy_cost(policy, CLEAN, 300, 4, reps=3,
                                    device="cpu")
    assert cost > 0 and len(calls) == 4 and calls[0] == (1, 300)
