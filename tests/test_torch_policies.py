"""fks_tpu_torch policies and GPU allocator vs fks_tpu, on random views.

Inputs are drawn with numpy from a seed and handed to both frameworks.
The parametric model's float32 features and raw scores must be bit
identical to fks_tpu's (one flipped ``trunc`` changes a placement), and
their truncated scores equal; in float64 the raw scores agree to 1e-9
relative and the truncated scores are equal. Views reach JAX as jit
arguments, like the engine state they model.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.models import parametric as jpar
from fks_tpu.models import zoo as jzoo
from fks_tpu.ops import allocator as jalloc
from fks_tpu.parallel.mesh import _top_k_real
from fks_tpu.sim.types import NodeView as JNodeView
from fks_tpu.sim.types import PodView as JPodView
from fks_tpu_torch.funsearch.device_evolution import top_k_real
from fks_tpu_torch.models import parametric, zoo
from fks_tpu_torch.ops import allocator
from fks_tpu_torch.ops.numerics import fma_f32
from fks_tpu_torch.sim.types import NodeView, PodView
from fks_tpu_torch.testing import random_policy_views

L, N, G = 256, 16, 8  # 4,096 node views per draw


def random_views(seed: int, gpu_heavy: bool = False):
    """numpy arrays for L lanes (one pod each) over N shared nodes: the
    draw of ``testing.random_policy_views``."""
    pod, nodes, w = random_policy_views(seed, L, N, G, gpu_heavy)
    view = dict(zip(("cpu_left", "cpu_total", "mem_left", "mem_total",
                     "gpu_left", "num_gpus", "gml", "gmt"),
                    (x.numpy() for x in nodes[:8])))
    view.update(gm=nodes.gpu_mask.numpy(), nm=nodes.node_mask.numpy())
    return view, {k: x[:, 0].numpy() for k, x in zip(
        ("cpu", "mem", "ngpu", "milli", "ctime", "dur"), pod)}, w.numpy()


def port_views(view, pod):
    t = torch.from_numpy
    nodes = NodeView(
        t(view["cpu_left"]), t(view["cpu_total"]), t(view["mem_left"]),
        t(view["mem_total"]), t(view["gpu_left"]), t(view["num_gpus"]),
        t(view["gml"]), t(view["gmt"]), t(view["gmt"]), t(view["gm"]),
        t(view["nm"]))
    pv = PodView(*(t(pod[k])[:, None] for k in
                   ("cpu", "mem", "ngpu", "milli", "ctime", "dur")))
    return pv, nodes


def jax_per_lane(fn, view, pod, *lane_args):
    """vmap ``fn(*lane_args, pod, nodes)`` over lanes; shared node totals
    are jit arguments, not constants."""
    def lane(cl, ml, gl, gml, pc, pm, pg, pmi, pct, pd, ct, mt, ng, gmt, gm,
             nm, *args):
        nodes = JNodeView(cl, ct, ml, mt, gl, ng, gml, gmt, gmt, gm, nm)
        return fn(*args, JPodView(pc, pm, pg, pmi, pct, pd), nodes)

    lanes = (view["cpu_left"], view["mem_left"], view["gpu_left"],
             view["gml"], pod["cpu"], pod["mem"], pod["ngpu"], pod["milli"],
             pod["ctime"], pod["dur"])
    shared = (view["cpu_total"], view["mem_total"], view["num_gpus"],
              view["gmt"], view["gm"], view["nm"])
    in_axes = (0,) * 10 + (None,) * 6 + (0,) * len(lane_args)
    out = jax.jit(jax.vmap(lane, in_axes=in_axes))(*lanes, *shared,
                                                   *lane_args)
    return np.asarray(out)


@pytest.mark.parametrize("seed,gpu_heavy", [(0, False), (1, True), (2, False)])
def test_parametric_float32_bit_identical(seed, gpu_heavy):
    view, pod, w = random_views(seed, gpu_heavy)
    pv, nodes = port_views(view, pod)
    f_ref = jax_per_lane(lambda p, n: jpar.features(p, n), view, pod)
    f_got = parametric.features(pv, nodes).numpy()
    assert f_got.dtype == np.float32
    np.testing.assert_array_equal(f_got.view(np.int32), f_ref.view(np.int32))

    raw_ref = jax_per_lane(
        lambda prm, p, n: jpar.features(p, n) @ prm * jpar.SCORE_SCALE,
        view, pod, w)
    raw_got = parametric.raw_score(torch.from_numpy(w), pv, nodes).numpy()
    np.testing.assert_array_equal(raw_got.view(np.int32),
                                  raw_ref.view(np.int32))

    s_ref = jax_per_lane(jpar.score, view, pod, w)
    s_got = parametric.score(torch.from_numpy(w), pv, nodes).numpy()
    np.testing.assert_array_equal(s_got, s_ref)
    assert (s_ref > 1).sum() > 500  # the comparison covers real scores


def test_parametric_float64_agrees():
    view, pod, w = random_views(3)
    pv, nodes = port_views(view, pod)
    f64 = jnp.float64
    raw_ref = jax_per_lane(
        lambda prm, p, n: jpar.features(p, n, f64) @ prm.astype(f64)
        * jpar.SCORE_SCALE, view, pod, w)
    raw_got = parametric.raw_score(torch.from_numpy(w), pv, nodes,
                                   torch.float64).numpy()
    np.testing.assert_allclose(raw_got, raw_ref, rtol=1e-9, atol=1e-9)
    s_ref = jax_per_lane(lambda prm, p, n: jpar.score(prm, p, n, f64),
                         view, pod, w)
    s_got = parametric.score(torch.from_numpy(w), pv, nodes,
                             torch.float64).numpy()
    np.testing.assert_array_equal(s_got, s_ref)


def exact_f32(q: Fraction) -> np.float32:
    """The float32 nearest to q, ties to even (no float64 detour)."""
    f = np.float32(float(q))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000))
    b = (rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000))
    c = (rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000))
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    c[:100] = -(a[:100].astype(np.float64) * b[:100]).astype(np.float32)
    # float64 sums that land exactly on a float32 tie while the exact sum
    # lies just off it (naive float64 -> float32 rounding gets these wrong)
    x = 2.0 ** -15
    for i, (sa, sc) in enumerate(((1, 1), (1, -1), (-1, 1), (-1, -1))):
        a[100 + i] = 1 + x
        b[100 + i] = sa * (1 - x) * 2.0 ** -24
        c[100 + i] = sc * (1 + 2.0 ** -23)
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([exact_f32(Fraction(float(x)) * Fraction(float(y))
                               + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", ["first_fit", "best_fit"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_zoo_matches(name, dtype):
    view, pod, _ = random_views(4)
    pv, nodes = port_views(view, pod)
    got = zoo.ZOO[name](getattr(torch, dtype))(pv, nodes).numpy()
    ref = jax_per_lane(jzoo.ZOO[name](getattr(jnp, dtype)), view, pod)
    np.testing.assert_array_equal(got, ref)
    feas = zoo.feasible_mask(pv, nodes).numpy()
    np.testing.assert_array_equal(feas, jax_per_lane(jzoo.feasible_mask,
                                                     view, pod))
    assert 0 < feas.mean() < 1


@pytest.mark.parametrize("which", ["best_fit_gpus", "first_fit_gpus"])
def test_gpu_allocators_match(which):
    rng = np.random.default_rng(6)
    rows = 4096
    milli = rng.integers(0, 1001, (rows, G)).astype(np.int32)
    milli[: rows // 2] = rng.choice([0, 250, 500, 1000], (rows // 2, G))
    mask = rng.random((rows, G)) < 0.8
    req = rng.integers(0, 1001, rows).astype(np.int32)
    num = rng.integers(0, G + 2, rows).astype(np.int32)
    sel, ok = getattr(allocator, which)(*(torch.from_numpy(x) for x in
                                          (milli, mask, req, num)))
    jsel, jok = jax.jit(jax.vmap(getattr(jalloc, which)))(milli, mask, req,
                                                          num)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("real_count,k", [(12, 4), (3, 5), (12, 12)])
def test_top_k_tie_order_matches_lax(real_count, k):
    scores = np.array([0.5, 0.7, 0.5, 0.7, 0.0, 0.7, 0.1, 0.5, 0.7, 0.0,
                       0.3, 0.7], np.float32)
    es, ei = top_k_real(torch.from_numpy(scores), real_count, k)
    jes, jei = _top_k_real(jnp.asarray(scores), real_count, k)
    np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))
    np.testing.assert_array_equal(es.numpy(), np.asarray(jes))


def test_seeds_population_and_mutation_match():
    for name in parametric.SEED_NAMES:
        np.testing.assert_array_equal(parametric.seed_weights(name).numpy(),
                                      np.asarray(jpar.seed_weights(name)))
    assert parametric.FEATURE_NAMES == jpar.FEATURE_NAMES
    assert parametric.SCORE_SCALE == jpar.SCORE_SCALE
    key = jax.random.PRNGKey(3)
    pop = 10
    z = np.array(jax.random.normal(key, (pop, 16), jnp.float32))
    np.testing.assert_array_equal(
        parametric.population_from_normal(torch.from_numpy(z), 0.1).numpy(),
        np.asarray(jpar.init_population(key, pop, noise=0.1)))
    parents = np.array(jpar.init_population(key, 4, noise=0.3))
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    idx = np.array(jax.random.randint(k1, (pop,), 0, 4))
    zz = np.array(jax.random.normal(k2, (pop, 16), jnp.float32))
    np.testing.assert_array_equal(
        parametric.mutate_from(torch.from_numpy(parents),
                               torch.from_numpy(idx), torch.from_numpy(zz),
                               0.05).numpy(),
        np.asarray(jpar.mutate(jax.random.PRNGKey(4), parents, pop, 0.05)))
    g = torch.Generator().manual_seed(0)
    p = parametric.init_population(g, pop)
    assert p.shape == (pop, 16) and p.dtype == torch.float32
    np.testing.assert_array_equal(p[:4].numpy(),
                                  np.asarray(jpar.init_population(key, 4)))
    kids = parametric.mutate(g, p[:3], 7)
    assert kids.shape == (7, 16)
