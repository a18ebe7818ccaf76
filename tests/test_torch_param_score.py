"""What surrounds ``parametric.score``'s kernel, on the CPU.

csrc/param_score.cu reads the policy views in place through their strides
(``parametric._kernel_views``): pod fields ``[L, 1]``, node fields
``[L, N]`` or shared ``[N]``, GPU fields ``[L, N, G]`` or shared ``[N, G]``,
weights ``[L, 16]`` or shared ``[16]``. On the CPU the wrapper runs the
plain version, so these tests pin what the kernel is handed: every layout
the engines produce expands to ``[L, ...]`` without a copy (a shared field
keeps lane stride 0), the launch geometry covers every (lane, node) once
and fits its shared memory, views past the 32-bit offsets are refused, and
the plain version equals fks_tpu's score at the odd shapes the kernel is
held to (the kernel's own equality with the plain version is held on the
card, tests/test_torch_gpu.py and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from fks_tpu_torch.models import parametric
from fks_tpu_torch.sim.types import NodeView, PodView
from fks_tpu_torch.testing import (
    PARAM_SCORE_GPUS, PARAM_SCORE_LANES, PARAM_SCORE_NODES,
    random_policy_views,
)

LANES, N, G = 8, 16, 8


def per_lane(nodes: NodeView) -> NodeView:
    """Every shared ``[N]`` / ``[N, G]`` field given a lane axis."""
    return NodeView(*(x if x.dim() == (3 if name.startswith("gpu_m") or
                                       name == "gpu_mask" else 2)
                      else x.expand((LANES,) + tuple(x.shape)).clone()
                      for name, x in zip(NodeView._fields, nodes)))


@pytest.mark.parametrize("layout", ["shared", "per_lane"])
@pytest.mark.parametrize("weights", ["per_lane", "shared"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_views_score_like_the_callers_views(layout, weights, dtype):
    pod, nodes, w = random_policy_views(3, lanes=LANES, n=N, g=G,
                                        gpu_heavy=layout == "shared")
    if layout == "per_lane":
        nodes = per_lane(nodes)
    if weights == "shared":
        w = w[2]
    views, ww, lanes, n, g = parametric._kernel_views(w, pod, nodes, dtype)
    assert (lanes, n, g) == (LANES, N, G)
    assert ww.shape == (LANES, 16) and ww.dtype == dtype
    assert ww.stride()[0] == (0 if weights == "shared" else 16)
    named = dict(zip(parametric._POD_FIELDS + parametric._NODE_FIELDS
                     + parametric._GPU_FIELDS, views))
    for name, x in named.items():
        src = getattr(pod, name) if name in parametric._POD_FIELDS \
            else getattr(nodes, name)
        assert x.data_ptr() == src.data_ptr(), name  # a view, no copy
        assert x.shape[0] == LANES
        if src.dim() < x.dim():
            assert x.stride()[0] == 0, name  # a shared field
    pv = PodView(*(named[f] if f in named else getattr(pod, f)
                   for f in PodView._fields))
    nv = NodeView(*(named.get(f, getattr(nodes, f))
                    for f in NodeView._fields))
    want = parametric.score_plain(w, pod, nodes, dtype=dtype)
    assert torch.equal(parametric.score_plain(ww, pv, nv, dtype=dtype), want)
    assert torch.equal(parametric.score(w, pod, nodes, dtype=dtype), want)


def test_probe_views_broadcast_one_lane():
    """The auto-prefilter probe's all-ones ``[1, N]`` views and one
    candidate's ``[16]`` weights."""
    ones = lambda *s, d=torch.int32: torch.ones(s, dtype=d)  # noqa: E731
    pod = PodView(*(ones(1, 1) for _ in range(6)))
    vn, vg = ones(1, 1000), ones(1, 1000, G)
    nodes = NodeView(vn, vn, vn, vn, vn, vn, vg, vg, vg,
                     ones(1, 1000, G, d=torch.bool),
                     ones(1, 1000, d=torch.bool))
    w = parametric.seed_weights("first_fit")
    _, ww, lanes, n, g = parametric._kernel_views(w, pod, nodes,
                                                  torch.float32)
    assert (lanes, n, g) == (1, 1000, G) and ww.shape == (1, 16)
    assert parametric.score(w, pod, nodes).shape == (1, 1000)


def test_kernel_views_reject_what_the_kernel_does_not_take():
    pod, nodes, w = random_policy_views(0, lanes=LANES, n=N, g=G)
    with pytest.raises(ValueError, match="float32 or float64"):
        parametric._kernel_views(w, pod, nodes, torch.float16)
    with pytest.raises(ValueError, match="params must be"):
        parametric._kernel_views(w[:, :8], pod, nodes, torch.float32)
    bad = nodes._replace(cpu_milli_left=nodes.cpu_milli_left.long())
    with pytest.raises(ValueError, match="cpu_milli_left"):
        parametric._kernel_views(w, pod, bad, torch.float32)
    wide = nodes._replace(gpu_milli_left=torch.zeros((LANES, N, 40),
                                                     dtype=torch.int32))
    with pytest.raises(ValueError, match="at most 32 GPUs"):
        parametric._kernel_views(w, pod, wide, torch.float32)


# ------------------------------------------------ the kernel's launch geometry

SHAPES = [(lanes, n, g) for lanes in PARAM_SCORE_LANES
          for n in PARAM_SCORE_NODES for g in PARAM_SCORE_GPUS]
RANDOM_SHAPES = [tuple(int(x) for x in row) for row in np.random.default_rng(
    8).integers((1, 1, 0), (700, 2100, 33), size=(6, 3))]
#: fields the engines hand over shared: the cluster's totals and masks
CLUSTER = ("cpu_milli_total", "memory_mib_total", "num_gpus", "node_mask",
           "gpu_milli_total", "gpu_mask")


def shared_bits(names) -> int:
    return sum(1 << parametric._FIELDS.index(name) for name in names)


def cells_of(geo, lanes: int, n: int):
    """The (lane, node) cells the kernel's threads take, as the kernel
    derives them from its geometry (csrc/param_score.cu ``cell_of`` for
    the load round, ``score_tile`` for the scores): ``(loads, scores)``,
    two i64[lanes, n] counts."""
    lb, nb = geo.lanes_per_block, geo.node_tile
    bx, by, t = np.meshgrid(np.arange(geo.grid[0]), np.arange(geo.grid[1]),
                            np.arange(geo.threads), indexing="ij")
    loads, scores = np.zeros((lanes, n), np.int64), np.zeros((lanes, n),
                                                             np.int64)
    cell = t & (lb * nb - 1)
    l, node = by * lb + cell // nb, bx * nb + cell % nb
    ok = (l < lanes) & (node < n)
    np.add.at(loads, (l[ok], node[ok]), 1)
    warp, j = t // 32, t % 32
    l = by * lb + warp // (nb // 16)
    node = bx * nb + (warp % (nb // 16)) * 16 + j % 16
    ok = (l < lanes) & (node < n) & (j < 16)  # lanes j + 16 score with j
    np.add.at(scores, (l[ok], node[ok]), 1)
    return loads, scores


@pytest.mark.parametrize("lanes,n,g", SHAPES + RANDOM_SHAPES)
def test_launch_geometry_covers_every_cell_once(lanes, n, g):
    """Every (lane, node) is loaded by exactly two threads (its node fields
    and its GPU row) and scored by exactly one warp lane pair."""
    geo = parametric.launch_geometry(lanes, n, g, 4,
                                     shared_bits(CLUSTER))
    lb, nb = geo.lanes_per_block, geo.node_tile
    assert lb & (lb - 1) == 0 and nb & (nb - 1) == 0 and nb >= 16
    assert geo.threads == 2 * lb * nb <= parametric.KERNEL_MAX_THREADS
    assert geo.threads % 32 == 0
    assert geo.grid == (-(-n // nb), -(-lanes // lb))
    assert geo.gpu_cols in (8, 16, 32) and geo.gpu_cols >= g
    if n <= 16:
        assert (nb, lb) == (16, min(8, parametric._pow2(lanes)))
    loads, scores = cells_of(geo, lanes, n)
    assert (loads == 2).all() and (scores == 1).all()


def staged_sizes(geo, weight_bytes):
    """Each field's staged bytes, from the layout param_score.cu reads."""
    lb, nb, cols = geo.lanes_per_block, geo.node_tile, geo.gpu_cols
    sizes = {}
    for f, name in enumerate(parametric._FIELDS):
        rows = 1 if (geo.shared >> f) & 1 else lb
        sizes[name] = {
            "cpu_milli": 16 * lb, "weights": 16 * lb * weight_bytes,
            "node_mask": rows * nb, "gpu_mask": rows * nb * cols,
            "gpu_milli_left": 4 * rows * nb * geo.row_stride,
            "gpu_milli_total": 4 * rows * nb * geo.row_stride,
        }.get(name, 4 * rows * nb if name in parametric._NODE_FIELDS else 0)
    return sizes


@pytest.mark.parametrize("shared", ["none", "cluster", "all"])
@pytest.mark.parametrize("weight_bytes", [4, 8])
def test_launch_geometry_shared_memory_fits(shared, weight_bytes):
    """The staged tiles are 16-byte aligned, do not overlap and fit in the
    shared memory the launch may use, for every timed and held shape."""
    bits = {"none": 0, "cluster": shared_bits(CLUSTER),
            "all": (1 << len(parametric._FIELDS)) - 1}[shared]
    for lanes, n, g in SHAPES + RANDOM_SHAPES:
        geo = parametric.launch_geometry(lanes, n, g, weight_bytes, bits)
        assert geo.smem_bytes <= parametric.KERNEL_SMEM_BYTES
        spans = sorted((geo.offsets[f], geo.offsets[f] + size)
                       for f, size in enumerate(
                           staged_sizes(geo, weight_bytes).values()) if size)
        assert all(lo % 16 == 0 for lo, _ in spans)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] <= geo.smem_bytes
        assert geo.row_stride % 4 == 0 and geo.row_stride >= geo.gpu_cols


def meta_views(lanes, n, g, wide=()):
    """Views on the meta device (shapes and strides only, no memory):
    the fields named in ``wide`` are views into a tensor 2**31 elements
    wider per lane."""
    def view(name, *shape, dtype=torch.int32):
        if name in wide:
            return torch.empty((shape[0], 2**31) + shape[2:], dtype=dtype,
                               device="meta")[:, :shape[1]]
        return torch.empty(shape, dtype=dtype, device="meta")

    pod = PodView(*(view(f, lanes, 1) for f in PodView._fields))
    fields = []
    for name in NodeView._fields:
        grid = name.startswith("gpu_m") or name == "gpu_mask"
        dtype = torch.bool if name in ("gpu_mask", "node_mask") \
            else torch.int32
        fields.append(view(name, lanes, n, g, dtype=dtype) if grid
                      else view(name, lanes, n, dtype=dtype))
    return pod, NodeView(*fields)


def test_offsets_past_32_bits_are_refused():
    """Views the kernel's 32-bit offsets cannot reach raise ValueError
    naming them, before anything is launched."""
    w = torch.zeros(16, device="meta")
    pod, nodes = meta_views(4, 16, 8, wide=("cpu_milli_left",
                                            "gpu_milli_left"))
    with pytest.raises(ValueError, match="cpu_milli_left, gpu_milli_left "
                                         "span 2"):
        parametric._launch_score(w, pod, nodes, torch.float32)
    pod, nodes = meta_views(2**16, 2**15, 1)
    with pytest.raises(ValueError, match="reach 2\\*\\*31 scores"):
        parametric._launch_score(w, pod, nodes, torch.float32)
    pod, nodes = meta_views(4, 16, 8)
    _, geo, out = parametric._score_block(w, pod, nodes, torch.float32)
    assert out.shape == (4, 16) and geo.grid == (1, 1)


def test_vector_rows_only_where_contiguous_and_aligned():
    """GPU rows are loaded 4 elements at a time only for G of 8, 16 or 32
    with contiguous, aligned rows; a slice of a wider tensor takes the
    strided path."""
    gpu_bits = sum(1 << parametric._FIELDS.index(f)
                   for f in parametric._GPU_FIELDS)
    for g, sliced, want in ((8, False, gpu_bits), (32, False, gpu_bits),
                            (4, False, 0), (1, False, 0)):
        pod, nodes, w = random_policy_views(1, lanes=4, n=20, g=g)
        block, _, _ = parametric._score_block(w, pod, nodes, torch.float32)
        assert block[4 * 16 + 3 + 9] == want, g
    pod, nodes, w = random_policy_views(1, lanes=4, n=20, g=8)
    wide = torch.cat([nodes.gpu_milli_left[..., :1],
                      nodes.gpu_milli_left], dim=-1)[..., 1:]
    block, _, _ = parametric._score_block(
        w, pod, nodes._replace(gpu_milli_left=wide), torch.float32)
    assert block[4 * 16 + 3 + 9] == gpu_bits & ~(
        1 << parametric._FIELDS.index("gpu_milli_left"))


# -------------------------------- the plain version against fks_tpu, odd shapes

ODD = [(1, 8, {}), (17, 8, {}), (16, 1, {}), (16, 32, {}),
       (17, 32, dict(scattered_masks=True, milli_total=None)),
       (1, 1, dict(milli_total=750)),
       (16, 8, dict(scattered_masks=True, milli_total=750, unfit_lanes=2))]


def fks_tpu_score(pod, nodes, w, dtype):
    """fks_tpu's ``parametric.score`` on the same numpy draws, per lane
    under vmap with the shared totals as jit arguments."""
    import jax
    import jax.numpy as jnp

    from fks_tpu.models import parametric as jpar
    from fks_tpu.sim.types import NodeView as JNodeView
    from fks_tpu.sim.types import PodView as JPodView

    np_ = lambda x: x.numpy()  # noqa: E731
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64

    def lane(cl, ml, gl, gml, p, wl, ct, mt, ng, gmt, gm, nm):
        n = JNodeView(cl, ct, ml, mt, gl, ng, gml, gmt, gmt, gm, nm)
        return jpar.score(wl, JPodView(*p), n, jd)

    per_lane = tuple(np_(getattr(nodes, f)) for f in (
        "cpu_milli_left", "memory_mib_left", "gpu_left", "gpu_milli_left"))
    pods = tuple(np_(x[:, 0]) for x in pod)
    shared = tuple(np_(getattr(nodes, f)) for f in (
        "cpu_milli_total", "memory_mib_total", "num_gpus",
        "gpu_milli_total", "gpu_mask", "node_mask"))
    fn = jax.jit(jax.vmap(lane, in_axes=(0,) * 6 + (None,) * 6))
    return np.asarray(fn(*per_lane, pods, np_(w), *shared))


@pytest.mark.parametrize("n,g,opts", ODD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_score_plain_equals_fks_tpu_on_odd_shapes(n, g, opts, dtype):
    """The plain version (what the kernel is held to on the card) equals
    fks_tpu's score at one node, a ragged 17, one GPU, 32 GPUs, scattered
    masks, milli totals other than 1,000 and unfit pods."""
    pod, nodes, w = random_policy_views(11, lanes=32, n=n, g=g, **opts)
    got = parametric.score_plain(w, pod, nodes, dtype=dtype).numpy()
    np.testing.assert_array_equal(got, fks_tpu_score(pod, nodes, w, dtype))
    if opts.get("unfit_lanes"):
        assert not got[:opts["unfit_lanes"]].any()
