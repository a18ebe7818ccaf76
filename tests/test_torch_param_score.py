"""The shapes ``parametric.score``'s kernel must accept, on the CPU.

csrc/param_score.cu reads the policy views in place through their strides
(``parametric._kernel_views``): pod fields ``[L, 1]``, node fields
``[L, N]`` or shared ``[N]``, GPU fields ``[L, N, G]`` or shared ``[N, G]``,
weights ``[L, 16]`` or shared ``[16]``. On the CPU the wrapper runs the
plain version, so these tests pin the views the kernel is handed: every
layout the engines produce expands to ``[L, ...]`` without a copy (a
shared field keeps lane stride 0), and the plain version scores the
expanded views exactly as it scores the caller's (the kernel's own
equality with the plain version is held on the card, tests/test_torch_
gpu.py and chip_smoke.py).
"""
import pytest
import torch

from fks_tpu_torch.models import parametric
from fks_tpu_torch.sim.types import NodeView, PodView
from fks_tpu_torch.testing import random_policy_views

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
