"""fks_tpu_torch synthetic workloads, bucketing and the OpenB node park vs
fks_tpu: the same seed gives the same arrays, field by field, and the
exact engine scores a synthetic workload as fks_tpu's does."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.data import synthetic as jsyn
from fks_tpu.data import traces as jtraces
from fks_tpu.models import zoo as jzoo
from fks_tpu.sim import engine as jengine
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.convert import CLUSTER_FIELDS, POD_FIELDS
from fks_tpu_torch.data import synthetic, traces
from fks_tpu_torch.models import zoo
from fks_tpu_torch.sim import engine
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, result_fields,
)


def assert_same_workload(got, ref):
    for name in CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(got.cluster, name).numpy(),
                                      np.asarray(getattr(ref.cluster, name)),
                                      err_msg=name)
    for name in POD_FIELDS:
        np.testing.assert_array_equal(getattr(got.pods, name).numpy(),
                                      np.asarray(getattr(ref.pods, name)),
                                      err_msg=name)
    assert got.cluster.node_ids == tuple(ref.cluster.node_ids)
    assert got.pods.pod_ids == tuple(ref.pods.pod_ids)


@pytest.mark.parametrize("kw", [
    dict(num_nodes=16, num_pods=500, seed=0),
    dict(num_nodes=40, num_pods=2000, seed=3, load=None),
    dict(num_nodes=12, num_pods=300, seed=5, load=0.9,
         pad_to=(16, 8, 512), horizon=50_000, gpu_pod_frac=0.5),
])
def test_synthetic_workload_matches(kw):
    assert_same_workload(synthetic.synthetic_workload(**kw),
                         jsyn.synthetic_workload(**kw))


def test_node_yaml_park_matches():
    got = traces.parse_node_yaml()
    assert got == jtraces.parse_node_yaml()
    assert len(got) == 1213
    for v in ("64000m", "96", "'32'", "1.5"):
        assert traces._parse_cpu_milli(v) == jtraces._parse_cpu_milli(v)
    for v in ("262144Mi", "512Gi", "1Ti", "2048Ki", "'1024Mi'", "300"):
        assert traces._parse_memory_mib(v) == jtraces._parse_memory_mib(v)
    kw = dict(num_nodes=100, num_pods=400, seed=2)
    assert_same_workload(
        synthetic.synthetic_workload(nodes=got, **kw),
        jsyn.synthetic_workload(nodes=jtraces.parse_node_yaml(), **kw))
    with pytest.raises(ValueError, match="exceeds"):
        synthetic.synthetic_workload(num_nodes=2000, num_pods=10, nodes=got)


def test_bucketing_matches():
    specs = [dict(num_nodes=n, num_pods=p, seed=s)
             for n, p, s in ((10, 300, 0), (14, 1900, 1), (20, 2100, 2),
                             (3, 50, 3))]
    got = synthetic.bucket_workloads(
        [synthetic.synthetic_workload(**k) for k in specs])
    ref = jsyn.bucket_workloads([jsyn.synthetic_workload(**k) for k in specs])
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in ref]
    for shape, jshape in zip(got, ref):
        assert len(got[shape]) == len(ref[jshape])
        for a, b in zip(got[shape], ref[jshape]):
            assert_same_workload(a, b)
            assert a.cluster.n_padded == shape.n
            assert a.cluster.g_padded == shape.g
            assert a.pods.p_padded == shape.p
    wl = synthetic.synthetic_workload(num_nodes=20, num_pods=100)
    with pytest.raises(ValueError, match="smaller"):
        synthetic.pad_workload(wl, synthetic.BucketShape(n=16, g=8, p=128))


def test_exact_engine_on_synthetic_workload_matches():
    """An oversubscribed synthetic stream (retries and drops) through both
    exact engines, best_fit in float64."""
    kw = dict(num_nodes=6, num_pods=160, seed=7, load=None, horizon=20_000)
    cfg = dict(max_steps=1200)
    ref = jengine.simulate(jsyn.synthetic_workload(**kw),
                           jzoo.best_fit(jnp.float64),
                           JaxConfig(score_dtype=jnp.float64, **cfg))
    with one_torch_thread():
        res = engine.simulate(synthetic.synthetic_workload(**kw),
                              zoo.best_fit(torch.float64),
                              SimConfig(score_dtype=torch.float64, **cfg),
                              device="cpu")
    assert int(ref.num_fragmentation_events) > 0
    assert_result_matches(res, result_fields(ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(res.pod_ctime.numpy(),
                                  np.asarray(ref.pod_ctime))
