"""fks_tpu_torch data layer and host tables vs fks_tpu.

Every array the port's ingest produces must equal fks_tpu's (same values,
same padding) on the default workload and on other pod traces; the
snapshot trigger tables must be identical; numpy round-trips are exact.
"""
import json

import jax  # noqa: F401  (both frameworks in one process; data as numpy)
import numpy as np
import pytest
import torch

from fks_tpu.data import TraceParser as JaxParser
from fks_tpu.data.build import make_workload as jax_make_workload
from fks_tpu.sim import evaluator as jax_evaluator
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu.sim.engine import loop_tables as jax_loop_tables
from fks_tpu_torch.convert import (
    CLUSTER_FIELDS, POD_FIELDS, load_champion_weights, params_from_numpy,
    workload_from_numpy, workload_to_numpy,
)
from fks_tpu_torch.data import TraceParser, make_workload
from fks_tpu_torch.sim import evaluator
from fks_tpu_torch.sim.engine import SimConfig, loop_tables
from fks_tpu_torch.testing import contended_workload, roomy_workload

CHAMPION = "policies/discovered/funsearch_20260801_045536_score0.5365.json"


def assert_same_workload(port, ref):
    for k in CLUSTER_FIELDS:
        a = getattr(port.cluster, k).numpy()
        b = np.asarray(getattr(ref.cluster, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in POD_FIELDS:
        a, b = getattr(port.pods, k).numpy(), np.asarray(getattr(ref.pods, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert port.cluster.node_ids == tuple(ref.cluster.node_ids)
    assert port.pods.pod_ids == tuple(ref.pods.pod_ids)
    assert port.cluster.totals() == ref.cluster.totals()
    assert (port.cluster.n_padded, port.cluster.g_padded, port.pods.p_padded,
            port.num_nodes, port.num_pods) == (
        ref.cluster.n_padded, ref.cluster.g_padded, ref.pods.p_padded,
        ref.num_nodes, ref.num_pods)


def test_default_workload_matches(default_workload):
    port = TraceParser().parse_workload()
    assert_same_workload(port, default_workload)
    assert (port.num_nodes, port.num_pods) == (16, 8152)
    assert port.cluster.n_padded % 8 == 0 and port.pods.p_padded % 128 == 0


@pytest.mark.parametrize("pod_file", [
    "openb_pod_list_gpushare40.csv", "openb_pod_list_multigpu50.csv",
    "openb_pod_list_cpu250.csv"])
def test_pod_traces_match(pod_file):
    ref = JaxParser().parse_workload(pod_file=pod_file)
    port = TraceParser().parse_workload(pod_file=pod_file)
    assert_same_workload(port, ref)


def test_discovery_and_explicit_padding():
    ref, port = JaxParser(), TraceParser()
    assert port.get_available_pod_files() == ref.get_available_pod_files()
    assert port.get_available_node_files() == ref.get_available_node_files()
    kw = dict(pad_nodes_to=24, pad_gpus_to=10, pad_pods_to=8448)
    assert_same_workload(port.parse_workload(**kw), ref.parse_workload(**kw))
    with pytest.raises(ValueError, match="padding too small"):
        port.parse_cluster("gpu_models_filtered.csv", pad_nodes_to=4)


def test_make_workload_matches(micro_workload):
    from tests.test_fused import _contended, _roomy

    nodes = [{"node_id": "n0", "cpu_milli": 4000, "memory_mib": 8000,
              "gpus": [1000, 1000]},
             {"node_id": "n1", "cpu_milli": 2000, "memory_mib": 4000,
              "gpus": [], "gpu_declared": 1}]
    pods = [{"pod_id": f"p{5 - i}", "cpu_milli": 500, "memory_mib": 500,
             "num_gpu": i % 2, "gpu_milli": 300 * (i % 2),
             "creation_time": i, "duration_time": 5} for i in range(6)]
    kw = dict(pad_nodes_to=3, pad_gpus_to=2, pad_pods_to=8)
    assert_same_workload(make_workload(nodes, pods, **kw),
                         jax_make_workload(nodes, pods, **kw))
    assert_same_workload(roomy_workload(), _roomy())
    assert_same_workload(contended_workload(), _contended())


def test_numpy_round_trips(default_workload):
    c, p = default_workload.cluster, default_workload.pods
    cluster = {k: np.asarray(getattr(c, k)) for k in CLUSTER_FIELDS}
    pods = {k: np.asarray(getattr(p, k)) for k in POD_FIELDS}
    cluster["node_ids"], pods["pod_ids"] = c.node_ids, p.pod_ids
    port = workload_from_numpy(cluster, pods)
    assert_same_workload(port, default_workload)
    back_c, back_p = workload_to_numpy(port)
    for k in CLUSTER_FIELDS:
        np.testing.assert_array_equal(back_c[k], cluster[k])
    for k in POD_FIELDS:
        np.testing.assert_array_equal(back_p[k], pods[k])
    again = workload_from_numpy(back_c, back_p)
    assert_same_workload(again, default_workload)


def test_weights_conversion():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 16))
    t = params_from_numpy(w)
    assert t.dtype == torch.float32 and t.shape == (5, 16)
    np.testing.assert_array_equal(t.numpy(), w.astype(np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(np.zeros((3, 15)))
    champ = load_champion_weights(CHAMPION)
    with open(CHAMPION) as f:
        ref = np.asarray(json.load(f)["weights"], np.float32)
    np.testing.assert_array_equal(champ.numpy(), ref)
    assert champ.shape == (16,)


@pytest.mark.parametrize("total,interval", [(8152, 0.05), (48, 0.05),
                                            (96, 0.1), (1, 0.05), (0, 0.05),
                                            (1000, 0.03)])
def test_snapshot_tables_identical(total, interval):
    for steps in (64, 8 * max(total, 1)):
        m = evaluator.max_snapshot_count(steps, total, interval)
        assert m == jax_evaluator.max_snapshot_count(steps, total, interval)
        a = evaluator.snapshot_trigger_table(total, m, interval)
        b = jax_evaluator.snapshot_trigger_table(total, m, interval)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_loop_tables_identical(default_workload):
    port = TraceParser().parse_workload()
    for kw in ({}, {"max_steps": 4000}, {"snapshot_interval": 0.1}):
        kt, ms = loop_tables(port, SimConfig(**kw))
        jkt, jms = jax_loop_tables(default_workload, JaxConfig(**kw))
        assert ms == jms
        np.testing.assert_array_equal(kt, np.asarray(jkt))


def test_workload_to_device_keeps_dtypes():
    wl = roomy_workload().to("cpu")
    assert wl.device == torch.device("cpu")
    assert wl.cluster.gpu_mask.dtype == torch.bool
    assert wl.pods.cpu.dtype == torch.int32
