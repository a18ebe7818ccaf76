"""fks_tpu_torch fused engine (the kernel's plain version, on the CPU) on
the full default OpenB trace vs fks_tpu's flat engine.

16 nodes x 8,152 pods at pop 2: the best_fit seed and the 0.5365
champion's weights. Integer observables exact, float fields within
rtol/atol 2e-6.
"""
import json

import jax  # noqa: F401  (both frameworks in one process; data as numpy)
import numpy as np
import pytest
import torch

from fks_tpu.models import parametric as jpar
from fks_tpu.parallel import make_population_eval as jax_population_eval
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.convert import load_champion_weights
from fks_tpu_torch.data import TraceParser
from fks_tpu_torch.models import parametric
from fks_tpu_torch.sim import fused
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, result_fields,
)

CHAMPION = "policies/discovered/funsearch_20260801_045536_score0.5365.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def test_default_trace_best_fit_and_champion(default_workload):
    params = torch.stack([parametric.seed_weights("best_fit"),
                          load_champion_weights(CHAMPION)])
    with open(CHAMPION) as f:
        jparams = np.stack([np.asarray(jpar.seed_weights("best_fit")),
                            np.asarray(json.load(f)["weights"], np.float32)])
    np.testing.assert_array_equal(params.numpy(), jparams)
    ref = jax_population_eval(default_workload,
                              cfg=JaxConfig(track_ctime=False),
                              engine="flat")(jparams)
    run = fused.make_fused_population_run(
        TraceParser().parse_workload(), SimConfig(track_ctime=False),
        device="cpu")
    res = run(params)
    assert_result_matches(res, result_fields(ref))
    assert res.events_processed.tolist() == [16460, 41820]
    assert res.max_nodes.tolist() == np.asarray(ref.max_nodes).tolist()
