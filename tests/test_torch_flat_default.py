"""fks_tpu_torch flat engine on the full default OpenB trace vs fks_tpu.

16 nodes x 8,152 pods at pop 2: the best_fit seed and the 0.5365
champion's weights (41,820 events, 25,516 of them failed placements that
retry). Integer observables exact, float fields within rtol/atol 2e-6,
against fks_tpu's flat engine both as an eager loop and jit-compiled
(where XLA folds the workload in as constants).
"""
import json

import jax  # noqa: F401  (both frameworks in one process; data as numpy)
import numpy as np
import pytest
import torch

from fks_tpu.models import parametric as jpar
from fks_tpu.parallel import make_population_eval as jax_population_eval
from fks_tpu.sim import flat as jflat
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu_torch.data import TraceParser
from fks_tpu_torch.models import parametric
from fks_tpu_torch.sim import flat
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import (
    assert_result_matches, one_torch_thread, result_fields,
)

CHAMPION = "policies/discovered/funsearch_20260801_045536_score0.5365.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def default_params():
    with open(CHAMPION) as f:
        champ = json.load(f)["weights"]
    return np.stack([np.asarray(jpar.seed_weights("best_fit")),
                     np.asarray(champ, np.float32)]).astype(np.float32)


def test_default_trace_best_fit_and_champion(default_workload):
    params = default_params()
    jcfg = JaxConfig(track_ctime=False)
    eager = jflat.make_population_run_fn(default_workload, jpar.score, jcfg)(
        params, jflat.initial_state(default_workload, jcfg))
    jitted = jax_population_eval(default_workload, cfg=jcfg,
                                 engine="flat")(params)

    wl = TraceParser().parse_workload()
    cfg = SimConfig(track_ctime=False)
    res = flat.make_population_run_fn(wl, parametric.score, cfg)(
        torch.from_numpy(params), flat.initial_state(wl, cfg))
    assert_result_matches(res, result_fields(eager))
    assert_result_matches(res, result_fields(jitted))
    assert int(res.num_fragmentation_events[1]) > 20000  # retries exercised
    assert res.scheduled_pods.tolist() == [8152, 8152]
    np.testing.assert_allclose(res.policy_score.numpy(),
                               [0.45935568, 0.4847603], rtol=1e-6)
