"""fks_tpu_torch.models.zoo vs fks_tpu.models.zoo, on random views.

Every policy of both tables (``ZOO`` and ``BASELINE_FACTORIES``) plus
``micro_best_fit`` scores the same numpy-drawn views (256 lanes x 16
nodes) in float64 and float32; the integer scores must equal fks_tpu's.
Views reach JAX as jit arguments, like the engine state they model.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.models import zoo as jzoo
from fks_tpu_torch.models import zoo
from fks_tpu_torch.testing import one_torch_thread
from tests.test_torch_policies import jax_per_lane, port_views, random_views

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


NAMES = ["first_fit", "best_fit", "worst_fit", "gpu_aware",
         "utilization_based", "micro_best_fit", "funsearch_4901",
         "funsearch_4816", "funsearch_4800"]


def test_tables_have_fks_tpu_keys():
    assert list(zoo.ZOO) == list(jzoo.ZOO)
    assert list(zoo.BASELINE_FACTORIES) == list(jzoo.BASELINE_FACTORIES)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_policy_scores_match(name, dtype):
    view, pod, _ = random_views(10)
    pv, nodes = port_views(view, pod)
    got = getattr(zoo, name)(getattr(torch, dtype))(pv, nodes)
    ref = jax_per_lane(getattr(jzoo, name)(getattr(jnp, dtype)), view, pod)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 1).sum() > 100  # real scores, not just the gate
