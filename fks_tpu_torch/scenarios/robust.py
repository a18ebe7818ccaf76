"""Robust fitness: evaluate candidates over a scenario suite in one call.

Port of fks_tpu.scenarios.robust. A suite's workloads share one padded
shape, so the whole suite rides the trace batcher
(``parallel.traces.make_trace_batch_eval``): one batched run scores a
candidate, or a population, on every scenario, fault-injected variants
included, and ``aggregate`` folds the per-scenario scores into one
robust score:

- ``mean``: (optionally weighted) average;
- ``min``: the worst scenario;
- ``cvar``: CVaR-alpha, the mean of the worst ``ceil(alpha * T)``
  scenarios.

``make_sharded_suite_eval`` (candidates sharded over a device mesh) waits
for the port of ``parallel/mesh.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from fks_tpu_torch.models import parametric
from fks_tpu_torch.parallel.traces import make_trace_batch_eval
from fks_tpu_torch.scenarios.suite import ScenarioSuite
from fks_tpu_torch.sim.engine import SimConfig

AGGREGATIONS = ("mean", "min", "cvar")


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """How per-scenario fitness folds into one robust score."""

    aggregation: str = "mean"
    cvar_alpha: float = 0.25  # tail fraction for aggregation="cvar"
    weights: Optional[Tuple[float, ...]] = None  # aggregation="mean" only

    def __post_init__(self):
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             f"choose from {AGGREGATIONS}")
        if not (0.0 < self.cvar_alpha <= 1.0):
            raise ValueError(f"cvar_alpha {self.cvar_alpha} not in (0, 1]")
        if self.weights is not None and self.aggregation != "mean":
            raise ValueError("weights only apply to aggregation='mean'")

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def aggregate(scores, rc: RobustConfig = RobustConfig()) -> torch.Tensor:
    """Fold per-scenario scores (the TRAILING axis) into the robust score,
    on the scores' device."""
    scores = torch.as_tensor(scores)
    if rc.aggregation == "mean":
        if rc.weights is not None:
            w = torch.as_tensor(rc.weights, dtype=scores.dtype,
                                device=scores.device)
            if w.shape[0] != scores.shape[-1]:
                raise ValueError(
                    f"{w.shape[0]} weights for {scores.shape[-1]} scenarios")
            return (scores * w).sum(dim=-1) / w.sum()
        return scores.mean(dim=-1)
    if rc.aggregation == "min":
        return scores.amin(dim=-1)
    # cvar: mean of the worst ceil(alpha * T) scenarios
    k = max(1, int(math.ceil(rc.cvar_alpha * scores.shape[-1])))
    return torch.sort(scores, dim=-1).values[..., :k].mean(dim=-1)


def make_suite_eval(suite: ScenarioSuite,
                    param_policy=parametric.score,
                    cfg: SimConfig = SimConfig(),
                    population: bool = False,
                    engine: str = "exact", device=None):
    """``eval(params) -> SimResult`` over the suite's scenario axis, on
    ``device`` (default ``cuda``): result leaves are [T] (one candidate)
    or [C, T] (``population=True``), T = len(suite). A suite IS a
    same-shape trace batch, faults included. ``engine`` is "exact" or
    "flat"; the fused kernel refuses fault workloads."""
    return make_trace_batch_eval(
        list(suite.workloads), param_policy=param_policy, cfg=cfg,
        population=population, engine=engine, device=device)


def make_sharded_suite_eval(*_args, **_kwargs):
    """Candidates sharded over a device mesh: not ported yet."""
    raise ValueError(
        "make_sharded_suite_eval is not ported yet; it waits for the port "
        "of parallel/mesh.py (ROADMAP queue 1, the mesh slice). Use "
        "make_suite_eval(population=True) on one device")
