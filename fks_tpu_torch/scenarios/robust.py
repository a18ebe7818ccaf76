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

``make_sharded_suite_eval`` shards the candidates over a device mesh
(``parallel.mesh``), and on a ``layout_mesh`` the scenarios too; elite
selection ranks the composite robust score.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from fks_tpu_torch.models import parametric
from fks_tpu_torch.parallel.mesh import (
    SCN_AXIS, _check_mesh, _concat, _layout_eval, _local_shards,
    _resolve_layout, _tiles, gather_shards, shard_population, top_k_real,
)
from fks_tpu_torch.parallel.traces import (
    make_trace_batch_eval, stack_traces, stacked_trace_eval,
)
from fks_tpu_torch.scenarios.suite import ScenarioSuite
from fks_tpu_torch.sim.engine import SimConfig, drain
from fks_tpu_torch.sim.types import map_tensors

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


def make_sharded_suite_eval(suite: ScenarioSuite, mesh,
                            param_policy=parametric.score,
                            cfg: SimConfig = SimConfig(),
                            rc: RobustConfig = RobustConfig(),
                            elite_k: int = 8, engine: str = "exact",
                            layout=None):
    """``eval(params[C, ...], real_count=None) -> (robust[C],
    per_scenario[C, T], elite_idx[K], elite_scores[K])`` (fks_tpu
    robust.py:99-242): candidates sharded over the mesh's pop axes, each
    shard running its chunk over candidates x scenarios, the robust
    vectors gathered so the elites are the top-k of the composite score.
    ``per_scenario`` holds the local shards' rows.

    ``layout`` (``obs.layout.LayoutSpec``) may shard the scenario axis
    too: on a ``layout_mesh(devices, scenario_shards)`` each
    (candidate shard, scenario shard) tile runs its scenario chunk (a
    slice of the suite stacked once, so every tile shares the suite's
    step budget and snapshot width), the per-scenario scores are joined
    over the scenario shards before the aggregation, and the robust
    gather crosses candidate shards as before. The suite length must
    divide over the scenario shards. Wiring and launches file
    ``layout_ledger`` rows (component "suite_eval")."""
    spec = _resolve_layout(layout, scenarios=True, scenario_shardable=True)
    _check_mesh(mesh)
    scn_shards = int(mesh.shape.get(SCN_AXIS, 1))
    if "scenarios" in spec.shard:
        if scn_shards <= 1:
            raise ValueError(
                f"layout {spec.key!r} shards scenarios but the mesh has "
                f"no '{SCN_AXIS}' axis — build one with "
                "parallel.mesh.layout_mesh(devices, scenario_shards)")
        if len(suite) % scn_shards:
            raise ValueError(
                f"suite of {len(suite)} scenarios does not divide into "
                f"{scn_shards} scenario shards")
    elif scn_shards > 1:
        raise ValueError(
            f"mesh has a {scn_shards}-way '{SCN_AXIS}' axis but layout "
            f"{spec.key!r} does not shard scenarios")

    # one stack of the whole suite, cut into scenario chunks and placed on
    # each distinct device once; every tile gets its own runner (graphs)
    host = stack_traces(list(suite.workloads), cfg, engine)
    per = len(suite) // scn_shards
    tiles = _tiles(mesh)
    placed = {}

    def chunk(j, dev):
        if (j, dev) not in placed:
            wl, kt, s0, max_steps = host
            cut = lambda x: x[j * per:(j + 1) * per].to(dev)  # noqa: E731
            placed[(j, dev)] = (map_tensors(cut, wl), cut(kt),
                                map_tensors(cut, s0), max_steps)
        return placed[(j, dev)]

    shards = _local_shards(mesh)
    lead = shards[0][1]
    runners = [[stacked_trace_eval(chunk(j, tiles[i, j]), param_policy, cfg,
                                   population=True, engine=engine)
                for j in range(scn_shards)]
               for i, _ in shards]

    def sharded_eval(params, real_count):
        parts = shard_population(params, mesh)
        jobs = [[run.start(map_tensors(lambda x, d=tiles[i, j]: x.to(d),
                                       part))
                 for j, run in enumerate(row)]
                for (i, _), row, part in zip(shards, runners, parts)]
        drain([job for row in jobs for job in row])
        per_scn = _concat([
            torch.cat([run.finish(job).policy_score.to(lead)
                       for run, job in zip(row, jrow)], dim=1)
            for row, jrow in zip(runners, jobs)], lead)
        robust = aggregate(per_scn, rc)
        global_robust = gather_shards(mesh, robust)
        elite_scores, elite_idx = top_k_real(global_robust, real_count,
                                             elite_k)
        return global_robust, per_scn, elite_idx, elite_scores

    return _layout_eval(sharded_eval, "suite_eval", spec, mesh,
                        scenarios=len(suite))
