"""Scenario suites: deterministic workload variants and robust fitness.

Port of fks_tpu.scenarios:

- ``generator``: seed-derived perturbations of a base workload (arrival
  jitter, demand scaling, pod-mix shifts) and fault injection as
  NODE_DOWN / NODE_UP trace events with cordon semantics;
- ``suite``: named, versioned suites (``default8``: the base trace and 7
  variants) materialized as same-shape workloads;
- ``robust``: one batched evaluation of a candidate, or a population, over
  a whole suite, and the fold of its per-scenario scores into a robust
  score (weighted mean, min, CVaR-alpha); ``make_sharded_suite_eval``
  shards the candidates (and, on a ``layout_mesh``, the scenarios) over a
  device mesh and ranks elites on the robust score.
"""
from fks_tpu_torch.scenarios.generator import (
    ScenarioSpec, fault_events_for, make_fault_events, perturb_workload,
)
from fks_tpu_torch.scenarios.robust import (
    AGGREGATIONS, RobustConfig, aggregate, make_sharded_suite_eval,
    make_suite_eval,
)
from fks_tpu_torch.scenarios.suite import (
    SUITE_SPECS, SUITE_VERSION, ScenarioSuite, build_suite, get_suite,
    list_suites,
)

__all__ = ["AGGREGATIONS", "RobustConfig", "SUITE_SPECS", "SUITE_VERSION",
           "ScenarioSpec", "ScenarioSuite", "aggregate", "build_suite",
           "fault_events_for", "get_suite", "list_suites",
           "make_fault_events", "make_sharded_suite_eval", "make_suite_eval",
           "perturb_workload"]
