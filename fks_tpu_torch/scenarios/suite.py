"""Named, versioned scenario suites.

Port of fks_tpu.scenarios.suite. A suite is an ordered tuple of
``ScenarioSpec``s materialized against one base workload with a SHARED
fault padding, so its workloads have the same shapes and stack into one
trace batch (``parallel.traces``); fault-free scenarios carry an
all-masked timeline.

``SUITE_VERSION`` is fks_tpu's: the registry and the generator are the
same, so a robust score names the same scenario family in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.scenarios.generator import (
    ScenarioSpec, fault_events_for, perturb_workload,
)

#: bump when registry specs or generator derivations change
SUITE_VERSION = 1

#: registered suites: name -> ordered specs. ``default8`` is the headline
#: robust-fitness suite: the base trace and 7 perturbed or fault variants.
SUITE_SPECS: Dict[str, Tuple[ScenarioSpec, ...]] = {
    "default8": (
        ScenarioSpec("base"),
        ScenarioSpec("jitter", seed=11, arrival_jitter_frac=0.02),
        ScenarioSpec("demand_up", seed=12, demand_scale=1.10),
        ScenarioSpec("demand_down", seed=13, demand_scale=0.90),
        ScenarioSpec("podmix", seed=14, pod_mix_swap_frac=0.30),
        ScenarioSpec("fault1", seed=15, fault_nodes=1),
        ScenarioSpec("fault2", seed=16, fault_nodes=2,
                     fault_duration_frac=0.10),
        ScenarioSpec("mixed", seed=17, arrival_jitter_frac=0.01,
                     demand_scale=1.05, fault_nodes=1,
                     fault_start_frac=0.55),
    ),
    "smoke3": (
        ScenarioSpec("base"),
        ScenarioSpec("jitter", seed=21, arrival_jitter_frac=0.02),
        ScenarioSpec("fault1", seed=22, fault_nodes=1),
    ),
}


@dataclasses.dataclass(frozen=True)
class ScenarioSuite:
    """A materialized suite: specs and same-shape workloads."""

    name: str
    version: int
    specs: Tuple[ScenarioSpec, ...]
    workloads: Tuple[Workload, ...]
    fault_pad: int

    def __len__(self) -> int:
        return len(self.specs)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.specs)

    def describe(self) -> dict:
        """JSON-ready suite summary."""
        return {
            "suite": self.name,
            "version": self.version,
            "fault_pad": self.fault_pad,
            "scenarios": [
                {**spec.describe(),
                 "fault_events": int(wl.faults.num_events)}
                for spec, wl in zip(self.specs, self.workloads)
            ],
        }


def build_suite(name: str, version: int, specs: Sequence[ScenarioSpec],
                base: Workload) -> ScenarioSuite:
    """Materialize ``specs`` against ``base`` with one shared fault pad
    (>= 1, so every scenario carries a FaultEvents of one shape)."""
    specs = tuple(specs)
    if not specs:
        raise ValueError(f"suite {name!r} has no scenarios")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"suite {name!r} has duplicate scenario names")
    fault_pad = max(
        [1] + [len(fault_events_for(base, s)) for s in specs])
    workloads = tuple(
        perturb_workload(base, s, fault_pad=fault_pad) for s in specs)
    return ScenarioSuite(name=name, version=version, specs=specs,
                         workloads=workloads, fault_pad=fault_pad)


def list_suites() -> Dict[str, dict]:
    """Registry overview: name -> {version, size, scenario names}."""
    return {
        name: {"version": SUITE_VERSION, "size": len(specs),
               "scenarios": [s.name for s in specs]}
        for name, specs in sorted(SUITE_SPECS.items())
    }


def get_suite(name: str, base: Workload) -> ScenarioSuite:
    """Materialize a registered suite against ``base``."""
    if name not in SUITE_SPECS:
        raise ValueError(f"unknown scenario suite {name!r}; "
                         f"available: {', '.join(sorted(SUITE_SPECS))}")
    return build_suite(name, SUITE_VERSION, SUITE_SPECS[name], base)
