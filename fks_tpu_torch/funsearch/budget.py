"""Successive-halving eval-budget allocation over scenario suites.

Port of fks_tpu.funsearch.budget. Suite mode spends the full ``default8``
x full-trace budget on every candidate in every generation, including
obvious duds that a 3-scenario smoke pass or a truncated trace prefix
already ranks at the bottom. This layer sits between candidate
generation and ``scenarios.robust.make_suite_eval`` and spends the
budget in rungs:

- **rung 0 (probe)**: the WHOLE generation is scored on a cheap probe —
  the ``probe_suite`` (default ``smoke3``) and/or a truncated trace
  prefix (``probe_steps`` caps the event budget, so a probe run stops
  after ``probe_steps`` events and reports ``truncated=True``). The probe
  scores under ``SimConfig.probe_score``: fitness is the utilization
  integral over the consumed prefix instead of the full-run gate that
  zeroes truncated runs.
- **rung 1 (full)**: only the top ``1/eta`` fraction by probe robust
  score advances to the full suite + full trace + the configured robust
  aggregation. Pruned candidates keep their probe score, capped below the
  worst survivor's full-suite score, so a pruned dud can never out-rank a
  fully-evaluated survivor.

Every rung is ONE batched launch on a bucketed shape: lane counts are
powers of two (``vm.bucket_lanes``) and survivor sets are re-padded onto
the bucket with ``parallel.pad_population`` (repeating the last
survivor), so on the card each rung captures one CUDA graph per (bucket,
capacity) pair, never one per generation. One ``.cpu()`` copy of each
rung's ``SimResult`` brings the generation to the host, and the
``budget_rung`` span closes after it, so its seconds hold the device
work.

Correctness is audited by ``obs.watchdog.ParitySentinel.check_champion``:
pruning may never change which candidate wins a generation, only how
cheaply.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.sim.types import map_tensors

SCHEDULES = ("none", "halving")


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    """Static eval-budget knobs (EvolutionConfig.budget_* / cli evolve
    --budget)."""

    schedule: str = "none"  # "none" = full suite for everyone (pre-budget)
    eta: int = 2  # survivor fraction denominator: keep ceil(n/eta)
    probe_suite: str = "smoke3"  # rung-0 suite name (scenarios.SUITE_SPECS)
    probe_steps: int = 0  # rung-0 event budget; 0 = full trace on the probe
    min_survivors: int = 1  # never prune below this many full evaluations

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown budget schedule {self.schedule!r}; "
                f"one of {', '.join(SCHEDULES)}")
        if self.eta < 2:
            raise ValueError(f"eta must be >= 2 (got {self.eta}): "
                             "eta=1 advances everyone — use schedule='none'")
        if self.probe_steps < 0:
            raise ValueError(
                f"probe_steps must be >= 0 (0 = full trace on the probe), "
                f"got {self.probe_steps}")
        if self.min_survivors < 1:
            raise ValueError(
                f"min_survivors must be >= 1, got {self.min_survivors}")

    @property
    def enabled(self) -> bool:
        return self.schedule != "none"

    def survivors(self, n: int) -> int:
        """How many of ``n`` candidates advance to the full rung."""
        return min(n, max(self.min_survivors, -(-n // self.eta)))

    def describe(self) -> dict:
        return {"schedule": self.schedule, "eta": self.eta,
                "probe_suite": self.probe_suite,
                "probe_steps": self.probe_steps,
                "min_survivors": self.min_survivors}


@dataclasses.dataclass
class RungStats:
    """Per-rung accounting for the ledger / OpenMetrics ``budget_rung``
    records: who entered, who survived, what the rung cost on device."""

    rung: int
    entered: int
    survived: int
    device_seconds: float
    segments: int = 0
    lanes: int = 0  # padded lane count actually launched

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BudgetOutcome:
    """One generation's budgeted evaluation: per-candidate results in
    input order (full-suite results for survivors, probe results for the
    pruned), plus the bookkeeping the records/ledger need."""

    results: List[object]  # host SimResult slices, one per input candidate
    pruned: List[bool]
    probe_scores: List[float]  # rung-0 robust aggregate, every candidate
    survivor_indices: List[int]
    rungs: List[RungStats]


def probe_sim_config(cfg, budget: BudgetConfig):
    """The rung-0 SimConfig: probe scoring on (partial-prefix fitness
    instead of the zero-on-truncation gate) and, when ``probe_steps`` is
    set, the event budget capped at the prefix length."""
    fields = {"probe_score": True}
    if budget.probe_steps > 0:
        fields["max_steps"] = budget.probe_steps
    return dataclasses.replace(cfg, **fields)


class BudgetedSuiteEval:
    """The rung ladder over the batched VM suite tier (see module
    docstring), on ``device`` (default ``cuda``). Owns the probe-rung
    runner; the full-suite runner is INJECTED (``full_runner``) so the
    full rung shares the population suite runner (and its captured
    graphs) of the unbudgeted path — turning the budget on adds one
    runner (the probe), not a second full-suite one.
    """

    def __init__(self, workload, cfg, budget: BudgetConfig, robust,
                 full_runner: Callable, engine: str = "exact",
                 n_shards: int = 1,
                 segment_counter: Optional[Callable[[], int]] = None,
                 device=None):
        from fks_tpu_torch.scenarios import get_suite

        self.device = resolve_device(device)
        self.budget = budget
        self.robust = robust
        self.engine = engine
        self.n_shards = n_shards
        self._full_runner = full_runner
        self._segment_counter = segment_counter or (lambda: 0)
        self._probe_suite = get_suite(budget.probe_suite,
                                      workload.to(self.device))
        self._probe_cfg = probe_sim_config(cfg, budget)
        self._probe_run = None  # lazily built probe population runner

    def _probe_runner(self):
        if self._probe_run is None:
            from fks_tpu_torch.funsearch import vm
            from fks_tpu_torch.scenarios.robust import make_suite_eval
            self._probe_run = make_suite_eval(
                self._probe_suite, vm.score_static, self._probe_cfg,
                population=True, engine=self.engine, device=self.device)
        return self._probe_run

    def _launch(self, rung: int, progs, bucket: int, entered: int,
                runner: Callable):
        """Pad a stacked program batch onto its lane bucket and run the
        rung as one batched launch; returns (host result, RungStats)."""
        from fks_tpu_torch.obs import span
        from fks_tpu_torch.parallel.population import pad_population

        padded, _ = pad_population(
            map_tensors(lambda x: x.to(self.device), progs), bucket)
        seg0 = self._segment_counter()
        with span("budget_rung", rung=rung, entered=entered,
                  lanes=bucket) as t:
            result = map_tensors(lambda x: x.cpu(), runner(padded))
        return result, RungStats(
            rung=rung, entered=entered, survived=entered,
            device_seconds=round(t.seconds, 6),
            segments=self._segment_counter() - seg0, lanes=bucket)

    def run(self, progs: Sequence) -> BudgetOutcome:
        """Evaluate lowered VM programs through the rung ladder."""
        from fks_tpu_torch.funsearch import vm
        from fks_tpu_torch.scenarios.robust import aggregate

        n = len(progs)
        k = self.budget.survivors(n)
        stacked = vm.stack_programs(list(progs))
        cap = stacked.opcode.shape[-1]

        # rung 0: the whole generation on the cheap probe
        res0, r0 = self._launch(
            0, stacked, vm.bucket_lanes(n, self.n_shards), n,
            self._probe_runner())
        per0 = res0.policy_score.to(torch.float64)[:n]
        probe_scores = aggregate(per0, self.robust).numpy()
        r0.survived = k

        # survivor selection: top-k by probe robust score, stable under
        # ties (argsort of the negated scores preserves input order), kept
        # in input order so result slicing stays positional
        order = np.argsort(-probe_scores, kind="stable")
        keep = sorted(int(i) for i in order[:k])

        # rung 1: survivors re-stacked at the SAME capacity (shape-stable
        # across generations) and re-padded onto the survivor bucket
        stacked1 = vm.stack_programs([progs[i] for i in keep],
                                     capacity=cap)
        res1, r1 = self._launch(
            1, stacked1, vm.bucket_lanes(k, self.n_shards), k,
            self._full_runner)

        slot = {cand: pos for pos, cand in enumerate(keep)}
        results = [
            map_tensors(lambda x, j=slot[i]: x[j], res1) if i in slot
            else map_tensors(lambda x, j=i: x[j], res0)
            for i in range(n)
        ]
        return BudgetOutcome(
            results=results,
            pruned=[i not in slot for i in range(n)],
            probe_scores=[float(s) for s in probe_scores],
            survivor_indices=keep,
            rungs=[r0, r1])
