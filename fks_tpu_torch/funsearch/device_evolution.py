"""Device-resident parametric evolution on one device.

Port of fks_tpu.funsearch.device_evolution.ParametricEvolution. Its
generation step is the single-device form of fks_tpu's
``make_sharded_generation_step`` (parallel/mesh.py:477-525): evaluate the
population, take the top-k elites (pad slots masked, ``_top_k_real``),
keep the elites in the leading slots and mutate the rest from a random
elite. The weights stay on the device; only the per-generation scores
reach the host, for logging. Checkpointing and the mesh wait for later
slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.models import parametric
from fks_tpu_torch.parallel.population import make_population_eval
from fks_tpu_torch.sim.engine import SimConfig


@dataclasses.dataclass
class DeviceGenStats:
    generation: int
    best_score: float
    mean_score: float


def top_k_real(scores: torch.Tensor, real_count: int, k: int):
    """(elite_scores[k], elite_idx[k]): the k best of the first
    ``real_count`` slots, ties to the lower index (``lax.top_k``'s order;
    a stable descending sort guarantees it, ``torch.topk`` does not). When
    ``real_count < k`` the trailing slots repeat the best real candidate
    instead of a pad slot (mesh.py:364-373)."""
    iota = torch.arange(scores.shape[0], device=scores.device)
    masked = torch.where(iota < real_count, scores,
                         torch.full_like(scores, -torch.inf))
    order = torch.sort(masked, descending=True, stable=True)
    elite_scores, elite_idx = order.values[:k], order.indices[:k]
    valid = torch.isfinite(elite_scores)
    return (torch.where(valid, elite_scores, elite_scores[0]),
            torch.where(valid, elite_idx, elite_idx[0]))


def next_generation(params: torch.Tensor, scores: torch.Tensor,
                    elite_k: int,
                    offspring: Callable[[torch.Tensor], torch.Tensor],
                    real_count: Optional[int] = None):
    """Elites survive in the leading slots; every other slot takes the
    offspring ``offspring(elites)`` made for it. Returns (new_params,
    elite_scores)."""
    pop = params.shape[0]
    real = pop if real_count is None else real_count
    elite_scores, elite_idx = top_k_real(scores, real, elite_k)
    elites = params[elite_idx]
    slot = torch.arange(pop, device=params.device)
    survivors = elites[slot.clamp(max=elite_k - 1)]
    new = torch.where((slot < elite_k)[:, None], survivors, offspring(elites))
    return new, elite_scores


class ParametricEvolution:
    """Weight-space evolution whose population stays on one device."""

    def __init__(self, workload: Workload, pop_size: int = 64,
                 elite_k: int = 4, noise: float = 0.05,
                 cfg: SimConfig = SimConfig(), engine: str = "exact",
                 seed: int = 0, init_noise: float = 0.1, device=None):
        self.device = resolve_device(device)
        self.eval = make_population_eval(workload, cfg=cfg, engine=engine,
                                         device=self.device)
        self.elite_k = elite_k
        self.noise = noise
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.params = parametric.init_population(self.generator, pop_size,
                                                 noise=init_noise)
        self.real_count = pop_size
        self.generation = 0
        self.history: List[DeviceGenStats] = []
        self.best_score = float("-inf")
        self._best_params = None

    def step(self):
        """One generation: (new_params, scores, elite_scores)."""
        scores = self.eval(self.params).policy_score
        new, elite_scores = next_generation(
            self.params, scores, self.elite_k,
            lambda elites: parametric.mutate(
                self.generator, elites, self.params.shape[0], self.noise),
            self.real_count)
        return new, scores, elite_scores

    def run(self, generations: int,
            on_generation: Optional[Callable[[DeviceGenStats], None]] = None,
            ) -> DeviceGenStats:
        """Advance ``generations`` steps; params stay on the device."""
        last = None
        for _ in range(generations):
            self.params, scores, elite_scores = self.step()
            self.generation += 1
            # elites survive in the leading slots, so row 0 of the NEW
            # population is the best of this round
            best = float(elite_scores[0])
            if best > self.best_score:
                self.best_score = best
                self._best_params = self.params[0].clone()
            real = scores[: self.real_count]
            last = DeviceGenStats(self.generation, best, float(real.mean()))
            self.history.append(last)
            if on_generation is not None:
                on_generation(last)
        return last

    @property
    def best_params(self) -> torch.Tensor:
        if self._best_params is None:
            raise ValueError("run() has not advanced any generation yet")
        return self._best_params
