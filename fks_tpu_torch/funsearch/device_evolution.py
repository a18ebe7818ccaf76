"""Device-resident parametric evolution on one device.

Port of fks_tpu.funsearch.device_evolution.ParametricEvolution. Its
generation step is the single-device form of fks_tpu's
``make_sharded_generation_step`` (parallel/mesh.py:477-525): evaluate the
population, take the top-k elites (pad slots masked, ``_top_k_real``),
keep the elites in the leading slots and mutate the rest from a random
elite. The weights stay on the device; only the per-generation scores
reach the host, for logging. ``save_checkpoint``/``restore_checkpoint``
keep fks_tpu's ``.npz`` field names; ``key`` holds the state of the
instance's ``torch.Generator`` (uint8), so a restored run continues bit
for bit as the uninterrupted one would. An fks_tpu checkpoint crosses
over through ``convert.device_evolution_state_from_npz`` (its JAX PRNG key
does not). The mesh waits for the port of ``parallel/mesh.py`` (ROADMAP
queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
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
                 seed: int = 0, init_noise: float = 0.1, device=None,
                 mesh=None):
        if mesh is not None:
            raise ValueError(
                "mesh= (a population sharded over devices) is not ported "
                "yet: it waits for the mesh slice (ROADMAP queue 1 item "
                "3); run on one device")
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

    def best_code(self) -> str:
        """The champion weights rendered as reference-style source."""
        return parametric.render_code(self.best_params.cpu())

    # ------------------------------------------------------------ resume

    def save_checkpoint(self, path: str) -> str:
        """Everything needed to continue deterministically: params, the
        generator state (``key``), champion and history, under fks_tpu's
        field names. Returns the file written (``.npz`` appended when
        missing)."""
        if not path.endswith(".npz"):
            path += ".npz"
        hist = np.array([[h.generation, h.best_score, h.mean_score]
                         for h in self.history], np.float64).reshape(-1, 3)
        best = (self._best_params.cpu().numpy()
                if self._best_params is not None
                else np.zeros(0, np.float32))
        np.savez(path, params=self.params.cpu().numpy(),
                 key=self.generator.get_state().numpy(),
                 generation=self.generation, best_score=self.best_score,
                 best_params=best, real_count=self.real_count, history=hist)
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Restore onto an instance built with the SAME workload, engine
        and pop_size; continuing reproduces the uninterrupted run."""
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as d:
            if d["params"].shape != tuple(self.params.shape):
                raise ValueError(
                    f"checkpoint population shape {d['params'].shape} != "
                    f"this instance's {tuple(self.params.shape)}")
            if d["key"].dtype != np.uint8:
                raise ValueError(
                    f"{path}: key is {d['key'].dtype}, not a torch.Generator "
                    "state (an fks_tpu checkpoint? load it with "
                    "convert.device_evolution_state_from_npz)")
            self.generator.set_state(torch.from_numpy(d["key"].copy()))
            self.load_state({k: d[k] for k in (
                "params", "generation", "best_score", "best_params",
                "real_count", "history")})

    def load_state(self, state) -> None:
        """Population, champion and history from a mapping of fks_tpu's
        checkpoint fields (numpy arrays or tensors); the generator is left
        as it is."""
        self.params = torch.as_tensor(state["params"],
                                      dtype=torch.float32).to(self.device)
        best = torch.as_tensor(state["best_params"], dtype=torch.float32)
        self._best_params = best.to(self.device) if best.numel() else None
        self.generation = int(state["generation"])
        self.best_score = float(state["best_score"])
        self.real_count = int(state["real_count"])
        self.history = [DeviceGenStats(int(g), float(b), float(m))
                        for g, b, m in np.asarray(state["history"]).tolist()]

    def init_from_weights(self, weights, noise: float, seed: int = 0) -> None:
        """Seed the population around one weight vector: lane 0 holds it
        exactly, the rest are Gaussian perturbations at ``noise`` scale
        drawn from a generator seeded with ``seed``. Unlike
        ``restore_checkpoint`` this lets a new population size continue
        from a saved champion (``real_count`` is untouched)."""
        champ = torch.as_tensor(weights, dtype=self.params.dtype).to(
            self.device)
        if tuple(champ.shape) != tuple(self.params.shape[1:]):
            raise ValueError(
                f"champion weight vector has shape {tuple(champ.shape)}; "
                f"this instance's parametric model expects "
                f"{tuple(self.params.shape[1:])}")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        z = torch.randn(self.params.shape, generator=gen,
                        device=self.device, dtype=self.params.dtype)
        perturbed = champ[None, :] + noise * z
        perturbed[0] = champ
        self.params = perturbed
