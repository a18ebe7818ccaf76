"""Device-resident parametric evolution over a mesh.

Port of fks_tpu.funsearch.device_evolution.ParametricEvolution. Each
generation is ``parallel.mesh.make_sharded_generation_step``: evaluate the
population shard by shard, gather the scores, take the top-k elites (pad
slots masked), keep the elites in the leading slots and mutate the rest
from a random elite. Without a mesh the population runs on a one-shard
``population_mesh`` over the resolved device, as fks_tpu builds one over
its devices. The weights stay on the lead device; only the
per-generation scores reach the host, for logging.
``save_checkpoint``/``restore_checkpoint`` keep fks_tpu's ``.npz`` field
names; ``key`` holds the state of the instance's ``torch.Generator``
(uint8), which draws each generation's seed, so a restored run continues
bit for bit as the uninterrupted one would. An fks_tpu checkpoint crosses
over through ``convert.device_evolution_state_from_npz`` (its JAX PRNG key
does not).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

__all__ = ["DeviceGenStats", "ParametricEvolution", "next_generation",
           "top_k_real"]

import numpy as np
import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.models import parametric
from fks_tpu_torch.parallel.mesh import (
    Mesh, lead_device, make_sharded_generation_step, next_generation,
    population_mesh, top_k_real,
)
from fks_tpu_torch.parallel.population import pad_population
from fks_tpu_torch.sim.engine import SimConfig


@dataclasses.dataclass
class DeviceGenStats:
    generation: int
    best_score: float
    mean_score: float


class ParametricEvolution:
    """Weight-space evolution whose population stays on the device(s).

    ``mesh`` (a ``parallel.mesh.Mesh``) shards the population; the
    population is padded to a multiple of its shard count and the pad
    lanes never become elites or parents. ``device`` places the default
    one-shard mesh; with a mesh the weights live on its lead device."""

    def __init__(self, workload: Workload, pop_size: int = 64,
                 elite_k: int = 4, noise: float = 0.05,
                 cfg: SimConfig = SimConfig(), engine: str = "exact",
                 seed: int = 0, init_noise: float = 0.1, device=None,
                 mesh=None):
        if mesh is None:
            mesh = population_mesh([resolve_device(device)])
        elif not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.device = lead_device(mesh)
        self._step = make_sharded_generation_step(
            workload, mesh, cfg=cfg, elite_k=elite_k, noise=noise,
            engine=engine)
        self.eval = self._step.results
        self.elite_k = elite_k
        self.noise = noise
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.params, self.real_count = pad_population(
            parametric.init_population(self.generator, pop_size,
                                       noise=init_noise), mesh)
        self.generation = 0
        self.history: List[DeviceGenStats] = []
        self.best_score = float("-inf")
        self._best_params = None

    def step(self):
        """One generation: (new_params, scores, elite_scores). The step's
        seed comes from the instance's generator."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                                 device=self.device))
        return self._step(self.params, seed, self.real_count)

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
