"""Population-parallel fitness evaluation."""
from fks_tpu_torch.parallel.population import (
    fitness, fused_runner, make_population_eval,
)

__all__ = ["fitness", "fused_runner", "make_population_eval"]
