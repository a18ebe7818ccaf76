"""Resilience: the evolve loop's generation write-ahead log.

Port of the part of fks_tpu.resilience that evolution uses; admission,
drain and the drills wait for the control-plane slice (ROADMAP queue 1).
"""
from fks_tpu_torch.resilience.wal import GenerationWAL

__all__ = ["GenerationWAL"]
