"""Profiling tools of the port, run as modules on the card:

- ``python -m fks_tpu_torch.tools.profile_step``: each part of the event
  step timed alone (loop floor, heap pop and push, the first-deletion
  scan, the exact step, the flat step and three flat variants) at the
  default trace's shapes, as captured chunks between CUDA events;
- ``python -m fks_tpu_torch.tools.measure_tiers``: the candidate
  evaluation tiers (the VM one at a time and batched, the transpiled
  tier, parametric populations, the exact engine's cost per event, one
  FakeLLM generation).

Ports of fks_tpu's ``tools/profile_step.py`` and ``tools/measure_tiers.py``
with their keys; ``--cpu`` runs either on the CPU's plain path.
"""
