"""The repo's tools, ported, run as modules (on the card unless given
``--cpu``):

- ``python -m fks_tpu_torch.tools.profile_step``: each part of the event
  step timed alone (loop floor, heap pop and push, the first-deletion
  scan, the exact step, the flat step and three flat variants) at the
  default trace's shapes, as captured chunks between CUDA events;
- ``python -m fks_tpu_torch.tools.measure_tiers``: the candidate
  evaluation tiers (the VM one at a time and batched, the transpiled
  tier, parametric populations, the exact engine's cost per event, one
  FakeLLM generation);
- ``python -m fks_tpu_torch.tools.discover``: the parametric champion
  search, re-scored on the exact engine;
- ``python -m fks_tpu_torch.tools.run_full_suite``: the 15 CI gates, the
  port's tests and one evidence row;
- ``python -m fks_tpu_torch.tools.probe_ops`` and ``.probe_floor``: the
  primitive cost model and the per-step floor of a captured loop;
- ``python -m fks_tpu_torch.tools.export_node_yaml``: the node CSV as
  Kubernetes Node manifests.

Ports of fks_tpu's ``tools/`` scripts of the same names, with their keys
and output lines.
"""
