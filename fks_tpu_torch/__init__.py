"""fks_tpu_torch — the PyTorch/CUDA port of fks_tpu.

The package mirrors fks_tpu's subpackage layout (``data``, ``sim``,
``ops``, ``models``, ``parallel``, ``funsearch``) so every module has a
counterpart of the same name. It imports ``torch`` and numpy only — never
``jax`` and never ``fks_tpu``; where it needs a host-side helper that lives
in fks_tpu it keeps its own copy.

Idiom: plain functions on tensors, the population ("lane") axis written out
as a leading ``[L, ...]`` batch dimension, dataclasses of tensors in place
of pytrees, an explicit ``device=`` argument, and ``torch.Generator`` for
randomness. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.

Ported so far: the parametric-population main path — trace ingest, the
flat engine, the fused simulation kernel (``csrc/fused_sim.cu``),
population fitness and single-device parametric evolution; the exact heap
engine; robust fitness over scenario suites (``scenarios``,
``parallel.traces``, the decision trace and ``obs.tracing``); code
candidates (``funsearch.sandbox``, ``template``, ``transpiler`` and the
``vm``); and the large-cluster tier (``SimConfig.node_prefilter_k``,
``state_pack``, ``sim.flat.make_segmented_population_run``).
"""
