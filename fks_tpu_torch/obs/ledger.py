"""The evolution ledger: one record per generation, streamed as written.

Port of fks_tpu.obs.ledger, unchanged in its rows.

Threaded through ``FunSearch.evolve_generation``: the controller calls
``begin_generation()`` before the LLM stage and ``commit(stats)`` after
truncation. Each committed record is the full ``GenerationStats``
(fitness best/median/p10, admit/reject breakdown — dup-suppressed,
sandbox-fail, transpile-fail, rescore-fallback — LLM latency, eval wall
time) plus evaluator counter DELTAS for the generation:

- ``programs_compiled`` — unique programs built (transpiled-tier
                          candidates; a captured CUDA graph on the card);
- ``vm_candidates``     — candidates served by the VM tier (no compile);
- ``vm_batches``        — batched one-launch-per-generation VM launches;
- ``vm_segments``       — host-loop segment dispatches from the segmented
                          (sharded or single-device) batched path;
- ``preflight_rejections``   — candidates the static pre-flight analyzer
                          (analysis.candidate) rejected before sandbox/
                          transpile/compile spent anything on them;
- ``fingerprint_duplicates`` — candidates collapsed onto a batch sibling
                          by the normalized-AST fingerprint;
- ``evals_per_sec``     — generation eval throughput (new candidates over
                          eval wall seconds).

Records land in the run directory's ``metrics.jsonl`` (``kind=
"generation"``) and each commit refreshes the heartbeat file, so an
external watcher sees per-generation liveness. With the NullRecorder the
ledger is pure no-op arithmetic — zero filesystem writes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from fks_tpu_torch.obs.recorder import get_recorder

#: CodeEvaluator counters snapshotted per generation (missing attributes
#: read as 0, so the ledger also accepts reduced evaluator stand-ins)
EVALUATOR_COUNTERS = {
    "compile_count": "programs_compiled",
    "vm_count": "vm_candidates",
    "vm_batch_count": "vm_batches",
    "segments_dispatched": "vm_segments",
    "preflight_rejected": "preflight_rejections",
    "preflight_duplicates": "fingerprint_duplicates",
}


class EvolutionLedger:
    """Per-generation record builder bound to one recorder + evaluator."""

    def __init__(self, recorder=None, evaluator: Any = None):
        self.recorder = recorder if recorder is not None else get_recorder()
        self.evaluator = evaluator
        self._base: Dict[str, int] = self._counters()

    def _counters(self) -> Dict[str, int]:
        if self.evaluator is None:
            return {k: 0 for k in EVALUATOR_COUNTERS}
        return {k: int(getattr(self.evaluator, k, 0))
                for k in EVALUATOR_COUNTERS}

    def begin_generation(self) -> None:
        """Snapshot evaluator counters; deltas are computed at commit."""
        self._base = self._counters()

    def generation_record(self, stats) -> Dict[str, Any]:
        """The full ledger row for ``stats`` (a ``GenerationStats``): the
        dataclass fields verbatim — the ledger and the return value agree
        by construction — plus evaluator counter deltas and throughput."""
        rec: Dict[str, Any] = dataclasses.asdict(stats)
        now = self._counters()
        for counter, name in EVALUATOR_COUNTERS.items():
            rec[name] = now[counter] - self._base.get(counter, 0)
        if stats.eval_seconds > 0:
            rec["evals_per_sec"] = round(
                stats.new_candidates / stats.eval_seconds, 3)
        return rec

    def commit(self, stats) -> Dict[str, Any]:
        """Write the generation record (``metrics.jsonl``) and refresh the
        heartbeat. Returns the record (callers may also stream it to
        ``--metrics``)."""
        rec = self.generation_record(stats)
        self.recorder.metric("generation", rec)
        self.recorder.heartbeat()
        return rec
