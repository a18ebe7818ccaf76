"""The continuous evolve -> serve promotion pipeline.

Port of fks_tpu.pipeline. A ``PromotionController`` tails the champion
ledger, shadow-evaluates each new candidate against replayed live
traffic (parity + p99 + SLO burn + optional robust scenario suite),
hot-swaps the warm engine on promotion, rolls back on post-promotion SLO
burn, and records every attempt in a crash-safe append-only
``promotion.jsonl`` state machine (``pipeline.state``). ``FaultPlan`` +
``run_drills`` are the deterministic chaos harness proving each failure
mode degrades gracefully.

- ``state``      — PromotionLog: the durable PENDING->SHADOW->PROMOTED/
                   REJECTED/ROLLED_BACK record, kill -9 recoverable
- ``controller`` — PromotionController + PromotionConfig + the
                   ``serve --follow-ledger`` poll thread
- ``faults``     — FaultPlan / KillSwitch / OutageBackend injection
                   primitives (pure host)
- ``drills``     — the deterministic drill matrix (``cli pipeline
                   --drill``)
"""
from fks_tpu_torch.pipeline.controller import (
    PromotionConfig, PromotionController, attempt_id, follow_ledger,
)
from fks_tpu_torch.pipeline.drills import run_drills
from fks_tpu_torch.pipeline.faults import (
    FaultInjected, FaultPlan, KillSwitch, OutageBackend, write_champion,
    write_corrupt_champion,
)
from fks_tpu_torch.pipeline.state import STATES, TERMINAL, PromotionLog

__all__ = [
    "STATES", "TERMINAL", "FaultInjected", "FaultPlan", "KillSwitch",
    "OutageBackend", "PromotionConfig", "PromotionController",
    "PromotionLog", "attempt_id", "follow_ledger", "run_drills",
    "write_champion", "write_corrupt_champion",
]
