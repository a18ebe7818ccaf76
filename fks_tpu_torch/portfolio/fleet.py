"""FleetController: the promotion pipeline, per slot.

Port of fks_tpu.portfolio.fleet. Same state machine, same durable log,
same probation/rollback pricing as ``PromotionController`` — narrowed
to ONE slot of a portfolio:

- the fitness gate compares the candidate against the TARGET SLOT's
  resident champion, not the engine default;
- the shadow build is a ``swap_slot`` into a designated SHADOW SLOT of
  the live graphs (zero graph captures by construction — the slot
  table's shape never changes), and shadow evaluation replays mirrored
  live traffic through that slot while every other slot keeps serving;
- the commit swap is ``swap_slot(target, champ)`` — one slot-table
  copy under the engine's batch lock; the rollback handle is the
  slot's previous ``ChampionSpec`` and probation rollback re-uploads it;
- every promotion-log record (and promotion_event metric) carries a
  ``slot`` field, so the log reads per-slot.

Candidates outside the VM vocabulary are REJECTED here (build_failed):
slot promotion is a table upload by definition, and such champions are
the Router's coverage-fallback concern, not the fleet's.
"""
from __future__ import annotations

from typing import Optional

from fks_tpu_torch.pipeline.controller import (
    PromotionConfig, PromotionController,
)
from fks_tpu_torch.serve.artifact import ChampionSpec


class _SlotView:
    """An engine-shaped view answering through ONE slot of the shared
    graphs — what shadow eval replays traffic through, and what the
    incumbent side of the comparison is narrowed to. Everything but
    ``answer_batch`` delegates to the real engine (envelope, base_pods,
    cluster — the synthetic-query and robust-suite paths read those)."""

    def __init__(self, engine, slot: int):
        self._engine = engine
        self._slot = int(slot)

    def answer_batch(self, pod_lists):
        return self._engine.answer_batch(
            pod_lists, slots=[self._slot] * len(pod_lists))

    @property
    def params(self):  # the robust-suite gate scores THIS slot's program
        return self._engine._slot_progs[self._slot]

    def __getattr__(self, name):
        return getattr(self._engine, name)


class FleetController(PromotionController):
    """Per-slot promotion over a ``PortfolioService``.

    ``slot`` is the lifecycle target; ``shadow_slot`` is the staging
    slot candidates are uploaded into for mirrored-traffic evaluation
    (a spare slot by convention — routing never sends live tenants
    there). The two must differ: a shadow that overwrites its own
    incumbent cannot be compared against it."""

    def __init__(self, service, workload=None, *, slot: int,
                 shadow_slot: int,
                 config: Optional[PromotionConfig] = None, **kw):
        super().__init__(service, workload, config=config, **kw)
        self.slot = int(slot)
        self.shadow_slot = int(shadow_slot)
        n = service.engine.n_slots
        for s, what in ((self.slot, "slot"),
                        (self.shadow_slot, "shadow_slot")):
            if not 0 <= s < n:
                raise ValueError(f"{what} {s} outside portfolio [0, {n})")
        if self.slot == self.shadow_slot:
            raise ValueError(
                f"slot and shadow_slot must differ (both {self.slot})")

    # ----- seams narrowed to the slot

    def _incumbent_spec(self, incumbent) -> ChampionSpec:
        return incumbent.slot_champions[self.slot]

    def _build_shadow(self, champ: ChampionSpec, incumbent, aid: str,
                      path: str):
        """Stage the candidate in the shadow slot of the LIVE graphs —
        a table copy, zero captures. ``VMUnsupported`` propagates to
        the caller's build_failed reject (slot promotion is VM-only; the
        Router's coverage fallback owns non-lowerable champions)."""
        incumbent.swap_slot(self.shadow_slot, champ)
        return _SlotView(incumbent, self.shadow_slot), "vm"

    def _shadow_eval(self, shadow, incumbent, exact_reference: bool = True):
        # compare slot against slot: the incumbent side of the replay is
        # the TARGET slot's champion, not the engine default. The VM
        # parity contract is offline (portfolio_selftest), so no exact
        # reference is captured on the serving process.
        return super()._shadow_eval(shadow, _SlotView(incumbent, self.slot),
                                    exact_reference=False)

    def _commit_swap(self, champ: ChampionSpec, shadow, engine_kind: str):
        return self.service.engine.swap_slot(self.slot, champ)

    def _restore(self, old: ChampionSpec) -> None:
        self.service.engine.swap_slot(self.slot, old)

    def _transition(self, aid: str, state: str, **detail) -> None:
        super()._transition(aid, state, slot=self.slot, **detail)
