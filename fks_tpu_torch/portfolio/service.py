"""PortfolioService: the routed request front over a PortfolioEngine.

Port of fks_tpu.portfolio.service. It extends ``ServeService`` at its two
seams only: ``_make_item`` routes every admitted request to a slot
(emitting one ``portfolio_route`` metric) and appends the slot index to
the queue item; ``_answer`` threads the per-request slot list into
``PortfolioEngine.answer_batch`` and splits coverage-fallback requests
off to the kept-warm closure engine, merging answers back positionally
so the batcher's exactly-once Future funnel never notices the fork.
Admission, deadlines, tracing, accounting, audits and SLO burn are
inherited untouched.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from fks_tpu_torch.portfolio.engine import PortfolioEngine
from fks_tpu_torch.portfolio.router import FALLBACK, Router
from fks_tpu_torch.serve.service import ServeService


class PortfolioService(ServeService):
    """Request routing + slot threading over the shared graphs.

    ``fallback_engine`` (a warm closure ``ServeEngine``) arms the
    coverage escape hatch: requests routed to ``FALLBACK`` are answered
    there. Without one, fallback routes go to the router's default slot:
    a portfolio never sheds a request it could answer."""

    def __init__(self, engine: PortfolioEngine, *,
                 router: Optional[Router] = None,
                 fallback_engine=None, **kw):
        super().__init__(engine, **kw)
        self.router = router or Router(engine.n_slots)
        self.fallback_engine = fallback_engine
        self.fallback_served = 0

    # ----- routing (submit thread)

    def _make_item(self, rid: str, pods: List[dict], tenant: str,
                   query: Dict[str, Any]) -> tuple:
        if "slot" in query:  # explicit per-query override (drills, A/B
            # forcing, debugging): validated, reason "query"
            slot, reason = int(query["slot"]), "query"
            if not (slot == FALLBACK
                    or 0 <= slot < self.engine.n_slots):
                raise ValueError(
                    f"slot {slot} outside portfolio "
                    f"[0, {self.engine.n_slots}) and not {FALLBACK}")
            self.router.routed[reason] += 1
        else:
            slot, reason = self.router.route(rid, tenant, pods)
        if slot == FALLBACK and self.fallback_engine is None:
            slot, reason = self.router.default_slot, "default"
        self.recorder.metric("portfolio_route", request_id=rid,
                             tenant=tenant, slot=slot, reason=reason)
        return (rid, pods, tenant, slot)

    # ----- batch handling (batcher thread)

    def _answer(self, engine, items: List[tuple]) -> List[dict]:
        if not hasattr(engine, "swap_slot"):
            # degraded mode flipped the service to a plain fallback
            # engine: slots are meaningless there, serve flat
            return engine.answer_batch([it[1] for it in items])
        slots = [it[3] if len(it) > 3 else self.router.default_slot
                 for it in items]
        fb = [i for i, s in enumerate(slots) if s == FALLBACK]
        if not fb:
            answers = engine.answer_batch([it[1] for it in items],
                                          slots=slots)
            for ans, s in zip(answers, slots):
                ans["slot"] = s
            return answers
        # split the batch: portfolio lanes through the shared graphs,
        # fallback lanes through the closure engine, then merge
        # positionally (the Future funnel is order-addressed)
        answers: List[Optional[dict]] = [None] * len(items)
        keep = [i for i in range(len(items)) if slots[i] != FALLBACK]
        if keep:
            for i, ans in zip(keep, engine.answer_batch(
                    [items[i][1] for i in keep],
                    slots=[slots[i] for i in keep])):
                ans["slot"] = slots[i]
                answers[i] = ans
        for i, ans in zip(fb, self.fallback_engine.answer_batch(
                [items[i][1] for i in fb])):
            ans["slot"] = FALLBACK
            answers[i] = ans
        self.fallback_served += len(fb)
        return answers  # type: ignore[return-value]

    # ----- stats

    def summary(self, record: bool = True) -> dict:
        out = super().summary(record=record)
        eng = self.engine
        if hasattr(eng, "slot_requests"):
            out["portfolio"] = {
                "n_slots": eng.n_slots,
                "slot_requests": list(eng.slot_requests),
                "slot_swaps": list(eng.slot_swaps),
                "fallback_served": self.fallback_served,
                "routes": {k: v for k, v in self.router.routed.items()
                           if v},
            }
        return out
