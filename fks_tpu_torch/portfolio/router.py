"""Router: request -> portfolio slot (or the fallback engine).

Port of fks_tpu.portfolio.router. Routing is a short, deterministic rule
chain priced per request:

1. ``pin``      — explicit tenant -> slot map (contractual placement);
2. ``affinity`` — workload-class fingerprint -> slot map
   (``obs.workload.QueryFingerprinter``): queries of the pod-shape class
   a champion was promoted for keep landing on it;
3. ``ab``       — weighted split over slots, keyed by a blake2b hash of
   the request id, so an experiment's assignment is repeatable (the same
   request id always lands on the same arm);
4. ``default``  — the default slot.

A rule may resolve to ``FALLBACK`` (-1): the champion behind that pin is
outside the VM vocabulary (``vm_coverage_split``), and the request is
served by the kept-warm closure ``ServeEngine`` instead, reason
``fallback``. Every decision is one ``portfolio_route`` metric
(request_id / tenant / slot / reason).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from fks_tpu_torch.funsearch import vm
from fks_tpu_torch.obs.workload import QueryFingerprinter

#: slot sentinel: serve this request on the fallback engine
FALLBACK = -1

#: closed reason vocabulary (fks_tpu's, mirrored in its schema checker)
ROUTE_REASONS = ("pin", "affinity", "ab", "default", "fallback", "query")


class Router:
    """Maps (request_id, tenant, pods) to a portfolio slot."""

    def __init__(self, n_slots: int, *, default_slot: int = 0,
                 pins: Optional[Dict[str, int]] = None,
                 affinity: Optional[Dict[str, int]] = None,
                 ab_split: Optional[Dict[int, float]] = None):
        self.n_slots = int(n_slots)
        self.default_slot = int(default_slot)
        self.pins = dict(pins or {})
        self.affinity = dict(affinity or {})
        for name, slot in list(self.pins.items()) + \
                list(self.affinity.items()):
            self._check_slot(slot, f"rule for {name!r}")
        self._check_slot(self.default_slot, "default_slot")
        # normalized cumulative weights, stable slot order
        self._split: List[Tuple[int, float]] = []
        if ab_split:
            total = float(sum(ab_split.values()))
            if total <= 0:
                raise ValueError("ab_split weights must sum > 0")
            for slot in sorted(ab_split):
                self._check_slot(slot, "ab_split")
                self._split.append((int(slot), ab_split[slot] / total))
        self._fp = QueryFingerprinter()
        self.routed: Dict[str, int] = {r: 0 for r in ROUTE_REASONS}

    def _check_slot(self, slot: int, what: str) -> None:
        if not (slot == FALLBACK or 0 <= int(slot) < self.n_slots):
            raise ValueError(f"{what}: slot {slot} outside portfolio "
                             f"[0, {self.n_slots}) and not FALLBACK")

    @staticmethod
    def _hash01(rid: str) -> float:
        """Request id -> [0, 1): deterministic, uniform, replayable."""
        h = hashlib.blake2b(rid.encode(), digest_size=8).digest()
        return int.from_bytes(h, "big") / float(1 << 64)

    def route(self, rid: str, tenant: str,
              pods: Sequence[dict]) -> Tuple[int, str]:
        """One routing decision -> (slot, reason). ``FALLBACK`` slots
        keep their originating rule's intent but report reason
        ``fallback``: the observable fact is where the request went."""
        slot, reason = self.default_slot, "default"
        if tenant in self.pins:
            slot, reason = self.pins[tenant], "pin"
        elif self.affinity and \
                (hit := self.affinity.get(self._fp.classify(pods))) \
                is not None:
            slot, reason = hit, "affinity"
        elif self._split:
            x = self._hash01(rid)
            cum = 0.0
            slot, reason = self._split[-1][0], "ab"
            for s, w in self._split:
                cum += w
                if x < cum:
                    slot = s
                    break
        if slot == FALLBACK:
            reason = "fallback"
        self.routed[reason] += 1
        return int(slot), reason


def vm_coverage_split(champions, n: int, g: int):
    """Partition champions by VM lowerability at cluster shape (n, g):
    ``(resident, fallback)``. Resident champions go into portfolio
    slots; fallback champions stay on the kept-warm closure
    ``ServeEngine`` (the Router pins their tenants to ``FALLBACK``)."""
    resident, fallback = [], []
    for c in champions:
        try:
            vm.compile_policy(c.code, n, g)
            resident.append(c)
        except vm.VMUnsupported:
            fallback.append(c)
    return resident, fallback
