"""The program's own spans of a run's window: the ring of closed spans
that ``fks_tpu_torch.obs.spans`` keeps in memory, read by the metrics
whose source is ``program_span`` or ``program_counter``.

The loop runs no generation after its window (the flat cell's traced
replays drive ``LaneJob`` directly and open no span), so the window's
generations are the last ``rec["generations"]`` ``gen`` spans of the
ring. Each carries what was taken while it was open: its host
``seconds`` and the counters of its stages, ``engine_device_s`` (CUDA
events around the fused kernel's launch or each graph replay), and the
drain loop's ``rounds``, ``replays``, ``steps`` and ``round_gap_s``.
"""
from __future__ import annotations

from typing import List, Optional


def window(rec: dict) -> Optional[List]:
    """The window's ``gen`` records, oldest first; None where the run has
    no generations, where the program keeps no ring (a commit before
    it), where the ring no longer holds every one of them, or where a
    device time is missing (the CPU)."""
    n = rec.get("generations")
    if not n:
        return None
    from fks_tpu_torch.obs import spans

    if not hasattr(spans, "ring"):
        return None
    gens = [r for r in list(spans.ring()) if r.label == "gen"]
    if len(gens) < n:
        return None
    gens = gens[-n:]
    if any("engine_device_s" not in g.counters for g in gens):
        return None
    return gens


def total(gens: List, counter: str) -> float:
    """A counter summed over the records (0 where none has it)."""
    return sum(g.counters.get(counter, 0) for g in gens)
