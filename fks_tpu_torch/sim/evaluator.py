"""Evaluator tables: snapshot trigger points on the host.

Copy of fks_tpu.sim.evaluator (host numpy; the port keeps its own copy).
The reference fires a utilization snapshot when ``events_processed /
total_events >= next_threshold``, with ``next_threshold`` accumulated by
repeated float64 addition of the interval, and keeps firing past 100%
because retried events count too. ``snapshot_trigger_table`` precomputes,
for each snapshot ordinal m, the smallest integer event count k with
``float64(k / total) >= t_m``; on the device the check is then
``events_processed >= table[snap_idx]``.
"""
from __future__ import annotations

import numpy as np


def snapshot_trigger_table(total_events: int, max_snapshots: int,
                           interval: float = 0.05) -> np.ndarray:
    """int32[max_snapshots] event-count trigger points (see module doc)."""
    table = np.zeros(max_snapshots, dtype=np.int64)
    threshold = interval  # float64 accumulation, as the reference does
    for m in range(max_snapshots):
        if total_events > 0:
            k = int(np.ceil(threshold * total_events))
            k = max(k, 0)
            # correct for float64 rounding of k / total on either side
            while k > 0 and (k - 1) / total_events >= threshold:
                k -= 1
            while k / total_events < threshold:
                k += 1
        else:
            k = np.iinfo(np.int32).max  # progress pinned to 0 -> never fires
        table[m] = min(k, np.iinfo(np.int32).max)
        threshold += interval
    return table.astype(np.int32)


def max_snapshot_count(max_steps: int, total_events: int,
                       interval: float = 0.05) -> int:
    """Upper bound on snapshots a run of <= max_steps events can take."""
    if total_events <= 0:
        return 1
    return int(np.ceil(max_steps / (interval * total_events))) + 2
