"""Microseconds of device time per step of the exact heap engine (every
lane advanced by one event): the traced replays' busy time over the steps
they ran (``GraphedChunk.replays`` x steps per replay)."""


def read(rec):
    tl = rec.get("timeline")
    if tl is None or rec.get("engine") != "exact" \
            or not rec.get("trace_replays") or tl["busy_s"] <= 0:
        return None
    steps = rec["trace_replays"] * rec["steps_per_replay"]
    return 1e6 * tl["busy_s"] / steps
