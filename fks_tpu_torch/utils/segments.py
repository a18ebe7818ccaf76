"""Segment-length validation shared by every seg-steps surface.

Port of fks_tpu.utils.segments (a copy: the port imports nothing of
fks_tpu), with the same messages. A segment length is a non-negative
integer number of events; 0 means "do not segment". The segmented runner
(``sim.flat.make_segmented_population_run``), which exists only to
segment, rejects 0 and points at ``make_population_run_fn`` instead.
"""
from __future__ import annotations

from typing import Any


def segment_budget(max_steps: int, seg_steps: int, *, slack: int = 1) -> int:
    """Dispatch budget for a segmented host loop: enough segments to
    consume ``max_steps`` events on a lane that never goes idle, plus
    ``slack`` observation segments. The classic loop needs slack 1 (one
    extra dispatch to OBSERVE the all-done flag after the draining
    segment); the double-buffered loop needs slack 2 (its flag lags one
    segment behind the dispatch front — see
    ``sim.flat.make_segmented_population_run``). Exhausting the budget
    with lanes still active means the step/cond predicates diverged, and
    callers raise rather than spin."""
    return -(-max_steps // seg_steps) + slack


def validate_seg_steps(value: Any, *, source: str = "seg_steps",
                       zero_disables: bool = True) -> int:
    """Validate a segment length and return it as an int.

    ``source`` names the knob in error messages (e.g. the env var).
    ``zero_disables=True`` accepts 0 as "segmentation off"; with False
    (the segmented runner itself) 0 is rejected with a pointer to the
    unsegmented entry point.
    """
    try:
        steps = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{source} must be an integer (segment length in events; "
            f"0 disables segmentation), got {value!r}") from None
    if steps < 0:
        raise ValueError(
            f"{source} must be >= 0 (0 disables segmentation), got {steps}")
    if steps == 0 and not zero_disables:
        raise ValueError(
            f"{source} must be positive, got {steps}; to disable "
            "segmentation use make_population_run_fn")
    return steps
