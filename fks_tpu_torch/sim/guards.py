"""Numerics watchdog guards: mask-and-flag NaN/Inf/range detection.

Port of fks_tpu.sim.guards, batched over lanes. Violations accumulate as a
sticky int32 bitmask per lane (``numeric_flags`` in the engine states,
surfaced in ``SimResult.numeric_flags``), so one lane's NaN never marks a
sibling lane. A flagged score is masked to 0, the engines' "refuse"
sentinel; for finite inputs the guards are the identity, so an enabled
watchdog changes no result unless a violation fires. All guards are gated
on ``SimConfig.watchdog``: disabled, they add no operation to the step.
"""
from __future__ import annotations

from typing import List

import torch

#: sticky violation bits carried in ``numeric_flags``
FLAG_NAN = 1    # a policy score or the fitness was NaN
FLAG_INF = 2    # ... was +/-Inf
FLAG_RANGE = 4  # the final fitness left [0, 1]

FLAG_NAMES = ((FLAG_NAN, "nan"), (FLAG_INF, "inf"), (FLAG_RANGE, "range"))


def describe_flags(mask: int) -> List[str]:
    """Human-readable names for a violation bitmask (host-side)."""
    return [name for bit, name in FLAG_NAMES if int(mask) & bit]


def score_flags(raw_scores: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """i32[L] violation bitmask of one policy invocation's node scores
    ``[L, N]``. ``gate`` bool[L] is the step's "this score is consumed"
    predicate (the engines' ``create``). Integer scores cannot hold
    NaN/Inf: their flags are zero."""
    if not raw_scores.is_floating_point():
        return torch.zeros(gate.shape, dtype=torch.int32, device=gate.device)
    flags = (torch.isnan(raw_scores).any(dim=-1).to(torch.int32) * FLAG_NAN
             + torch.isinf(raw_scores).any(dim=-1).to(torch.int32) * FLAG_INF)
    return torch.where(gate, flags, 0)


def sanitize_scores(raw_scores: torch.Tensor) -> torch.Tensor:
    """Mask non-finite policy scores to 0 ("refuse placement"). Identity
    for finite inputs; integer scores are returned as they are."""
    if not raw_scores.is_floating_point():
        return raw_scores
    return torch.where(torch.isfinite(raw_scores), raw_scores,
                       torch.zeros_like(raw_scores))


def guard_scores(raw_scores, gate, numeric_flags, *, enabled: bool):
    """The engines' per-invocation watchdog step: fold this invocation's
    violation bits into the sticky per-lane mask, then sanitize. Returns
    ``(scores, numeric_flags)``, unchanged when ``enabled`` is False."""
    if not enabled:
        return raw_scores, numeric_flags
    return (sanitize_scores(raw_scores),
            numeric_flags | score_flags(raw_scores, gate))


def fitness_flags(score: torch.Tensor) -> torch.Tensor:
    """i32 violation bitmask of final fitness values (any shape): NaN, Inf,
    or outside the [0, 1] fitness range."""
    nan = torch.isnan(score)
    inf = torch.isinf(score)
    rng = ~nan & ~inf & ((score < 0) | (score > 1))
    return (nan.to(torch.int32) * FLAG_NAN + inf.to(torch.int32) * FLAG_INF
            + rng.to(torch.int32) * FLAG_RANGE)
