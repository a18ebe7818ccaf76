"""Scalar arithmetic the policies need to reproduce fks_tpu bit for bit.

XLA's CPU backend contracts some float32 multiply-add chains of fks_tpu's
policies into fused multiply-adds (one rounding). PyTorch has no
elementwise FMA, so ``fma_f32`` computes the correctly rounded result from
float64 arithmetic; ``trunc_to_int32`` is the float -> int32 conversion
the policies' ``max(1, int(score))`` uses.
"""
from __future__ import annotations

import math

import torch

# float64 mantissa bits a float32 rounding drops, and their tie pattern
_LOW29 = (1 << 29) - 1
_HALF29 = 1 << 28


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding).

    The product of two float32 values is exact in float64, so the float64
    sum ``s`` has one rounding; rounding ``s`` to float32 again can only
    go wrong when ``s`` sits exactly halfway between two float32 values
    (its low 29 mantissa bits are 1000...0) while the exact sum does not.
    There TwoSum's exact error says which way the exact sum lies, and
    ``s`` moves one float64 ulp toward it, off the tie. (No host sync: the
    correction is computed for every element.) ``b`` may be a Python
    float holding a float32 value."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    tie = ((s.view(torch.int64) & _LOW29) == _HALF29) & (err != 0)
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    s = torch.where(tie, torch.nextafter(s, toward), s)
    return s.float()


def trunc_to_int32(x: torch.Tensor) -> torch.Tensor:
    """``trunc(x)`` as int32 (the cast truncates), clamped into the int32
    range first. float32 cannot hold 2**31 - 1, so its upper clamp is the
    largest float32 below 2**31: a score that large ties with every other
    saturated score either way, so argmax decisions are unchanged."""
    hi = 2**31 - 1 if x.dtype == torch.float64 else 2147483520.0
    return x.clamp(-(2**31), hi).to(torch.int32)
