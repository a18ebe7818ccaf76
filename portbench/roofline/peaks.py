"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full 700 W power limit)."""

#: float32 outside the tensor cores, operations per second
FP32_OPS = 67e12
#: HBM3 bandwidth, bytes per second
HBM_BYTES = 3.35e12


def roofline_pct(ops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take for the work (the larger of
    operations over the float32 peak and bytes over the memory peak) as a
    share of the time it took, in percent."""
    return 100.0 * max(ops / FP32_OPS, nbytes / HBM_BYTES) / seconds
