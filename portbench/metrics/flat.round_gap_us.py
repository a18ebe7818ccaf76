"""Microseconds of device time between one graph replay of the flat
engine and the next, per round of its drain loop: the gaps that CUDA
events around each replay measure (the flag reduction, its read, the
host's wake and the next launch), summed over the window's rounds and
divided by the rounds (program counters, ``portbench.ring``)."""
from portbench import ring


def read(rec):
    gens = ring.window(rec)
    if gens is None or not ring.total(gens, "replays"):
        return None
    return 1e6 * ring.total(gens, "round_gap_s") / ring.total(gens, "rounds")
