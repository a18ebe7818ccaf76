"""``cand_evals_per_s`` of a cell on the flat engine, under a bound of its
own: the flat engine's replays wait on the host every 16 steps, and its
runs spread several times wider than the fused kernel's."""
from portbench import harness


def read(rec):
    return harness.read_metric("cand_evals_per_s", rec)
