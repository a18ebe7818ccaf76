"""``search.overhead_ms_per_gen`` of a cell on the flat engine, under a
name of its own: it moves that cell's rate, ``cand_evals_per_s.flat``."""
from portbench import harness


def read(rec):
    return harness.read_metric("search.overhead_ms_per_gen", rec)
