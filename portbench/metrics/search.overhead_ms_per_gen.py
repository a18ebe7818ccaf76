"""Milliseconds of each generation outside the engine's own device work:
over the window's generations, the mean of the ``gen`` span's host
seconds less its ``engine_device_s`` (CUDA events around the fused
kernel's launch, or around each graph replay of the flat engine). That
is the seed draw, state set-up, finalize, selection, mutation and
read-back the search layer adds to the engine's work, the device gaps
between them included (program spans, ``portbench.ring``)."""
from portbench import ring


def read(rec):
    gens = ring.window(rec)
    if gens is None:
        return None
    return 1e3 * (sum(g.seconds for g in gens)
                  - ring.total(gens, "engine_device_s")) / len(gens)
