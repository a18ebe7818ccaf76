"""Percent of the exact heap engine's lane-steps in the untraced window
that did work: the steps each lane was active (``lane_steps``, which
``sim.engine.drain`` reads once a job is done) over the lane-steps its
advances ran (``lane_slots``: each advance steps every lane of its job,
padded lanes too). A batched step costs the same for a lane that has
finished, so the rest is work spent on finished lanes (program counters,
``portbench.ring``)."""
from portbench import ring


def read(rec):
    gens = ring.window(rec) if rec.get("engine") == "exact" else None
    if gens is None or not ring.total(gens, "lane_slots"):
        return None
    return 100.0 * ring.total(gens, "lane_steps") / ring.total(gens,
                                                                "lane_slots")
