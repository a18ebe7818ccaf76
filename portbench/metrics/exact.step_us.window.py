"""Microseconds of device time per step of the exact heap engine over the
whole untraced window: the replays' device time (CUDA events around each
replay) over the steps they ran, beside ``exact.step_us``, which times
replays after the window under the profiler (program counters,
``portbench.ring``)."""
from portbench import ring


def read(rec):
    gens = ring.window(rec) if rec.get("engine") == "exact" else None
    if gens is None or not ring.total(gens, "replays"):
        return None
    return 1e6 * ring.total(gens, "engine_device_s") / ring.total(gens,
                                                                  "steps")
