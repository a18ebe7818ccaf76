"""Milliseconds of each generation in which the card ran nothing: the
idle time of a trace that covers the whole window of whole generations,
divided by the generations (profiler timeline and the benchmark's count
of generations)."""


def read(rec):
    tl = rec.get("timeline")
    if tl is None or not rec.get("trace_whole_window"):
        return None
    return 1000.0 * (tl["window_s"] - tl["busy_s"]) / rec["generations"]
