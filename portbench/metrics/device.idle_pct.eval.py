"""Share of the traced window of a search in which no operation ran on
the card (profiler timeline), in percent."""


def read(rec):
    tl = rec.get("timeline")
    if tl is None or "candidates" not in rec:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
