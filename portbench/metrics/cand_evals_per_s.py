"""Candidate policies evaluated on the whole trace per second: every
candidate of every generation completed in the window, over all the
window's time (host clock; the window ends at the last completion)."""


def read(rec):
    if "candidates" not in rec:
        return None
    return rec["candidates"] / rec["window_s"]
