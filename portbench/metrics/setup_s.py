"""Process start to the first timed unit, compilation and captures
included (host clock)."""


def read(rec):
    return rec.get("setup_s")
