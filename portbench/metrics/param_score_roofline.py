"""``param_score``'s share of its roofline: one call scores every lane's
pod against every node (``roofline.counts``), against the card's peaks,
over the call's time in the profiler's trace."""
from statistics import mean

from portbench.roofline import counts, peaks


def read(rec):
    times = rec.get("kernel_seconds", {}).get("param_score")
    if not times:
        return None
    s = rec["shapes"]
    return peaks.roofline_pct(counts.param_score_ops(s["pop"], s["n"]),
                              counts.param_score_bytes(s["pop"], s["n"],
                                                       s["g"]),
                              mean(times))
