"""``fused_sim``'s share of its roofline: per launch, the node sweeps of
the CREATE events its lanes processed and its bytes
(``roofline.counts``), against the card's peaks (``roofline.peaks``),
over the launch's time in the profiler's trace."""
from statistics import mean

from portbench.roofline import counts, peaks


def read(rec):
    times = rec.get("kernel_seconds", {}).get("fused_sim")
    work = rec.get("scored_events")
    if not times or not work:
        return None
    s = rec["shapes"]
    ops = counts.fused_sim_ops(mean(work), s["n"])
    nbytes = counts.fused_sim_bytes(s["pop"], s["q"], s["n"], s["g"],
                                    s["klen"])
    return peaks.roofline_pct(ops, nbytes, mean(times))
