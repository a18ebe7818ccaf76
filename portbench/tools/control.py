"""Readings that a cell's limits are set from, on the card.

    python3 -m portbench.tools.control --workload <cell> \
        --seeds 11,12,...  --control-seeds 3 --seconds 3 --out FILE

For every seed it runs the cell as the benchmark does (set-up, a short
window, the check) and records the compared numbers of that sound run
(the lower readings). For the first ``--control-seeds`` seeds it then
puts the control in the program's place: the plain reference computed one
precision below the configuration's, on the same candidates,
compared with the reference by the same comparison (the upper
readings). A search cell's policy arithmetic is float32, so its control
is bfloat16. One JSON line per seed goes to ``--out`` and to standard
output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.tools.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from portbench import harness
    from portbench.loops import inputs, search
    from portbench.reference import flat_sim

    root = Path.cwd()
    cell = harness.find_cell(harness.load_benchmark(root), args.workload)
    cfg = harness.load_json("configs", cell["config"])
    sim = cfg["sim"]
    cluster, pods, _ = inputs.reference_inputs(cfg)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        line, rec = harness.run_cell(root, args.workload, seed,
                                     args.seconds, False)
        row = {"seed": seed, "correct": line["correct"],
               "program": {k: v["value"] for k, v in line["checks"].items()},
               "lanes": rec.get("checked_lanes"),
               "reference_s": rec["reference_s"],
               "reference_steps": rec.get("reference_steps"),
               "run_s": time.perf_counter() - t0}
        if i < args.control_seeds:
            t = time.perf_counter()
            low = flat_sim.run(cluster, pods, rec["checked_weights"],
                               max_steps_factor=sim["max_steps_factor"],
                               snapshot_interval=sim["snapshot_interval"],
                               precision="bfloat16")
            bad, gap = search.compare(low, rec["reference_results"])
            row["control"] = {"int_mismatch": bad, "fitness_gap": gap}
            row["control_s"] = time.perf_counter() - t
        text = json.dumps(row)
        print(text, flush=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
