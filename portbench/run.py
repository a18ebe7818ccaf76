"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, on a machine
with as many CUDA cards as the cell asks for. The run sets up the cell
(``setup_s``), measures for ``--seconds``, checks what the measured path
produced against the plain reference, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit, which also end
standard error. Without the cards, or with a JAX module loaded, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    root = Path.cwd()
    # build and kernel caches inside the checkout, at fixed paths
    cache = root / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    from portbench import harness

    cell = harness.find_cell(harness.load_benchmark(root), args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, rec = harness.run_cell(root, args.workload, args.seed,
                                 args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules the run may not load: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line["device"] = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": cell["chips"], **line["device"]}
    info = {k: v for k, v in rec.items()
            if isinstance(v, (int, float, str, bool))}
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    print(f"run: {json.dumps(info)}", file=sys.stderr)
    for name, value, limit in rec["checks"]:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
