"""Search the parametric policy space for a champion on a real trace.

Port of fks_tpu's ``tools/discover.py``. It runs the device-resident
weight evolution (``funsearch.device_evolution.ParametricEvolution``,
``SimConfig(track_ctime=False)``) over ``TraceParser().parse_workload()``
on the card, then re-scores the champion through the EXACT engine
(``sim.engine.simulate`` of ``parametric.as_policy(weights)``, the
reference replica) so the reported fitness is comparable to the
reference's published numbers.

The output is fks_tpu's: the stderr progress lines, one ``discover_gen``
row per generation in ``--metrics``, a checkpoint every 10 generations
and at the end, the champion in the discovered-policy schema (``score``,
``generation``, ``code``, ``timestamp``, ``search_score``, ``engine``,
``weights``) as ``<out>/funsearch_<stamp>_score<score>.json``, and that
record without ``code`` as the last stdout line. The port adds one
stderr line, the seconds per generation and of the re-scoring.

``--resume`` takes the port's own checkpoints (``restore_checkpoint``:
the generator state rides along, so a resumed run continues as the
uninterrupted one would) and fks_tpu's, whose ``key`` is a JAX PRNG key
(``uint32[2]``): those load through
``convert.device_evolution_state_from_npz`` and ``load_state``, and the
generator is seeded from ``--seed`` (said on stderr), so the
continuation draws other mutations than fks_tpu's would.

Usage:
  python -m fks_tpu_torch.tools.discover [--engine fused] [--gens 40]
      [--pop 32] [--seed 0] [--out DIR] [--checkpoint CK [--resume]]
      [--init-from CHAMPION.json] [--metrics FILE] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    """fks_tpu's flags and defaults."""
    ap = argparse.ArgumentParser(
        prog="python -m fks_tpu_torch.tools.discover",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default="flat",
                    choices=("exact", "flat", "fused"))
    ap.add_argument("--gens", type=int, default=40)
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--elite-k", type=int, default=4)
    ap.add_argument("--noise", type=float, default=0.08)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path); "
                         "default: the card, raising without one")
    ap.add_argument("--out", default="")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --checkpoint before searching (the "
                         "port's checkpoints or fks_tpu's)")
    ap.add_argument("--init-from", default="",
                    help="champion JSON whose weights seed the population "
                         "(lane 0 exact, others perturbed by --noise) — "
                         "lets a NEW pop size continue a finished search, "
                         "which --resume cannot (size must match)")
    ap.add_argument("--metrics", default="")
    return ap


def resume(pe, path: str, seed: int) -> None:
    """Restore ``pe`` from a checkpoint of either package (module
    docstring)."""
    from fks_tpu_torch import convert

    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as d:
        port_key = d["key"].dtype == np.uint8
    if port_key:
        pe.restore_checkpoint(path)
        return
    state = convert.device_evolution_state_from_npz(npz, device=pe.device)
    if tuple(state["params"].shape) != tuple(pe.params.shape):
        raise ValueError(
            f"checkpoint population shape {tuple(state['params'].shape)} "
            f"!= this instance's {tuple(pe.params.shape)}")
    pe.load_state(state)
    pe.generator.manual_seed(seed)
    print(f"{npz} is an fks_tpu checkpoint: its JAX PRNG key is not "
          f"carried; mutations continue from --seed {seed}",
          file=sys.stderr)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume and args.init_from:
        ap.error("--resume and --init-from are mutually exclusive")

    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.device import resolve_device
    from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.sim.engine import SimConfig, simulate

    dev = resolve_device("cpu" if args.cpu else "cuda")
    wl = TraceParser().parse_workload()
    print(f"workload: {wl.num_nodes} nodes x {wl.num_pods} pods; "
          f"engine={args.engine} pop={args.pop} gens={args.gens}",
          file=sys.stderr, flush=True)

    pe = ParametricEvolution(
        wl, pop_size=args.pop, elite_k=args.elite_k, noise=args.noise,
        cfg=SimConfig(track_ctime=False), engine=args.engine,
        seed=args.seed, device=dev)
    if args.resume:
        resume(pe, args.checkpoint, args.seed)
        print(f"resumed at generation {pe.generation} "
              f"(best {pe.best_score:.4f})", file=sys.stderr)
    elif args.init_from:
        with open(args.init_from) as f:
            champ_doc = json.load(f)
        if "weights" not in champ_doc:
            print(f"error: {args.init_from} has no 'weights' field — it is "
                  "a code-evolved champion (reference schema); --init-from "
                  "needs a parametric champion", file=sys.stderr)
            return 2
        pe.init_from_weights(champ_doc["weights"], noise=args.noise,
                             seed=args.seed + 7)
        print(f"population seeded from {args.init_from} "
              f"(pop {args.pop}, noise {args.noise})", file=sys.stderr)
    t0 = time.time()

    def on_gen(st):
        print(f"gen {st.generation}: best {st.best_score:.4f} "
              f"mean {st.mean_score:.4f} ({time.time() - t0:.0f}s)",
              file=sys.stderr, flush=True)
        if args.metrics:
            with open(args.metrics, "a") as f:
                f.write(json.dumps({
                    "ts": round(time.time(), 1), "kind": "discover_gen",
                    "engine": args.engine, "generation": st.generation,
                    "best": st.best_score, "mean": st.mean_score}) + "\n")
        if args.checkpoint and st.generation % 10 == 0:
            pe.save_checkpoint(args.checkpoint)

    t_search = time.perf_counter()
    gens_before = pe.generation
    pe.run(args.gens, on_generation=on_gen)
    search_s = time.perf_counter() - t_search
    if args.checkpoint:
        pe.save_checkpoint(args.checkpoint)

    # re-score the champion through the exact (reference-replica) engine
    weights = pe.best_params.cpu()
    t_rescore = time.perf_counter()
    exact = simulate(wl, parametric.as_policy(weights), device=dev)
    exact_score = float(exact.policy_score)
    rescore_s = time.perf_counter() - t_rescore
    print(f"champion: search-engine score {pe.best_score:.4f}; EXACT-engine "
          f"score {exact_score:.4f}; scheduled "
          f"{int(exact.scheduled_pods)}/{wl.num_pods}",
          file=sys.stderr, flush=True)
    ran = pe.generation - gens_before
    print(f"timing: {ran} generations in {search_s:.3f} s "
          f"({search_s / max(1, ran):.3f} s per generation); exact "
          f"re-scoring {rescore_s:.3f} s", file=sys.stderr, flush=True)

    # reference discovered-policy schema {score, generation, code,
    # timestamp} + provenance extras, same filename pattern as
    # evolution.save_best_policy so downstream globs pick both up
    stamp = time.strftime("%Y%m%d_%H%M%S")
    result = {
        "score": exact_score,
        "generation": pe.generation,
        "code": parametric.render_code(weights),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "search_score": pe.best_score,
        "engine": args.engine,
        "weights": [float(w) for w in weights],
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(
            args.out, f"funsearch_{stamp}_score{exact_score:.4f}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"saved {path}", file=sys.stderr)
    print(json.dumps({k: v for k, v in result.items() if k != "code"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
