"""Candidate-evaluation tier benchmark: the VM vs the transpiled tier vs
parametric populations, on the card.

Port of fks_tpu's ``tools/measure_tiers.py`` (:30-177), with its keys:

  vm_*          one candidate at a time through the funsearch VM
                (``vm_first_s`` includes the capacity bucket's graph
                captures, ``vm_warm_s`` the fastest later candidate)
  vm_batch_*    a generation of candidates as one batched VM launch: the
                first set pays the population graph's captures, the
                second is the steady per-generation cost
  jit_*         the transpiled tier (``use_vm=False``; fks_tpu's jit
                tier): one unseen candidate's transpile + captures + run,
                then a warm rerun
  parametric_*  evals/s of a parametric population (``--pop``)
  exact_*       the exact engine's best_fit on one lane: us per event
  evolve_*      one FakeLLM generation through ``FunSearch``
                (codegen + eval + admission) on the warmed evaluator

Every timing is host wall clock around work that ends in a read of its
result (a host copy, or ``torch.cuda.synchronize`` on the card).
``evolve_xla_compiles`` keeps fks_tpu's name so ``cli compare`` reads
both packages' lines: in the port it counts the CUDA graph captures the
generation made (``obs.CompileWatcher``), the port's counterpart of an
XLA compile.

``measure(workload, ...)`` takes the workload, so a caller can pass a
prefix of the trace, and ``generation=False`` leaves out the FakeLLM
generation and its ``evolve_*`` keys (``chip_smoke.py`` does both); the
command measures the full default trace and the generation, as fks_tpu's
does, and prints one JSON line.

Usage: python -m fks_tpu_torch.tools.measure_tiers [--engine flat]
       [--cpu] [--pop 64] [--candidates 6] [--metrics FILE]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch


def measure(wl, *, engine: str = "flat", pop: int = 64,
            candidates: int = 6, generation: bool = True,
            device=None) -> dict:
    """The tier numbers on ``wl`` (see module docstring) on ``device``
    (default ``cuda``): one dict with fks_tpu's keys, without the
    ``evolve_*`` ones when ``generation`` is false. ``candidates`` must be
    at least 3 (one cold, two warm VM candidates)."""
    from fks_tpu_torch.device import resolve_device
    from fks_tpu_torch.funsearch import (
        CodeEvaluator, EvolutionConfig, FakeLLM, FunSearch, template,
    )
    from fks_tpu_torch.models import parametric, zoo
    from fks_tpu_torch.obs import NULL, CompileWatcher
    from fks_tpu_torch.parallel import make_population_eval
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.tools.profile_step import device_name
    from fks_tpu_torch.utils.profiling import block_until_ready

    if candidates < 3:
        raise ValueError(f"candidates {candidates} < 3: the VM tier needs "
                         "one cold and two warm candidates")
    dev = resolve_device(device)
    wl = wl.to(dev)
    fake = FakeLLM(seed=11, junk_rate=0.0)
    codes = [template.fill_template(fake.complete("x"))
             for _ in range(candidates)]
    out = {"device": device_name(dev), "engine": engine,
           "workload": f"{wl.num_nodes}x{wl.num_pods}"}

    # ---- VM tier: one candidate at a time (the first captures the
    # capacity bucket's graph)
    ev = CodeEvaluator(wl, engine=engine, device=dev)
    t0 = time.perf_counter()
    r0 = ev.evaluate_one(codes[0])
    out["vm_first_s"] = round(time.perf_counter() - t0, 3)
    if not r0.ok:
        raise RuntimeError(f"the first VM candidate failed: {r0.error}")
    times = []
    skipped = 0
    for c in codes[1:]:
        t0 = time.perf_counter()
        r = ev.evaluate_one(c)
        dt = time.perf_counter() - t0
        # only successful VM-tier evaluations enter the timing (a failed
        # record returns in milliseconds)
        if r.ok:
            times.append(dt)
        else:
            skipped += 1
    if ev.compile_count:
        raise RuntimeError("a candidate fell to the transpiled tier")
    if len(times) < 2:
        raise RuntimeError("too few clean candidates to time")
    out["vm_skipped_candidates"] = skipped
    out["vm_warm_s"] = round(min(times), 3)
    out["vm_tier_hits"] = ev.vm_count
    out["vm_evals_per_sec"] = round(1.0 / min(times), 3)

    # ---- batched VM tier: a generation as one launch; two distinct sets,
    # the first pays the population graph's captures
    evb = CodeEvaluator(wl, engine=engine, vm_batch=True, device=dev)
    gen_a = [template.fill_template(fake.complete("x"))
             for _ in range(candidates)]
    gen_b = [template.fill_template(fake.complete("x"))
             for _ in range(candidates)]
    t0 = time.perf_counter()
    recs = evb.evaluate(gen_a)
    out["vm_batch_first_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    recs = evb.evaluate(gen_b)
    dt = time.perf_counter() - t0
    if evb.compile_count:
        raise RuntimeError("a candidate fell to the transpiled tier")
    out["vm_batch_pop"] = len(recs)
    out["vm_batch_launches"] = evb.vm_batch_count
    out["vm_batch_warm_s"] = round(dt, 3)
    out["vm_batch_evals_per_sec"] = round(len(recs) / dt, 3)

    # ---- transpiled tier: an unseen candidate's transpile + captures +
    # run, then the warm rerun
    ev2 = CodeEvaluator(wl, engine=engine, use_vm=False, device=dev)
    t0 = time.perf_counter()
    ev2.evaluate_one(codes[0])
    out["jit_compile_run_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    ev2.evaluate_one(codes[0])
    out["jit_warm_s"] = round(time.perf_counter() - t0, 3)

    # ---- parametric tier
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = parametric.init_population(gen, pop, noise=0.1)
    pev = make_population_eval(wl, cfg=SimConfig(), engine=engine,
                               device=dev)
    block_until_ready(pev(params))  # the captures
    t0 = time.perf_counter()
    block_until_ready(pev(params))
    dt = time.perf_counter() - t0
    out["parametric_pop"] = pop
    out["parametric_sweep_s"] = round(dt, 3)
    out["parametric_evals_per_sec"] = round(pop / dt, 2)

    # ---- the exact engine's best_fit, one lane: us per event. Fault-
    # isolated: a failure records the error and keeps the tier numbers.
    try:
        policy = zoo.ZOO["best_fit"]()
        runfn = make_population_eval(
            wl, param_policy=lambda _p, pod, nodes: policy(pod, nodes),
            cfg=SimConfig(), engine="exact", device=dev)
        one = torch.zeros((1, 1), device=dev)
        block_until_ready(runfn(one))  # the captures
        t0 = time.perf_counter()
        er = block_until_ready(runfn(one))
        dt = time.perf_counter() - t0
        n_ev = int(er.events_processed.sum())
        out["exact_best_fit_s"] = round(dt, 3)
        out["exact_events"] = n_ev
        out["exact_us_per_event"] = round(dt / max(n_ev, 1) * 1e6, 2)
    except Exception as e:  # noqa: BLE001 — keep the tier numbers
        out["exact_error"] = f"{type(e).__name__}: {e}"

    if not generation:
        return out
    # ---- one generation: codegen + eval + admission on the warmed
    # evaluator
    cfg = EvolutionConfig(population_size=12, generations=1, elite_size=3,
                          candidates_per_generation=8, max_workers=8, seed=5,
                          early_stop_threshold=1.1)
    fs = FunSearch(ev, cfg, backend=FakeLLM(seed=5), log=lambda *a: None)
    fs.initialize_population()
    with CompileWatcher(NULL) as watcher:
        t0 = time.perf_counter()
        st = fs.evolve_generation()
        out["evolve_gen_s"] = round(time.perf_counter() - t0, 3)
    out["evolve_gen_candidates"] = st.new_candidates
    out["evolve_cand_per_sec"] = round(st.new_candidates
                                       / max(out["evolve_gen_s"], 1e-9), 3)
    # fks_tpu's name: here the graph captures the generation made (the
    # port's counterpart of an XLA compile), not a cumulative count
    out["evolve_xla_compiles"] = watcher.backend_compile_count
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fks_tpu_torch.tools.measure_tiers",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("exact", "flat"), default="flat")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU's plain path (default: the card, "
                         "raising without one)")
    ap.add_argument("--pop", type=int, default=64)
    ap.add_argument("--candidates", type=int, default=6)
    ap.add_argument("--metrics", default="")
    args = ap.parse_args(argv)
    from fks_tpu_torch.data import TraceParser

    out = measure(TraceParser().parse_workload(), engine=args.engine,
                  pop=args.pop, candidates=args.candidates,
                  device="cpu" if args.cpu else "cuda")
    # one compact line: a stage runner takes the last parsable line
    print(json.dumps(out))
    if args.metrics:
        from fks_tpu_torch.utils.logging import MetricsWriter
        with MetricsWriter(args.metrics) as mw:
            mw.write("tier_benchmark", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
