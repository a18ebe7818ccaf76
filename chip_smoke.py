#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fks_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build ``fks_tpu_torch/csrc/fused_sim.cu`` and ``param_score.cu`` for
   sm_90a (one ``nvcc`` each, started together) and print the ``-Xptxas
   -v`` reports (registers, shared memory, spills); spills fail;
3. hold the kernel against its plain PyTorch version on the card, on the
   same inputs: integer outputs exact, float outputs within 2e-6
   (rtol and atol), on the roomy and contended workloads of fks_tpu's
   tests/test_fused.py, the tied workload (equal times across queue
   chunks, retries onto held times), the multigpu50 and cpu250 OpenB
   traces at pop 8 cut to 2,000 steps (multi-GPU picks, retry storms,
   chunk counts that are not a multiple of 32); the full default trace is
   compared in phase 4, at pop 256 (its pop-8 check here was cut to make
   room for phase 12);
4. the main path: ``make_population_eval(engine="fused")`` on the full
   default trace (16 nodes x 8,152 pods) at pop 256 — the seeds plus
   jitter, with the 0.5365 champion's weights in one lane — timed, its
   launch count read, the lane-step distribution (``acci[:, 1]``) and the
   kernel time per step of the longest lane reported, and the kernel's raw
   outputs held against the plain version at the same inputs;
4b. the parametric score kernel (``csrc/param_score.cu``, what
   ``parametric.score`` launches on a CUDA tensor) against its plain
   version on 4 x 256 random views at N = 16 and N = 1,000 and on
   ``testing.param_score_cases`` (L in 1, 3, 256 x N in 1, 15, 16, 17,
   1,000 x G in 1, 8, 32: shared and per-lane tables and weights,
   scattered masks, milli totals other than 1,000, unfit pods, strided
   views) in float32 and float64 (max abs difference 0, also against the
   CPU); at 256 x 16 (the main path), 1 x 16, 1 x 1,000, 4 x 1,000 and
   256 x 1,000 its time per call as a one-call graph replay and as the
   marginal time of 32 calls in one graph (CUDA events, replays queued
   behind a spin), beside an empty kernel of the same launch (the floor),
   the plain version's time and the bound; and the auto-prefilter probe
   at N = 1,000: k = 0 for ``parametric.score``, k = 64 for
   ``vm.score_static``; its launches are then counted from 0 around
   phases 6, 8, 10 and 11 (each must launch it). ``param_score_phase``
   runs alone too (it builds its kernel);
5. (``ParametricEvolution`` on the fused engine, 3 generations at pop
   256: folded into phase 17 (a), 20 generations through the discover
   tool);
6. the exact heap engine (plain PyTorch ops, and ``param_score`` for the
   parametric policy; ``SYNC_EVERY`` steps per captured CUDA graph): ``golden_micro`` through
   ``micro_best_fit``; the full default trace through ``best_fit`` and
   ``funsearch_4901`` in float64, held to ``golden_default.json``
   (integers exact, floats within 1e-9), the best_fit run driven step by
   step under ``torch.cuda.set_sync_debug_mode("error")`` for its eager
   steps and graph replays; ``make_population_eval(engine="exact")`` at
   pop 256 on phase 4's population (the parametric policy through the
   ``param_score`` kernel) (lane 4 alone against its batched result was
   cut for phase 17, whose (b) holds the exact engine's batched search
   score to the champion re-scored alone; lane 0 alone was cut for phase
   12);
7. the policies on the card: every zoo policy (``ZOO``,
   ``BASELINE_FACTORIES``, ``micro_best_fit``) and ``parametric.score``,
   in float32 and float64, on 4 x 256 random views; the integer scores
   must equal the same views scored on the CPU;
8. scenario suites (plain PyTorch ops replayed as CUDA graphs, the
   parametric policy through ``param_score``): ``golden_scenario_fault.
   json`` through the exact and flat
   engines with first_fit and best_fit, held to its pins (score within
   1e-5; counts, the per-CREATE assignments from the decision trace and
   the fault rows exact); ``default8`` on the full default trace through
   the exact engine for the first 32 of phase 4's population (256 lanes),
   timed, with the champion's eight scores and its mean, min and
   CVaR-0.25 robust scores; the champion alone on ``fault2`` (1 lane),
   equal to its batched result exactly (its 8-lane rerun of the whole
   suite was cut for phase 12); ``default8``
   through the flat engine for the champion, timed; the champion's
   decision trace on ``fault1`` (its score equals the untraced run, its
   fault rows the scenario's fault count) and ``trace_diff`` of the exact
   engine against itself (no divergence);
9. code candidates at the default cluster's width (16 nodes, G = 8; plain
   PyTorch, no hand kernel): the two template seeds and the 13
   discovered champions, transpiled and lowered to the funsearch VM, in
   float64 and float32 on 4 x 256 random views — the VM's integer scores
   on the card equal the transpiled policy's on the card and on the CPU;
   the 15 programs stacked (capacity 512, 16 lanes) through the exact
   engine (the flat engine's run was cut for phase 17) in float64 on the
   first 512 pods of the default trace,
   every lane's score, scheduled pods and events held to
   ``tests/fixtures/vm_prefix512_pins.json`` (fks_tpu's VM population),
   timed: seconds per eval, the longest lane's steps, ms per step (graph
   replays), us per op slot and candidate evals/s; the 0.5365 champion
   alone through the transpiled tier equal to its batched lane;
10. 1,000 nodes (``bench.py::stage_scale1k``'s shape, cut): first_fit-
   anchored parametric lanes (pop 4) on ``synthetic_workload(1000, 10000,
   seed=1)``, the flat engine dense and unsegmented against
   ``node_prefilter_k=64`` + ``state_pack`` + the double-buffered
   segmented runner (8,192 steps), every integer field and the score
   identical, events/s of each and the flat state's bytes with and
   without packing; the first_fit seed program on the VM (4 lanes,
   capacity 256) on 1,000 nodes x 96 pods, dense against k = 64: ms per
   step of each, their ratio, fitness drift 0;
11. the FunSearch evolve loop (``funsearch.evolution``; plain PyTorch
   replayed as CUDA graphs, and the fused kernel in (d)): (a)
   ``evolution.run`` with ``FakeLLM(seed=7)``, the exact engine and the VM
   tier on the default cluster with the first 256 pods, the WAL, the
   checkpoint and the champion files: per-generation stats, the final
   population and best held to ``tests/fixtures/evolve_prefix256_pins.json``
   (fks_tpu's run; integers exact, scores within 1e-9), every VM candidate
   served by a batched launch (a fallback fails the phase); (b) the same
   loop with budget halving (smoke3 probe, default8 full rung), one
   generation, held to its pins, the champion a full-rung survivor; (c)
   the 0.5365 champion through the transpiled tier on the full trace,
   within 1e-6 of its file's score; (d) ``ParametricEvolution`` at pop 256
   on the fused kernel seeded by ``init_from_weights`` (lane 0 the
   champion), 2 generations + checkpoint + restore + 1 equal to 3 in a
   row, ``best_code()`` scored on the card; (e) ``probe_policy_cost``
   for ``parametric.score`` and ``vm.score_static`` at N = 1,000 (graph
   replays timed with CUDA events, and the eager host-wall reading it
   replaced) and the k ``resolve_auto_prefilter`` picks. (a)-(d) print
   seconds, capacity buckets, lanes per launch, launches and replays,
   candidate evals/s and ms per step;
12. champion serving (``fks_tpu_torch.serve``; plain PyTorch replayed as
   CUDA graphs, no hand kernel: the champion is a VM program) on the
   default cluster with the 0.5365 champion and the default envelope:
   (a) ``ServeEngine`` selftest (8 queries of 4 pods: ok, max_drift 0.0,
   placements equal the unbatched reference) and the pinned answers of
   ``tests/fixtures/serve_pins.json``; (b) graph captures at warmup, then
   per (pod bucket 16/64/256, lane bucket 1/8) 20 warm queries at 1 lane
   and 24 at 8 (cut for phases 15 and 16: at 1 lane 5 at 64 pods and 3
   at 256, at 8 lanes 16 at 256 pods):
   p50/p99 per-query latency, steps per batch, ms per step (graph
   replays), H2D bytes per query, and zero captures on the warm path; one
   257-pod query in the 1,024-pod bucket, timed (a 1,024-pod query was
   cut to make room for phase 15); (c) ``VMServeEngine`` selftest,
   ``swap_program`` to the pins' second champion with zero captures,
   answers equal to a
   fresh engine and the pins, and back; (d) ``ServeService`` +
   ``make_http_server``: 3 concurrent ``POST /query`` answered in one batch
   equal (a)'s, ``GET /healthz``; (e) ``ParitySentinel.audit_served`` over
   the served answers of (b) and (d) and two each of (a) and (c) (the
   rest are held to the pins; cut for phase 16): zero alerts;
13. the device mesh and the champion portfolio (``parallel.mesh``,
   ``portfolio``) on 4 logical shards of the one card: the sharded
   fused, exact, code and suite evals, the generation step and sharded
   ``ParametricEvolution`` against their unsharded runs, both serve
   engines and a 4-slot portfolio sharded, and an NCCL group at world
   size 1 (cases (a)-(h); both kernels launch here);
14. the control plane (``pipeline``, ``resilience.drain``/``drills``,
   ``portfolio.fleet``, ``obs.FlightRecorder``; no hand kernel: the
   champions are code, served as VM programs or the transpiled tier):
   (a) ``run_drills()`` on the card, all 18 drills ok (any other verdict
   raises); (b) on the default cluster with the default envelope, the
   0.5268 champion on a ``VMServeEngine`` behind a ``ServeService``
   answering phase 12's 4-pod windows, the 0.5365 champion dropped in a
   ledger directory and promoted by ``PromotionController.poll_once``
   through the VM fast path with 0 captures on the swap and on 20
   post-swap queries, then a forced SLO burn (``SLOConfig(p99_ms=1e-6)``)
   rolled back to the incumbent (its answers equal its pre-promotion
   ones), and a second controller over the same log recovering the same
   state; (c) ``DrainCoordinator.drain()`` with 16 queries in flight:
   every Future completed with the incumbent's answer, nothing shed, the
   persisted state reloaded and preloaded; (d) ``follow_ledger``
   promoting the 0.5365 champion through the AOT path (the incumbent on
   a ``ServeEngine``, envelope 16 pods x 8 lanes) while a client thread
   queries: no query fails, the shadow's captures happen beside the
   serving thread and none on the serving path; the client's p50, p99
   and max query latency by when each query started: before the
   champion lands, while the shadow is built (its ladder captured and
   warmed beside serving), while it is replayed (each replayed query
   holding the incumbent's batch turn) and after the swap.
   Seconds and captures per case, and both kernels' launches in the
   phase (0);
15. the command line (``fks_tpu_torch.cli.main`` in process, no
   ``--cpu``; each command must exit 0; seconds per command, and both
   kernels' launches counted around each command): (a) ``simulate
   --policy best_fit --f64`` on the default trace, every field equal to
   ``golden_default.json`` (floats within 1e-9), its ``--metrics`` rows
   through ``tools/check_jsonl_schema.py``; (b) ``bench --policies
   best_fit,first_fit --f64``, the best_fit row equal to (a)'s; (c)
   ``scale --engine fused`` on 16 nodes x 8,152 synthetic pods at pop
   256: one kernel launch, score min and max equal to a direct fused
   population eval; (d) ``scale --engine flat`` on 1,000 nodes x 10,000
   pods (cut from the command's default 100,000, as phase 10 cuts them)
   at pop 4: the auto-prefilter keeps k = 0, ``param_score`` launched,
   events/s from the command's own result (read through a spy on the
   population eval it builds); (e) ``evolve --fake-llm
   --profile`` with phase 11 (a)'s loop (the reference config format
   carries no seed: FakeLLM(seed=0)) on the first 256 pods, its
   generation rows, population and best held to
   ``tests/fixtures/evolve_cli_prefix256_pins.json`` (fks_tpu's CLI;
   float32 scores within 1e-6), the ``__total__`` device_profile record
   attributing at least 95% of the wall, the run dir through the schema
   tool, then ``mem --run-dir`` rendering the footprint ladder; (f)
   ``trace-diff --engines exact,flat --suite default8 --scenario 5``:
   fks_tpu's exit code 1 and text (the first divergence of the flat
   engine's retry rule, step 9,457; ``TRACE_DIFF_FAULT1``); (g)
   ``loadgen --duration 5`` (the hermetic template champion): fks_tpu's
   four gated keys, no failed request; (h) ``mem
   --sample`` with the card's watermarks, ``mem --drill vm_swap_leak``
   at 10 swaps x 40 batches with zero allocator drift; (e)'s run
   directory is read again in phase 16;
16. reading runs back and the tooling (in process, no ``--cpu``; each
   command must exit with its expected code; seconds per case, and both
   kernels' launches counted around each case): (a) ``report`` (showing
   the profiler's attributed share), ``export-metrics``, ``compare`` of
   the directory against itself (exit 0), ``watch --once`` and ``layout``
   on phase 15 (e)'s ``evolve --profile`` run directory and on
   ``tests/fixtures/golden_run``, and ``spans --critical-path
   --min-fraction 0.95`` on the former; (b) ``obs.explore_layouts`` on 4
   logical shards of the card (fks_tpu's ``cli layout --explore``
   workload: ``synthetic_workload(16, 32, seed=0)``, ``default8``, pop
   64, the flat engine) into a temporary ``RunHistory``: 3 layouts,
   parity 0, ``param_score`` launched, each probe's first-call and
   steady seconds; then ``layout --explore --history-root <tmp>`` on the
   real card count; (c) ``tools.profile_step`` at the default trace's
   shapes and lanes 1, 16 and 256, cut to 512 steps per variant: us per
   step of every variant, ``param_score`` launched; (d)
   ``tools.measure_tiers`` on the first 128 pods (256 before phase 17)
   with 3 candidates (the
   fewest it takes), without its FakeLLM generation (phase 11 times
   generations): fks_tpu's keys but ``evolve_*``, no candidate skipped,
   the exact tier without error and every number finite and positive;
   (e) ``lint`` of the port: clean;
17. the last entry points (in process, no ``--cpu``; seconds per case,
   and both kernels' launches counted from 0 around each case): (a)
   ``tools.discover --engine fused --pop 256 --gens 20 --init-from`` the
   0.5365 champion on the full default trace, into temporary ``--out``,
   ``--checkpoint`` and ``--metrics`` paths: ``fused_sim`` launched once
   per generation, the best score never decreasing, the champion file and
   the stdout record in fks_tpu's schema, seconds per generation and of
   the exact re-scoring (``param_score``); (b) ``--engine exact --pop 4
   --elite-k 1 --gens 1`` from the same file: the search's best at least
   the champion's exact 0.5364651 (less 1e-6), the exact re-scoring alone
   equal to the batched search score within 1e-9, ``param_score``
   launched; (c) ``entry.entry()`` on the card within 1e-6 of the CPU's,
   and ``entry.dryrun_multichip(4)`` on logical shards of the card (every
   sharded result equal to its single-device run); (d) the runner's
   ``trends_gate`` and ``trace_gate`` without ``--cpu``: both ok; (e)
   ``tools.probe_floor`` parts A-B and ``tools.probe_ops`` at lanes 16 and
   256, 256 steps each: us per step printed, every number finite and
   positive;
18. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the fks_tpu package.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CODE_PODS = 32  # phase 13 (d): pods of the sharded code eval (VM-bound)
CHAMPION = (ROOT / "policies" / "discovered"
            / "funsearch_20260801_045536_score0.5365.json")
TOL = 2e-6
POP = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
KERNELS = ("fused_sim", "param_score")
SMEM_BYTES_PER_CLOCK_PER_SM = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def compare_raw(name, got, want):
    """Max abs error of the kernel's raw outputs against the plain
    version's; raises unless ints are exact and floats within TOL."""
    import torch

    labels = ("aux", "cpu", "mem", "gpu", "gmil", "acci", "accf")
    worst = 0.0
    for label, a, b in zip(labels, got, want):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {label} shape {tuple(a.shape)} "
                                 f"!= plain {tuple(b.shape)}")
        if a.dtype == torch.float32:
            err = (a - b).abs()
            bad = err > TOL + TOL * b.abs()
        else:
            err = (a.to(torch.int64) - b.to(torch.int64)).abs().to(
                torch.float64)
            bad = err > 0
        if bool(bad.any()):
            idx = bad.nonzero()[0].tolist()
            raise AssertionError(
                f"{name}: {label} differs from the plain version at {idx}: "
                f"kernel {a[tuple(idx)].item()} plain {b[tuple(idx)].item()}"
                f" ({int(bad.sum())} entries)")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def cuda_ms(fn, reps: int, hold_s: float = 0.0) -> float:
    """Mean ms of ``fn`` over ``reps`` calls between two CUDA events. With
    ``hold_s`` the stream first spins that long on the card, so the host
    has queued every call before the first one starts: the reading is then
    the card's time back to back, not the host's launch rate."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if hold_s:
        torch.cuda._sleep(int(hold_s * 2e9))  # cycles, at up to 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def exact_phase(dev, wl, params, card) -> None:
    """Phase 6 (module docstring): the exact engine's golden parity, its
    sync-free step, and the pop-256 population with lanes run alone."""
    import torch

    from fks_tpu_torch.models import zoo
    from fks_tpu_torch.parallel import make_population_eval
    from fks_tpu_torch.sim import engine
    from fks_tpu_torch.sim.engine import SYNC_EVERY, SimConfig
    from fks_tpu_torch.testing import (
        assert_golden_micro, assert_golden_parity, golden_micro_workload,
    )

    fixtures = ROOT / "tests" / "fixtures"
    golden = json.loads((fixtures / "golden_default.json").read_text())
    f64 = SimConfig(score_dtype=torch.float64)
    t_phase = time.perf_counter()

    micro = golden_micro_workload()
    res = engine.simulate(micro, zoo.micro_best_fit(torch.float64), f64,
                          device=dev)
    assert_golden_micro(
        res, json.loads((fixtures / "golden_micro.json").read_text()), micro)
    log("[exact] golden_micro (micro_best_fit): placements, GPU picks and "
        "final state equal the fixture")

    # best_fit step by step: eager steps and graph replays under the sync
    # debug mode "error" (any host sync raises), the capture in between (a
    # sync while capturing fails it); then the ordinary loop to the end
    ref = golden["policies"]["best_fit"]
    ktable, max_steps = engine.loop_tables(wl, f64)
    step = engine.build_step(wl, zoo.best_fit(torch.float64), f64, ktable,
                             max_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = engine.initial_state(wl, f64)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2 * SYNC_EVERY):
            state = step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    chunk = engine.GraphedChunk(step, state, max_steps)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            chunk.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    final = chunk.run()
    res = engine.finalize(wl, f64, final).lane(0)
    steps = int(final.steps[0])
    wall = time.perf_counter() - t0
    assert_golden_parity(res, ref, wl)
    log(f"[exact] default trace best_fit float64: {wall:.3f} s, {steps} "
        f"steps, {wall / steps * 1e6:.1f} us/step ({chunk.replays} graph "
        f"replays of {SYNC_EVERY} steps, {2 * SYNC_EVERY} eager steps and "
        f"replays under sync debug mode 'error'), score "
        f"{float(res.policy_score):.12f}, events {int(res.events_processed)}"
        f", golden {ref['policy_score']:.12f}: parity ok")

    ref = golden["policies"]["funsearch_4901"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.simulate(wl, zoo.funsearch_4901(torch.float64), f64,
                          device=dev)
    events = int(res.events_processed)
    wall = time.perf_counter() - t0
    assert_golden_parity(res, ref, wl)
    log(f"[exact] default trace funsearch_4901 float64: {wall:.3f} s, "
        f"{events} steps, {wall / events * 1e6:.1f} us/step, score "
        f"{float(res.policy_score):.12f}, golden "
        f"{ref['policy_score']:.12f}: parity ok")

    # the population: phase 4's params (seeds + jitter, champion lane 4)
    cfg = SimConfig()
    pop = params.shape[0]
    evaluate = make_population_eval(wl, cfg=cfg, engine="exact", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = evaluate(params)  # the capture included (well under 1 s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphed = next(iter(evaluate.run.graphs.values()))
    lane_steps = graphed.state.steps.double()
    scores = batched.policy_score
    if scores.shape != (pop,) or not bool(torch.isfinite(scores).all()) \
            or not bool(((scores >= 0) & (scores <= 1)).all()):
        raise AssertionError(f"bad exact-engine scores: {scores}")
    longest = float(lane_steps.max())
    log(f"[exact] pop {pop} default trace: {wall:.3f} s/eval with the "
        f"graph capture, {pop / wall:.2f} evals/s, steps per lane max "
        f"{int(longest)} mean {float(lane_steps.mean()):.1f}, "
        f"{wall / longest * 1e6:.1f} us per step of the longest lane, best "
        f"{float(scores.max()):.6f}, champion lane {float(scores[4]):.6f}, "
        f"card {card}")
    # a lane alone against its batched result: phase 17 (b) (the exact
    # search's pop-4 score against the champion re-scored alone)
    log(f"[exact] phase {time.perf_counter() - t_phase:.1f} s")


def zoo_phase(dev) -> None:
    """Phase 7 (module docstring): policy scores on the card == CPU."""
    import torch

    from fks_tpu_torch.models import parametric, zoo
    from fks_tpu_torch.testing import random_policy_views

    t0 = time.perf_counter()
    factories = {**zoo.ZOO, **zoo.BASELINE_FACTORIES,
                 "micro_best_fit": zoo.micro_best_fit}
    views = [random_policy_views(seed) for seed in range(4)]
    checked = 0
    for dtype in (torch.float32, torch.float64):
        policies = {name: make(dtype) for name, make in factories.items()}
        for pod, nodes, w in views:
            policies["parametric"] = (
                lambda p, n, w=w, d=dtype: parametric.score(w.to(p[0].device),
                                                            p, n, dtype=d))
            card_pod = type(pod)(*(x.to(dev) for x in pod))
            card_nodes = type(nodes)(*(x.to(dev) for x in nodes))
            for name, policy in policies.items():
                want = policy(pod, nodes)
                got = policy(card_pod, card_nodes).cpu()
                if not torch.equal(got, want):
                    bad = (got != want).nonzero()[0].tolist()
                    raise AssertionError(
                        f"{name} {dtype}: card score {got[tuple(bad)]} != "
                        f"CPU {want[tuple(bad)]} at {bad} "
                        f"({int((got != want).sum())} scores differ)")
                checked += want.numel()
    log(f"[zoo] {len(factories) + 1} policies x float32/float64 x 4 draws: "
        f"{checked} integer scores on the card equal the CPU's "
        f"({time.perf_counter() - t0:.1f} s)")


def scenario_phase(dev, wl, params, card) -> None:
    """Phase 8 (module docstring): scenario suites on the card."""
    import torch

    from fks_tpu_torch.data.synthetic import synthetic_workload
    from fks_tpu_torch.models import parametric, zoo
    from fks_tpu_torch.obs import tracing
    from fks_tpu_torch.scenarios import (
        RobustConfig, ScenarioSpec, aggregate, get_suite, make_suite_eval,
        perturb_workload,
    )
    from fks_tpu_torch.sim import engine
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.testing import assert_result_matches, result_fields

    t_phase = time.perf_counter()
    golden = json.loads((ROOT / "tests" / "fixtures"
                         / "golden_scenario_fault.json").read_text())
    gwl = perturb_workload(synthetic_workload(**golden["workload"]),
                           ScenarioSpec(**golden["spec"]))
    for eng in ("exact", "flat"):
        for name in ("first_fit", "best_fit"):
            pin = golden["policies"][name]
            policy = zoo.ZOO[name]()
            res = tracing.replay(gwl, eng, lambda _p, pod, nodes, f=policy:
                                 f(pod, nodes), None, device=dev)
            rows = tracing.extract_trace(res)
            got = {"policy_score": float(res.policy_score),
                   "scheduled_pods": int(res.scheduled_pods),
                   "events_processed": int(res.events_processed),
                   "assignments": [[r["pod"], r["node"]] for r in rows
                                   if r["kind"] == "CREATE"],
                   "fault_rows": sum(r["kind"] in ("NODE_DOWN", "NODE_UP")
                                     for r in rows)}
            if abs(got["policy_score"] - pin["policy_score"]) > 1e-5 or any(
                    got[k] != pin[k] for k in ("scheduled_pods",
                                               "events_processed",
                                               "assignments", "fault_rows")):
                raise AssertionError(f"golden fault pin {eng}/{name}: got "
                                     f"{got}, pinned {pin}")
    log("[scenarios] golden_scenario_fault: exact and flat x first_fit and "
        "best_fit hold the pins (score, counts, per-CREATE assignments, "
        "fault rows)")

    suite = get_suite("default8", wl)
    cfg = SimConfig()
    cands = params[:32]
    lanes = cands.shape[0] * len(suite)
    evaluate = make_suite_eval(suite, cfg=cfg, population=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = evaluate(cands)  # the capture included
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = next(iter(evaluate.graphs.values())).state.steps.double()
    scores = batched.policy_score
    if scores.shape != (32, len(suite)) \
            or not bool(torch.isfinite(scores).all()) \
            or not bool(((scores >= 0) & (scores <= 1)).all()):
        raise AssertionError(f"bad default8 scores: {scores}")
    champ = scores[4]
    robust = {agg: float(aggregate(champ, RobustConfig(agg)))
              for agg in ("mean", "min", "cvar")}
    log(f"[scenarios] default8 exact, {cands.shape[0]} candidates x "
        f"{len(suite)} scenarios = {lanes} lanes: {wall:.3f} s/eval with the "
        f"graph capture, {lanes / wall:.2f} evals/s (candidate x scenario), "
        f"steps per lane max {int(steps.max())} mean "
        f"{float(steps.mean()):.1f}, {wall / float(steps.max()) * 1e6:.1f} us "
        f"per step of the longest lane, card {card}")
    log(f"[scenarios] champion per scenario "
        f"{dict(zip(suite.names, [round(float(x), 6) for x in champ]))}; "
        f"robust mean {robust['mean']:.6f} min {robust['min']:.6f} "
        f"cvar-0.25 {robust['cvar']:.6f}")

    want = {k: v[4] for k, v in result_fields(batched).items()}
    i2 = suite.names.index("fault2")
    w2 = suite.workloads[i2]
    one = engine.make_population_run_fn(w2, parametric.score, cfg)(
        params[4:5], engine.initial_state(w2, cfg))
    assert_result_matches(one, {k: v[i2:i2 + 1] for k, v in want.items()},
                          rtol=0, atol=0)
    log("[scenarios] the champion alone on fault2 (1 lane) equals its "
        "batched result exactly")

    t0 = time.perf_counter()
    flat_res = make_suite_eval(suite, cfg=cfg, engine="flat",
                               device=dev)(params[4])
    torch.cuda.synchronize()
    wall_flat = time.perf_counter() - t0
    fscores = flat_res.policy_score
    if not bool(torch.isfinite(fscores).all()):
        raise AssertionError(f"bad flat default8 scores: {fscores}")
    log(f"[scenarios] default8 flat, champion ({len(suite)} lanes): "
        f"{wall_flat:.3f} s with the graph capture, events per lane max "
        f"{int(flat_res.events_processed.max())}, scores "
        f"{[round(float(x), 6) for x in fscores]}")

    # the champion's decision trace on fault1: trace_diff replays the exact
    # engine twice with the trace on, and its recorder keeps every row
    i1 = suite.names.index("fault1")
    w1 = suite.workloads[i1]
    rec = Rows()
    t0 = time.perf_counter()
    spec = ("exact", "exact", parametric.score, params[4])
    record = tracing.trace_diff(w1, [spec, ("exact-again",) + spec[1:]],
                                recorder=rec, max_trace_events=2**31,
                                device=dev)
    if record["divergent"]:
        raise AssertionError(tracing.format_diff(record))
    rows = next(f["events"] for kind, f in rec.rows
                if kind == "decision_trace" and f["engine"] == "exact")
    fault_rows = sum(r["kind"] in ("NODE_DOWN", "NODE_UP") for r in rows)
    score = record["scores"]["exact"]
    untraced = float(want["policy_score"][i1])  # the batched champion
    if score != untraced \
            or fault_rows != w1.faults.num_events \
            or sum(r["kind"] == "NODE_DOWN" for r in rows) * 2 != fault_rows:
        raise AssertionError(
            f"traced fault1 run: score {score} (untraced {untraced}), "
            f"{fault_rows} fault rows of {w1.faults.num_events}")
    log(f"[scenarios] fault1 decision trace: {len(rows)} rows, "
        f"{fault_rows} fault rows, score {score:.6f} == untraced; trace_diff "
        f"exact vs exact: no divergence over {record['steps']['exact']} "
        f"steps ({time.perf_counter() - t0:.1f} s for the two traced runs); "
        f"phase {time.perf_counter() - t_phase:.1f} s")


def lanes_of(pod, nodes, rows):
    """The views of the lanes ``rows`` (bool[L]) only; shared node tables
    stay as they are."""
    grids = ("gpu_milli_left", "gpu_milli_total", "gpu_mem_total",
             "gpu_mask")
    return (type(pod)(*(x[rows] for x in pod)),
            type(nodes)(*(x[rows] if x.dim() == (3 if f in grids else 2)
                          else x for f, x in zip(nodes._fields, nodes))))


def code_phase(dev, card) -> dict:
    """Phase 9 (module docstring): code candidates on the VM and the
    transpiled tier at the default cluster's width (16 nodes, G = 8).
    Returns the numbers the summary line carries."""
    import torch

    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.funsearch import template, transpiler, vm
    from fks_tpu_torch.parallel import make_population_eval
    from fks_tpu_torch.sim import engine
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.testing import random_policy_views

    t_phase = time.perf_counter()
    pins = json.loads((ROOT / "tests" / "fixtures"
                       / "vm_prefix512_pins.json").read_text())
    codes = list(template.seed_policies().values()) + [
        json.loads((ROOT / "policies" / "discovered" / f).read_text())["code"]
        for f in pins["lanes"][2:-1]]
    champ = pins["lanes"].index(CHAMPION.name)

    # (a) VM == transpiled on the card, card == CPU, float64 and float32:
    # lane l of each 256-lane draw runs candidate l % 15
    checked = 0
    for dtype in (torch.float64, torch.float32):
        policies = [transpiler.transpile(c, dtype=dtype) for c in codes]
        progs = vm.stack_programs([vm.compile_policy(c, 16, 8, dtype=dtype)
                                   for c in codes], capacity=512)
        for seed in range(4):
            pod, nodes, _ = random_policy_views(seed, gpu_heavy=seed % 2 == 1)
            lanes = pod.cpu_milli.shape[0]
            which = torch.arange(lanes) % len(codes)
            card_pod = type(pod)(*(x.to(dev) for x in pod))
            card_nodes = type(nodes)(*(x.to(dev) for x in nodes))
            per_lane = vm.select_slot(progs, which)
            got = vm.score_static(
                type(per_lane)(*(x.to(dev) for x in per_lane)),
                card_pod, card_nodes).cpu()
            for i, policy in enumerate(policies):
                rows = which == i
                card_tr = policy(*lanes_of(card_pod, card_nodes,
                                           rows.to(dev))).cpu()
                cpu_tr = policy(*lanes_of(pod, nodes, rows))
                for label, a in (("VM on the card", got[rows]),
                                 ("transpiled on the card", card_tr)):
                    if not torch.equal(a, cpu_tr):
                        bad = (a != cpu_tr).nonzero()[0].tolist()
                        raise AssertionError(
                            f"candidate {i} {dtype} draw {seed}: {label} "
                            f"{a[tuple(bad)]} != CPU transpiled "
                            f"{cpu_tr[tuple(bad)]} at {bad}")
                checked += int(rows.sum()) * nodes.cpu_milli_left.shape[1]
    log(f"[code] {len(codes)} candidates (2 seeds, 13 champions) x float64/"
        f"float32 x 4 draws of 256 lanes: {checked} VM scores on the card "
        f"== transpiled on the card == transpiled on the CPU "
        f"({time.perf_counter() - t_phase:.1f} s)")

    # (b) the 15 programs stacked (capacity 512, 16 lanes) through the
    # exact engine on the first 512 pods, float64 (the flat engine's run,
    # 54.5 s, was cut for phase 17)
    wl = TraceParser().parse_workload(max_pods=pins["pods"]).to(dev)
    progs = [vm.compile_policy(c, 16, 8, capacity=512) for c in codes]
    progs += [progs[-1]] * (vm.bucket_lanes(len(progs)) - len(progs))
    stacked = vm.stack_programs(progs, capacity=512)
    lanes = len(progs)
    cfg = SimConfig(score_dtype=torch.float64)
    out = {}
    for eng in ("exact",):
        evaluate = make_population_eval(wl, vm.score_static, cfg,
                                        engine=eng, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(stacked)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pin = pins[eng]
        got = {"policy_score": res.policy_score.tolist(),
               "scheduled_pods": res.scheduled_pods.tolist(),
               "events_processed": res.events_processed.tolist()}
        for k in ("scheduled_pods", "events_processed"):
            if got[k] != pin[k]:
                raise AssertionError(f"{eng} VM population {k}: {got[k]} != "
                                     f"fks_tpu pin {pin[k]}")
        worst = max(abs(a - b) for a, b in zip(got["policy_score"],
                                                pin["policy_score"]))
        if worst > 1e-9:
            raise AssertionError(f"{eng} VM population scores "
                                 f"{got['policy_score']} differ from the "
                                 f"fks_tpu pins by {worst:.3g} > 1e-9")
        # steady step time: replays of the finished state run every op
        # slot of every step (the card skips no work for idle lanes)
        graphed = next(iter(evaluate.run.graphs.values()))
        step_ms = cuda_ms(graphed.replay, 3) / graphed.steps
        longest = int(graphed.state.steps.max())
        out[eng] = {"s_per_eval": wall, "longest_steps": longest,
                    "ms_per_step": step_ms,
                    "us_per_op_slot": step_ms * 1e3 / stacked.capacity,
                    "evals_per_s": len(codes) / wall}
        log(f"[code] {eng} engine, {len(codes)} candidates in {lanes} lanes "
            f"(capacity {stacked.capacity}, float64), first {pins['pods']} "
            f"pods: {wall:.3f} s per eval with the graph capture, longest "
            f"lane {longest} steps, {step_ms:.3f} ms per step (replays), "
            f"{out[eng]['us_per_op_slot']:.3f} us per op slot, "
            f"{out[eng]['evals_per_s']:.3f} candidate evals/s; every lane's "
            f"score, scheduled pods and events equal the fks_tpu pins; "
            f"card {card}")

    t0 = time.perf_counter()
    alone = engine.simulate(wl, transpiler.transpile(codes[champ]), cfg,
                            device=dev)
    if float(alone.policy_score) != pins["exact"]["policy_score"][champ] \
            or int(alone.scheduled_pods) != \
            pins["exact"]["scheduled_pods"][champ]:
        raise AssertionError(
            f"the 0.5365 champion alone (transpiled) scores "
            f"{float(alone.policy_score)}, its VM lane "
            f"{pins['exact']['policy_score'][champ]}")
    log(f"[code] the 0.5365 champion alone through the transpiled tier "
        f"(exact engine): {float(alone.policy_score):.12f}, equal to its "
        f"batched VM lane ({time.perf_counter() - t0:.2f} s); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def scale_phase(dev, card):
    """Phase 10 (module docstring): 1,000 nodes — the prefilter, packed
    state and the segmented runner against the dense sweep, parametric and
    VM. Returns the numbers the summary line carries and the probe inputs
    of phase 11e."""
    import torch

    from fks_tpu_torch.data.synthetic import synthetic_workload
    from fks_tpu_torch.funsearch import template, vm
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.sim import engine, flat
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.testing import INT_FIELDS

    t_phase = time.perf_counter()
    out = {}
    nodes, pods, pop, k = 1000, 10000, 4, 64
    first_fit = parametric.seed_weights("first_fit")
    params = first_fit[None].repeat(pop, 1).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def same(name, a, b):
        for f in INT_FIELDS + ("policy_score",):
            x, y = getattr(a, f), getattr(b, f)
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: {f} differs: {x} vs {y}")

    # (a) parametric, first_fit-anchored lanes: dense unsegmented against
    # prefiltered + packed + segmented (double buffer)
    wl = synthetic_workload(nodes, pods, seed=1).to(dev)
    dense_cfg = SimConfig(max_steps=4 * pods, track_ctime=False)
    scale_cfg = SimConfig(max_steps=4 * pods, track_ctime=False,
                          node_prefilter_k=k, state_pack=True)
    dense, wall_d = timed(lambda: flat.make_population_run_fn(
        wl, parametric.score, dense_cfg)(
            params, flat.initial_state(wl, dense_cfg)))
    segments = []
    run = flat.make_segmented_population_run(
        wl, parametric.score, scale_cfg, seg_steps=8192,
        on_segment=lambda: segments.append(1))
    scaled, wall_s = timed(lambda: run(params,
                                       flat.initial_state(wl, scale_cfg)))
    same("1k parametric dense vs prefilter+state_pack+segmented", dense,
         scaled)
    events = int(dense.events_processed.sum())
    bytes_wide = flat.state_bytes(flat.initial_state(wl, dense_cfg, pop))
    bytes_packed = flat.state_bytes(flat.initial_state(wl, scale_cfg, pop))
    out["parametric"] = {
        "events": events, "dense_events_per_s": events / wall_d,
        "scaled_events_per_s": events / wall_s, "segments": len(segments),
        "state_bytes": bytes_wide, "state_bytes_packed": bytes_packed}
    log(f"[scale] parametric pop {pop} on {nodes} nodes x {pods} pods: "
        f"dense unsegmented {wall_d:.3f} s ({events / wall_d:.1f} events/s), "
        f"k={k} + state_pack + segmented (8192 steps, double buffer, "
        f"{len(segments)} segments) {wall_s:.3f} s ({events / wall_s:.1f} "
        f"events/s), both with the graph capture; every integer field and "
        f"the score identical; flat state {bytes_wide} B, packed "
        f"{bytes_packed} B; card {card}")

    # (b) the first_fit seed program on the VM, 4 lanes at capacity 256,
    # dense against k = 64 (the segmented runner, as bench does)
    vm_pods = 96
    wl_v = synthetic_workload(nodes, vm_pods, seed=1).to(dev)
    prog = vm.compile_policy(template.seed_policies()["first_fit"],
                             wl_v.cluster.n_padded, wl_v.cluster.g_padded,
                             capacity=256)
    stacked = vm.stack_programs([prog] * pop, capacity=256)
    stacked = type(stacked)(*(x.to(dev) for x in stacked))
    vm_out = {}
    for label, kk in (("dense", 0), ("prefilter", k)):
        cfg = SimConfig(max_steps=4 * vm_pods, track_ctime=False,
                        node_prefilter_k=kk, state_pack=kk > 0)
        run = flat.make_segmented_population_run(wl_v, vm.score_static, cfg,
                                                 seg_steps=16384)
        res, wall = timed(lambda: run(stacked,
                                      flat.initial_state(wl_v, cfg)))
        chunk = next(iter(run.graphs.values()))
        step_ms = cuda_ms(chunk.replay, 3) / chunk.steps
        vm_out[label] = (res, step_ms, wall)
    drift = float((vm_out["prefilter"][0].policy_score
                   - vm_out["dense"][0].policy_score).abs().max())
    same("1k VM dense vs prefilter", vm_out["dense"][0],
         vm_out["prefilter"][0])
    ratio = vm_out["dense"][1] / vm_out["prefilter"][1]
    out["vm"] = {"dense_ms_per_step": vm_out["dense"][1],
                 "prefilter_ms_per_step": vm_out["prefilter"][1],
                 "ratio": ratio, "drift": drift,
                 "steps": int(vm_out["dense"][0].events_processed.max())}
    log(f"[scale] VM first_fit seed, {pop} lanes, capacity 256, {nodes} "
        f"nodes x {vm_pods} pods: dense {vm_out['dense'][1]:.3f} ms per "
        f"step, k={k} {vm_out['prefilter'][1]:.3f} ms per step (replays), "
        f"ratio {ratio:.2f}x; runs {vm_out['dense'][2]:.2f} s and "
        f"{vm_out['prefilter'][2]:.2f} s with the capture; fitness drift "
        f"{drift} (every integer field identical)")

    log(f"[scale] phase {time.perf_counter() - t_phase:.1f} s")
    # the auto-prefilter probe's inputs at N = 1,000, for phase 11e
    return out, (wl.cluster.n_padded, wl.cluster.g_padded, first_fit, prog)


EVOLVE_TIME_FIELDS = ("eval_seconds", "llm_seconds", "budget_device_seconds")


class Rows:
    """A recorder (``obs.recorder`` API, disabled) that keeps its rows."""

    enabled = False

    def __init__(self):
        self.rows = []

    def event(self, kind, **fields):
        self.rows.append((kind, fields))

    def metric(self, kind, record=None, **fields):
        self.rows.append((kind, dict(record or {}, **fields)))

    def heartbeat(self):
        pass

    def finish(self, status="ok"):
        pass

    def close(self):
        pass

    def spans(self, label):
        return [f for k, f in self.rows if k == "span" and f["label"] == label]


def pins_close(name, got, want, tol):
    """``got`` equal to ``want`` through dicts and lists, floats within
    ``tol``; raises naming the first difference."""
    if isinstance(want, float) and isinstance(got, float):
        if abs(got - want) > tol:
            raise AssertionError(f"{name}: {got!r} vs pin {want!r}")
    elif isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: keys {sorted(got)} vs pin "
                                 f"{sorted(want)}")
        for k in want:
            pins_close(f"{name}.{k}", got[k], want[k], tol)
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{name}: {got} vs pin {want}")
        for i, (a, b) in enumerate(zip(got, want)):
            pins_close(f"{name}[{i}]", a, b, tol)
    elif got != want:
        raise AssertionError(f"{name}: {got!r} vs pin {want!r}")


def sha(code):
    """The sha1 of a candidate's canonical key, as the pins name it."""
    import hashlib

    from fks_tpu_torch.funsearch import transpiler

    return hashlib.sha1(transpiler.canonical_key(code).encode()).hexdigest()


def held_to_pins(name, fs, pin):
    """A FunSearch run against its fks_tpu pins: per generation the stats
    without their time fields, the final population and best as
    (canonical-key sha1, score); integers exact, floats within 1e-9."""
    import dataclasses

    gens = [{k: v for k, v in dataclasses.asdict(h).items()
             if k not in EVOLVE_TIME_FIELDS} for h in fs.history]
    pins_close(f"{name} generations", gens, pin["generations"], 1e-9)
    pins_close(f"{name} population",
               [[sha(c), sc] for c, sc in fs.population],
               pin["population"], 1e-9)
    pins_close(f"{name} best", [sha(fs.best[0]), fs.best[1]], pin["best"],
               1e-9)


def graph_report(*caches):
    """Capacity buckets, launches' lane counts, replays and ms per step
    (replays of each captured graph, timed after its run) of the runners'
    graph caches (``sim.engine.graph_key`` -> ``GraphedChunk``)."""
    caps, lanes, replays, ms = set(), [], 0, []
    for graphs in caches:
        for key, chunk in graphs.items():
            shape = key[1][0] if len(key) > 1 else ()
            if shape:
                caps.add(shape[-1])
            lanes.append(key[0])
            replays += chunk.replays
            ms.append(cuda_ms(chunk.replay, 2) / chunk.steps)
    return sorted(caps), lanes, replays, ms


def evolve_phase(dev, card, probe_inputs) -> dict:
    """Phase 11 (module docstring): the FunSearch evolve loop on the card,
    the transpiled tier on the full trace, ParametricEvolution's resume on
    the fused kernel and the graph-timed auto-prefilter probe. Returns the
    numbers the summary line carries."""
    import re
    import tempfile

    import torch

    from fks_tpu_torch import obs
    from fks_tpu_torch.convert import load_champion_weights
    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.funsearch import (
        BudgetConfig, CodeEvaluator, EvolutionConfig, FakeLLM, FunSearch,
        ParametricEvolution, evolution, transpiler, vm,
    )
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.resilience import GenerationWAL
    from fks_tpu_torch.scenarios import RobustConfig, get_suite
    from fks_tpu_torch.sim import engine, fused
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.sim.types import NodeView, PodView

    t_phase = time.perf_counter()
    pins = json.loads((ROOT / "tests" / "fixtures"
                       / "evolve_prefix256_pins.json").read_text())
    wl = TraceParser().parse_workload(max_pods=pins["pods"])
    cfg = SimConfig(score_dtype=torch.float64)
    out = {}
    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)

    def quiet(_msg):
        pass

    def report(tag, wall, caps, lanes, launches, replays, evals, ms):
        per_step = ", ".join(f"{m:.3f}" for m in ms)
        log(f"[evolve] {tag}: {wall:.2f} s; VM capacity bucket(s) {caps}; "
            f"lanes per launch {lanes}; {launches} launches, {replays} "
            f"graph replays; {evals:.4f} candidate evals/s; ms per step "
            f"(replays) [{per_step}]; card {card}")
        return {"seconds": wall, "capacity_buckets": caps,
                "lanes_per_launch": lanes, "launches": launches,
                "replays": replays, "candidate_evals_per_s": evals,
                "ms_per_step": ms}

    def per_generation(fs):
        """Mean seconds of a generation's LLM and evaluate stages (the
        loop's own clocks; evaluate ends with the copy to the host)."""
        return sum(h.llm_seconds + h.eval_seconds
                   for h in fs.history) / len(fs.history)

    # (a) FunSearch, VM tier, exact engine, first 256 pods, with the WAL,
    # the checkpoint and the champion files
    rec = Rows()
    t0 = time.perf_counter()
    with obs.recording(rec):
        fs = evolution.run(
            wl, EvolutionConfig(**pins["evolve"]["config"]),
            backend=FakeLLM(seed=7), sim_config=cfg,
            checkpoint_path=str(work / "evo.json"),
            wal_path=str(work / "wal.jsonl"), out_dir=str(work / "out"),
            engine="exact", log=quiet, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held_to_pins("evolve", fs, pins["evolve"])
    ev = fs.evaluator
    batches = rec.spans("vm_batch")
    batched = sum(f["candidates"] for f in batches)
    if ev.vm_batch_fallbacks or batched != ev.vm_count \
            or ev.vm_batch_count != len(batches) or len(batches) < 3:
        raise AssertionError(
            f"not every VM candidate went through the batched launch: "
            f"{batched} of {ev.vm_count} in {len(batches)} launches, "
            f"{ev.vm_batch_fallbacks} fallbacks")
    if GenerationWAL(str(work / "wal.jsonl")).summary()["committed"] != \
            [1, 2] or json.loads((work / "evo.json").read_text())[
                "generation"] != 2:
        raise AssertionError("the WAL or the checkpoint missed a generation")
    top = json.loads(Path(fs.save_top_policies(str(work / "out"),
                                               k=5)).read_text())
    best_path = Path(fs.save_best_policy(str(work / "out")))
    best = json.loads(best_path.read_text())
    if [e["rank"] for e in top] != list(range(1, len(top) + 1)) \
            or any(set(e) != {"rank", "score", "generation", "code",
                              "timestamp"} for e in top) \
            or set(best) != {"score", "generation", "code", "timestamp"} \
            or not re.fullmatch(r"funsearch_\d{8}_\d{6}_score\d\.\d{4}\.json",
                                best_path.name) \
            or best["score"] != fs.best[1]:
        raise AssertionError(f"champion files off fks_tpu's schema: "
                             f"{best_path.name} {sorted(best)}")
    caps, _, replays, ms = graph_report(*ev._vm_pop_run.graphs)
    out["a"] = report(
        f"(a) FunSearch {len(fs.history)} generations, exact engine, VM "
        f"tier, first {pins['pods']} pods, best {fs.best[1]:.12f}; stats, "
        f"population and best equal the fks_tpu pins; {ev.vm_count} "
        f"candidates all in batched launches; WAL, checkpoint and champion "
        f"files in fks_tpu's schema; {per_generation(fs):.2f} s per "
        f"generation", wall, caps,
        [f["lanes"] for f in batches], ev.vm_batch_count, replays,
        ev.vm_count / sum(f["seconds"] for f in batches), ms)
    out["a"]["s_per_generation"] = per_generation(fs)

    # (b) the same loop with the budget rungs: smoke3 probe, default8 full
    bcfg = pins["budget"]["config"]
    bev = CodeEvaluator(
        wl, cfg, engine="exact", suite=get_suite(bcfg["scenario_suite"], wl),
        robust=RobustConfig(), device=dev,
        budget=BudgetConfig(schedule=bcfg["budget_schedule"],
                            probe_suite=bcfg["probe_suite"]))
    records = []
    evaluate = bev.evaluate

    def keep(codes):
        got = evaluate(codes)
        records.extend(got)
        return got

    bev.evaluate = keep
    rec = Rows()
    t0 = time.perf_counter()
    with obs.recording(rec):
        bfs = FunSearch(bev, EvolutionConfig(**bcfg),
                        backend=FakeLLM(seed=7), log=quiet)
        bfs.run_evolution()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held_to_pins("budget", bfs, pins["budget"])
    rung = {r.code: r.budget_rung for r in records}
    if rung.get(bfs.best[0]) != 1 or bev.vm_batch_fallbacks:
        raise AssertionError(f"the budget champion is not a full-rung "
                             f"survivor (rung {rung.get(bfs.best[0])})")
    rungs = rec.spans("budget_rung")
    caps, _, replays, ms = graph_report(
        *bev._vm_pop_run.graphs, bev._budget_eval._probe_run.graphs)
    out["b"] = report(
        f"(b) budget halving smoke3 -> default8, 1 generation, best "
        f"{bfs.best[1]:.12f} (a full-rung survivor), pruned "
        f"{bfs.history[-1].budget_pruned}; equal to the fks_tpu pins; "
        f"{per_generation(bfs):.2f} s per generation", wall,
        caps, [f["lanes"] for f in rungs], bev.vm_batch_count, replays,
        bev.vm_count / sum(f["seconds"] for f in rungs), ms)
    out["b"]["s_per_generation"] = per_generation(bfs)

    # (c) the transpiled tier on the full default trace
    full = TraceParser().parse_workload()
    champ = json.loads(CHAMPION.read_text())
    tev = CodeEvaluator(full, cfg, engine="exact", use_vm=False, device=dev)
    t0 = time.perf_counter()
    alone = tev.evaluate_one(champ["code"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    diff = abs(alone.score - champ["score"])
    if not alone.ok or diff > 1e-6:
        raise AssertionError(f"the 0.5365 champion scores {alone.score} on "
                             f"the transpiled tier, its file {champ['score']}"
                             f" ({alone.error})")
    (graphed,) = (fn.graphs for fn in tev._cache.values())
    _, lanes, replays, ms = graph_report(graphed)
    out["c"] = report(
        f"(c) the 0.5365 champion through the transpiled tier on the full "
        f"trace (8152 pods, exact engine): {alone.score:.12f}, |diff| "
        f"{diff:.3g} from its file's {champ['score']}", wall, "none",
        lanes, tev.compile_count, replays, 1 / wall, ms)
    out["c"]["diff"] = diff

    # (d) ParametricEvolution on the fused kernel: init_from_weights, and a
    # checkpoint after 2 generations resumed for 1 equal to 3 in a row
    weights = load_champion_weights(CHAMPION, device=dev)
    fcfg = SimConfig(track_ctime=False)

    def seeded():
        pe = ParametricEvolution(full, pop_size=POP, cfg=fcfg, engine="fused",
                                 seed=0, device=dev)
        pe.init_from_weights(weights, 0.05, seed=0)
        return pe

    fused.fused_sim.launches = 0
    t0 = time.perf_counter()
    straight = seeded()
    if not torch.equal(straight.params[0], weights):
        raise AssertionError("init_from_weights moved lane 0")
    torch.cuda.synchronize()
    t_gen = time.perf_counter()
    straight.run(3)
    torch.cuda.synchronize()
    s_per_gen = (time.perf_counter() - t_gen) / 3
    half = seeded()
    half.run(2)
    resumed = seeded()
    resumed.restore_checkpoint(half.save_checkpoint(str(work / "pe")))
    resumed.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.fused_sim.launches
    if not launches:
        raise AssertionError("ParametricEvolution never launched the kernel")
    if not torch.equal(resumed.params, straight.params) \
            or resumed.best_score != straight.best_score:
        raise AssertionError("the resumed fused run differs from the "
                             "uninterrupted one")
    code = resumed.best_code()
    transpiler.transpile(code)
    scored = tev.evaluate_one(code)
    if not scored.ok or not 0 < scored.score <= 1:
        raise AssertionError(f"best_code() does not score: {scored.error}")
    out["d"] = report(
        f"(d) ParametricEvolution pop {POP}, fused kernel, full trace: lane "
        f"0 == the champion; 2 generations + checkpoint + restore + 1 == 3 "
        f"in a row (params and best {resumed.best_score:.6f} equal); "
        f"best_code() scores {scored.score:.6f} on the transpiled tier; "
        f"{s_per_gen:.4f} s per generation; 6 generations and the "
        f"best_code eval", wall, "none", [POP], launches, 0,
        POP / s_per_gen, [])
    out["d"]["s_per_generation"] = s_per_gen

    # (e) the auto-prefilter probe at N = 1,000: captured-graph replays
    # timed with CUDA events, against the eager host-wall reading it
    # replaced (each call between two synchronizes)
    n, g, first_fit, prog = probe_inputs
    probes = {}
    for name, policy, prm in (("parametric", parametric.score, first_fit),
                              ("vm", vm.score_static, prog)):
        on_card = type(prm)(*(x.to(dev) for x in prm)) \
            if isinstance(prm, tuple) else prm.to(dev)
        pod = PodView(*(torch.ones(1, 1, dtype=torch.int32, device=dev)
                        for _ in range(6)))
        vn = torch.ones(1, n, dtype=torch.int32, device=dev)
        vg = torch.ones(1, n, g, dtype=torch.int32, device=dev)
        nodes = NodeView(vn, vn, vn, vn, vn, vn, vg, vg, vg, vg.bool(),
                         vn.bool())
        policy(on_card, pod, nodes)
        host = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            policy(on_card, pod, nodes)
            torch.cuda.synchronize()
            host = min(host, time.perf_counter() - t0)
        cost = engine.probe_policy_cost(policy, prm, n, g, device=dev)
        chosen = engine.resolve_auto_prefilter(policy, prm, n, g, device=dev)
        probes[name] = {"graph_s": cost, "host_wall_s": host, "k": chosen}
    out["probe"] = probes
    if probes["parametric"]["k"] != 0 or probes["vm"]["k"] != 64:
        raise AssertionError(f"auto-prefilter picked {probes}; expected k = "
                             "0 for parametric.score, 64 for the VM")
    log(f"[evolve] (e) probe_policy_cost at N={n}, G={g} (graph replays, "
        f"CUDA events): parametric.score "
        f"{probes['parametric']['graph_s'] * 1e6:.1f} us (eager host wall "
        f"{probes['parametric']['host_wall_s'] * 1e6:.1f} us), auto k="
        f"{probes['parametric']['k']}; vm.score_static capacity 256 "
        f"{probes['vm']['graph_s'] * 1e6:.1f} us (eager host wall "
        f"{probes['vm']['host_wall_s'] * 1e6:.1f} us), auto k="
        f"{probes['vm']['k']}; threshold "
        f"{engine.PREFILTER_COST_THRESHOLD_S * 1e6:.0f} us; card {card}")
    tmp.cleanup()
    log(f"[evolve] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def graph_ms(fn, reps: int = 20, calls: int = 1) -> float:
    """Mean ms of one call of ``fn`` from a CUDA graph that holds ``calls``
    calls back to back: CUDA events around ``reps`` replays (after an
    untimed one), queued behind a spin so the card runs them back to back,
    divided by ``calls``. With one call it is the call plus the graph's own
    launch on the card; with many the graph's launch spreads over the
    calls and each call's marginal time remains, as inside a step's
    graph, with the L2 cache warm."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, reps, hold_s=reps * 25e-6) / calls


#: phase 4b's timed shapes (lanes, nodes): the exact engine's pop 256 on
#: the default cluster, one lane, the auto-prefilter probe, phase 10's
#: population at 1,000 nodes, and 256 lanes at 1,000 nodes
PARAM_SCORE_TIMED = ((256, 16), (1, 16), (1, 1000), (4, 1000), (256, 1000))
MARGINAL_CALLS = 32


def param_score_phase(dev, card) -> dict:
    """Phase 4b (module docstring): csrc/param_score.cu against its plain
    version, its times beside its launch floor and its bound, and the
    auto-prefilter probe."""
    import ctypes

    import torch

    from fks_tpu_torch.funsearch import template, vm
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.ops import _ext
    from fks_tpu_torch.sim import engine
    from fks_tpu_torch.testing import (
        PARAM_SCORE_NODES, param_score_cases, random_policy_views,
    )

    t_phase = time.perf_counter()
    lib = _ext.param_score_library()
    for line in _ext.ptxas_report("param_score").splitlines():
        if "Used" in line or "spill" in line:
            log(f"[param_score] {line.strip()}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                raise AssertionError(f"param_score spills registers: {line}")
    on_card = lambda views: tuple(  # noqa: E731
        type(v)(*(x.to(dev) for x in v)) for v in views)

    def held(label, pod, nodes, w):
        """kernel == plain version on the card == plain version on the
        CPU, float32 and float64: ``(scores compared, max abs
        difference)``."""
        cp, cn = on_card((pod, nodes))
        err = 0
        for dtype in (torch.float32, torch.float64):
            got = parametric.score(w.to(dev), cp, cn, dtype=dtype).long()
            for want in (parametric.score_plain(w.to(dev), cp, cn,
                                                dtype=dtype),
                         parametric.score_plain(w, pod, nodes, dtype=dtype)):
                err = max(err, int((got - want.to(dev).long()).abs().max()))
            if err:
                raise AssertionError(
                    f"param_score {label} {dtype}: kernel differs from the "
                    f"plain version (max abs {err})")
        return 2 * got.numel(), err

    checked = max_err = cases = 0
    runs = [(f"N={n} seed {seed}", *random_policy_views(
        seed, lanes=256, n=n, gpu_heavy=seed % 2 == 1))
        for n in (16, 1000) for seed in range(4)]
    for n in PARAM_SCORE_NODES:
        for case in param_score_cases(n):
            runs.append(case)
            cases += 1
    for label, pod, nodes, w in runs:
        count, err = held(label, pod, nodes, w)
        checked += count
        max_err = max(max_err, err)
    log(f"[param_score] 4 x 256 random views at N = 16 and N = 1,000 and "
        f"{cases} cases of L in (1, 3, 256) x N in {PARAM_SCORE_NODES} x G "
        f"in (1, 8, 32) (shared and per-lane tables and weights, scattered "
        f"masks, milli totals other than 1,000, unfit pods, strided views), "
        f"float32 and float64: {checked} scores, max abs difference "
        f"{max_err} against the plain version on the card and the CPU")

    # times at the timed shapes, one-call replays and marginal in-graph
    # calls, beside an empty kernel of the same grid (the launch floor)
    times = {}
    for lanes, n in PARAM_SCORE_TIMED:
        pod, nodes, w = random_policy_views(7, lanes=lanes, n=n)
        cp, cn = on_card((pod, nodes))
        w = w.to(dev)
        g = nodes.gpu_milli_left.shape[-1]
        block, geo, _ = parametric._score_block(w, cp, cn, torch.float32)
        block = (ctypes.c_longlong * len(block))(*block)

        def new():
            return parametric.score(w, cp, cn)

        def floor():
            err = lib.fks_param_score_floor(
                block, 4, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the floor kernel failed: {err}")

        row = {"ms": graph_ms(new),
               "marginal_ms": graph_ms(new, calls=MARGINAL_CALLS),
               "floor_ms": graph_ms(floor),
               "floor_marginal_ms": graph_ms(floor, calls=MARGINAL_CALLS),
               "plain_ms": graph_ms(
                   lambda: parametric.score_plain(w, cp, cn)),
               "geometry": {"grid": list(geo.grid), "threads": geo.threads,
                            "lanes_per_block": geo.lanes_per_block,
                            "node_tile": geo.node_tile,
                            "smem_bytes": geo.smem_bytes}}
        # bytes each input is read once, the scores written once: pod
        # fields 4 x L, per-lane node fields 3 x L x N, shared node fields
        # 3 x N and the node mask (1 byte), GPU free milli L x N x G,
        # shared GPU totals N x G and mask (1 byte), weights L x 16, out L
        # x N; about 60 float operations per score
        nbytes = 4 * (4 * lanes + 3 * lanes * n + 3 * n + lanes * n * g
                      + n * g + 16 * lanes + lanes * n) + n + n * g
        bound = max(nbytes / HBM_BYTES_PER_S, 60 * lanes * n / F32_OPS_PER_S)
        row.update(bound_ms=bound * 1e3, bytes=nbytes)
        times[f"L{lanes}_N{n}"] = row
        us = {k: v * 1e3 for k, v in row.items()
              if k == "ms" or k.endswith("_ms")}
        log(f"[param_score] L={lanes} N={n} G={g}: kernel {us['ms']:.2f} us "
            f"per call (one-call graph), {us['marginal_ms']:.2f} us marginal "
            f"({MARGINAL_CALLS} calls per graph); empty kernel of the same "
            f"grid {us['floor_ms']:.2f} / {us['floor_marginal_ms']:.2f} us; "
            f"plain {us['plain_ms']:.2f} us; bound {us['bound_ms']:.3f} us "
            f"({nbytes} bytes); grid {geo.grid} x {geo.threads} threads, "
            f"{geo.lanes_per_block} lanes x {geo.node_tile} nodes per "
            f"block, {geo.smem_bytes} shared bytes; card {card}")
    parametric.score.launches = 0  # timing launches are not main-path ones

    # the probe at N = 1,000: the parametric policy keeps the dense sweep,
    # the VM turns the prefilter on, as in fks_tpu
    n, g = 1000, 8
    first_fit = parametric.seed_weights("first_fit")
    prog = vm.compile_policy(template.seed_policies()["first_fit"], n, g,
                             capacity=256)
    probe = {}
    for name, policy, prm in (("parametric", parametric.score, first_fit),
                              ("vm", vm.score_static, prog)):
        probe[name] = {
            "graph_s": engine.probe_policy_cost(policy, prm, n, g,
                                                device=dev),
            "k": engine.resolve_auto_prefilter(policy, prm, n, g,
                                               device=dev)}
    log(f"[param_score] probe at N={n}: parametric.score "
        f"{probe['parametric']['graph_s'] * 1e6:.2f} us, k="
        f"{probe['parametric']['k']}; vm.score_static capacity 256 "
        f"{probe['vm']['graph_s'] * 1e6:.1f} us, k={probe['vm']['k']}; "
        f"threshold {engine.PREFILTER_COST_THRESHOLD_S * 1e6:.0f} us")
    if probe["parametric"]["k"] != 0 or probe["vm"]["k"] != 64:
        raise AssertionError(f"auto-prefilter picked {probe}; expected k = 0 "
                             "for parametric.score and 64 for the VM")
    parametric.score.launches = 0
    log(f"[param_score] phase {time.perf_counter() - t_phase:.1f} s")
    return {"max_abs_err": max_err, "times": times, "probe": probe,
            "checked": checked}


def serve_phase(dev, card) -> dict:
    """Phase 12 (module docstring): champion serving on the card — the
    selftest, latencies and captures per bucket, the hot swap, the HTTP
    front and the parity audit of every served answer."""
    import threading
    import urllib.request

    import numpy as np

    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.obs.telemetry import CompileWatcher
    from fks_tpu_torch.obs.watchdog import ParitySentinel
    from fks_tpu_torch.serve import (
        ServeEngine, ServeService, VMServeEngine, load_champion,
        make_http_server, selftest,
    )

    t_phase = time.perf_counter()
    pins = json.loads((ROOT / "tests" / "fixtures" / "serve_pins.json")
                      .read_text())
    wl = TraceParser().parse_workload()
    first, second = (load_champion(str(ROOT / "policies" / "discovered"
                                       / name)) for name in pins["champions"])
    queries = pins["queries"]
    served = []  # (label, pods, answer) for the audit

    def same_as_pins(label, answers, name):
        want = pins["answers"][name]
        worst = 0.0
        for got, pin in zip(answers, want):
            if got["placements"] != pin["placements"] \
                    or got["scheduled"] != pin["scheduled"]:
                raise AssertionError(f"{label}: placements differ from "
                                     f"the pins ({name})")
            worst = max(worst, abs(got["score"] - pin["score"]))
        if len(answers) != len(want) or worst > TOL:
            raise AssertionError(f"{label}: scores differ from the pins by "
                                 f"{worst} (tol {TOL})")
        return worst

    def check_selftest(label, eng):
        t0 = time.perf_counter()
        st = selftest(eng, count=8, pods_per_query=4)
        if not st["ok"] or st["max_drift"] != 0.0 \
                or not st["placements_match"]:
            raise AssertionError(f"{label} selftest failed: {st}")
        log(f"[serve] ({label}) selftest ok: {st['checked']} queries, "
            f"max_drift {st['max_drift']}, placements match, kind "
            f"{st['engine_kind']}, tier {st['policy_tier']}, "
            f"{time.perf_counter() - t0:.1f} s")
        return st

    # (a) the closure engine: selftest, and the pinned answers
    t0 = time.perf_counter()
    eng = ServeEngine(first, wl, device=dev)
    log(f"[serve] (a) ServeEngine: champion {pins['champions'][0]}, tier "
        f"{eng.policy_tier}, prefilter k {eng.prefilter_k}, envelope "
        f"{eng.envelope.to_json()}, built in {time.perf_counter() - t0:.1f}"
        f" s")
    if eng.engine_kind != "aot":
        raise AssertionError(f"expected the closure engine, got "
                             f"{eng.engine_kind}")
    check_selftest("a", eng)
    if [eng.base_pods[i:i + 4] for i in range(8)] != queries:
        raise AssertionError("phase 12's queries differ from the pins'")
    answers_a = eng.answer_batch(queries)
    d = same_as_pins("(a)", answers_a, pins["champions"][0])
    # the audit (e) takes two of (a)'s and (c)'s answers: all of them are
    # held to the pins already (cut from every answer for phase 16)
    served += [("a", q, a) for q, a in zip(queries[:2], answers_a)]
    log(f"[serve] (a) 8 pinned queries equal tests/fixtures/serve_pins.json"
        f" (placements and scheduled exact, max score |d| {d})")

    # (b) latencies and captures per (pod bucket, lane bucket)
    base = eng.base_pods
    with CompileWatcher() as w:
        graphs = eng.warmup(lane_buckets=[1, 8], pod_buckets=[16, 64, 256])
    log(f"[serve] (b) warmup: {w.backend_compile_count} graph captures "
        f"({w.backend_compile_seconds:.1f} s), {graphs} graphs resident")
    rows = {}
    with CompileWatcher() as warm:
        for bucket in (16, 64, 256):
            size = eng.envelope.min_real_pods(bucket)
            size = 4 if bucket == 16 else size
            for lanes in (1, 8):
                # 20 one-lane queries at 16 pods, 5 at 64 (1.4 s each)
                # and 3 at 256 (4-5 s each); 24 at eight lanes, 16 at 256
                # pods (5-6 s per batch): cut from 20 and 24 for phases 15
                # and 16
                count = ({16: 20, 64: 5, 256: 3}[bucket] if lanes == 1
                         else 16 if bucket == 256 else 24)
                lat, replays, steps = [], 0, []
                h2d0, q0 = eng.h2d_bytes_total, eng.h2d_queries
                for b0 in range(0, count, lanes):
                    batch = [base[(b0 + i) * 3:(b0 + i) * 3 + size]
                             for i in range(lanes)]
                    # the engine's one shard (no mesh): its graph
                    graph = eng.compiled_for(lanes, bucket).graphs[0]
                    r0 = graph.chunk.replays
                    t0 = time.perf_counter()
                    ans = eng.answer_batch(batch)
                    wall = time.perf_counter() - t0
                    lat += [wall * 1e3] * lanes
                    replays += graph.chunk.replays - r0
                    steps.append((graph.chunk.replays - r0)
                                 * graph.chunk.steps)
                    if b0 == 0 and lanes == 1:
                        served += [(f"b{bucket}", batch[0], ans[0])]
                step_ms = cuda_ms(graph.chunk.replay, 5) / graph.chunk.steps
                rows[f"{bucket}x{lanes}"] = {
                    "queries": count, "pods_per_query": size,
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "replays": replays, "steps_per_batch": float(
                        np.mean(steps)), "ms_per_step": step_ms,
                    "h2d_bytes_per_query": (eng.h2d_bytes_total - h2d0)
                    / (eng.h2d_queries - q0)}
                r = rows[f"{bucket}x{lanes}"]
                log(f"[serve] (b) pod bucket {bucket}, lane bucket {lanes}:"
                    f" {count} queries of {size} pods, p50 "
                    f"{r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms per "
                    f"query, {r['steps_per_batch']:.1f} steps per batch, "
                    f"{step_ms:.3f} ms per step (graph replay, CUDA events),"
                    f" {r['h2d_bytes_per_query']:.0f} H2D bytes per query")
    if warm.backend_compile_count:
        raise AssertionError(f"{warm.backend_compile_count} graph captures "
                             "on the warm path")
    log(f"[serve] (b) warm path: 0 graph captures over "
        f"{sum(r['queries'] for r in rows.values())} queries; card {card}")
    # the top pod bucket: a 257-pod query (the smallest it takes; a
    # 1,024-pod one took 70-84 s, cut to make room for phase 15)
    big = base[:257]
    with CompileWatcher() as w:
        t0 = time.perf_counter()
        ans = eng.answer_batch([big])[0]
        big_s = time.perf_counter() - t0
    graph = eng.compiled_for(1, 1024).graphs[0]
    if not np.isfinite(ans["score"]) or ans["scheduled"] <= 0:
        raise AssertionError(f"the 257-pod query answered {ans}")
    log(f"[serve] (b) one 257-pod query (pod bucket 1,024): {big_s:.1f} s "
        f"with "
        f"{w.backend_compile_count} capture ({w.backend_compile_seconds:.1f}"
        f" s), {graph.chunk.replays} replays, {ans['events']} events, "
        f"scheduled {ans['scheduled']}, score {ans['score']:.6f}")
    rows["257in1024x1"] = {"seconds": big_s, "events": ans["events"],
                      "replays": graph.chunk.replays,
                      "captures": w.backend_compile_count,
                      "capture_s": w.backend_compile_seconds}

    # (c) the VM engine: selftest, a zero-capture swap, the pins
    veng = VMServeEngine(first, wl, device=dev)
    check_selftest("c", veng)
    same_as_pins("(c) VM", veng.answer_batch(queries), pins["champions"][0])
    with CompileWatcher() as w:
        t0 = time.perf_counter()
        old = veng.swap_program(second)
        swap_ms = (time.perf_counter() - t0) * 1e3
        swapped = veng.answer_batch(queries)
    if w.backend_compile_count:
        raise AssertionError(f"{w.backend_compile_count} captures on swap")
    fresh = VMServeEngine(second, wl, device=dev).answer_batch(queries)
    for a, b in zip(swapped, fresh):
        if a["placements"] != b["placements"] or a["score"] != b["score"]:
            raise AssertionError("(c) the swapped engine differs from a "
                                 "fresh engine on the second champion")
    same_as_pins("(c) swapped", swapped, pins["champions"][1])
    served += [("c", q, a) for q, a in zip(queries[:2], swapped)]
    veng.swap_program(old)
    same_as_pins("(c) swapped back", veng.answer_batch(queries),
                 pins["champions"][0])
    log(f"[serve] (c) swap_program to {pins['champions'][1]}: {swap_ms:.1f}"
        f" ms ({veng.last_swap_breakdown['h2d_bytes']} H2D bytes), 0 graph "
        f"captures, answers equal a fresh VMServeEngine and the pins; "
        f"swapped back, answers equal the first champion's pins")

    # (d) the HTTP front: 3 concurrent POST /query share one batch
    service = ServeService(eng, max_batch=3, max_wait_s=5.0)
    server = make_http_server(service, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    out = [None] * 3

    def client(k):
        req = urllib.request.Request(
            f"{url}/query", data=json.dumps(
                {"id": f"h{k}", "pods": queries[k]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out[k] = json.loads(r.read())

    try:
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        http_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=60)
    batches = service.summary(record=False)["batches"]
    for k in range(3):
        if out[k] is None or out[k]["placements"] != \
                answers_a[k]["placements"] \
                or out[k]["score"] != answers_a[k]["score"]:
            raise AssertionError(f"HTTP answer {k} differs from (a)'s")
    if batches != 1 or not health["ok"]:
        raise AssertionError(f"HTTP: {batches} batches, healthz {health}")
    served += [("d", queries[k], out[k]) for k in range(3)]
    log(f"[serve] (d) HTTP: 3 concurrent POST /query answered in "
        f"{http_s:.2f} s in one batch, equal to (a)'s; GET /healthz "
        f"{health['engine_state']}, {health['requests_served']} served")

    # (e) the sampling parity sentinel over the served answers
    sentinel = ParitySentinel(None, sample=1, tol=1e-5)
    second_eng = VMServeEngine(second, wl, device=dev)
    refs = {}
    t0 = time.perf_counter()
    for label, pods, ans in served:
        ref_eng = second_eng if label == "c" else eng
        key = (label == "c", json.dumps(pods))
        if key not in refs:  # (d) re-asks (a)'s first queries
            refs[key] = ref_eng.reference_answer(pods)
        ref = refs[key]
        sentinel.audit_served(label, ans["score"], ref["score"],
                              placements_match=ans["placements"]
                              == ref["placements"])
    if sentinel.alerts:
        raise AssertionError(f"the parity sentinel raised {sentinel.alerts} "
                             "alerts over the served answers")
    log(f"[serve] (e) ParitySentinel.audit_served: {sentinel.checked} served"
        f" answers of (a)-(d) against the unbatched exact reference, 0 "
        f"alerts, max drift {sentinel.max_drift} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return {"latency": rows, "swap_ms": swap_ms, "audited":
            sentinel.checked, "http_s": http_s}


def results_equal(label, got, want, lanes=None) -> None:
    """Every field of two SimResults bit-identical (``lanes`` cuts both)."""
    import torch

    from fks_tpu_torch.sim.types import tensor_leaves

    for name in ("policy_score", "scheduled_pods", "events_processed",
                 "assigned_node", "assigned_gpus", "num_snapshots",
                 "num_fragmentation_events", "max_nodes", "failed",
                 "truncated", "cpu_left", "mem_left", "gpu_left",
                 "gpu_milli_left", "avg_cpu_utilization",
                 "gpu_fragmentation_score"):
        a, b = getattr(got, name), getattr(want, name)
        if lanes is not None:
            a, b = a[:lanes], b[:lanes]
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{label}: {name} differs")
    if (got.trace is None) != (want.trace is None):
        raise AssertionError(f"{label}: one result has a trace")
    if got.trace is not None:
        for a, b in zip(tensor_leaves(got.trace), tensor_leaves(want.trace)):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"{label}: decision traces differ")


def mesh_phase(dev, card, wl, params, ref) -> dict:
    """Phase 13 (module docstring): the device mesh and the champion
    portfolio on the card, with logical shards of the one card standing
    in for devices. ``ref`` is phase 4's unsharded fused result of
    ``params`` on ``wl``."""
    import os
    import socket
    import tempfile
    import threading
    import urllib.request

    import torch
    import torch.distributed as dist

    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.funsearch.backend import CodeEvaluator
    from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.obs.layout import LayoutSpec
    from fks_tpu_torch.obs.telemetry import CompileWatcher
    from fks_tpu_torch.parallel import (
        init_distributed, layout_mesh, make_population_eval,
        make_sharded_eval, pad_population, population_mesh,
    )
    from fks_tpu_torch.parallel.mesh import top_k_real
    from fks_tpu_torch.portfolio import (
        PortfolioEngine, PortfolioService, Router, portfolio_selftest,
    )
    from fks_tpu_torch.scenarios import (
        aggregate, get_suite, make_sharded_suite_eval, make_suite_eval,
    )
    from fks_tpu_torch.serve import (
        ChampionSpec, ServeEngine, ShapeEnvelope, VMServeEngine,
        load_champion, make_http_server, selftest,
    )
    from fks_tpu_torch.sim import fused
    from fks_tpu_torch.sim.engine import SimConfig

    t_phase = time.perf_counter()
    out = {}
    cases = {}
    parser = TraceParser()
    mesh4 = population_mesh([dev] * 4)
    cfg = SimConfig(track_ctime=False)

    def case(name, fn):
        t0 = time.perf_counter()
        with CompileWatcher() as w:
            held = fn()
        secs = time.perf_counter() - t0
        cases[name] = {"seconds": secs,
                       "captures": w.backend_compile_count}
        log(f"[mesh] ({name}) {held}; {secs:.1f} s, "
            f"{w.backend_compile_count} graph captures; card {card}")

    # (a) the sharded fused eval at full width
    def a():
        mesh1 = population_mesh()
        want_idx = top_k_real(ref.policy_score, POP, 8)[1]
        ms = {}
        for label, mesh in (("1", mesh1), ("4", mesh4)):
            ev = make_sharded_eval(wl, mesh, cfg=cfg, engine="fused")
            n0 = fused.fused_sim.launches
            scores, idx, _ = ev(params)
            per_eval = fused.fused_sim.launches - n0
            results_equal(f"(a) {label} shard(s)", ev.results(params), ref)
            if not torch.equal(scores, ref.policy_score) \
                    or not torch.equal(idx, want_idx):
                raise AssertionError(f"(a) {label}: scores or elites differ")
            t0 = time.perf_counter()
            for _ in range(3):
                ev(params)
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) / 3 * 1e3
            out[f"launches_per_eval_{label}"] = per_eval
        p250, real = pad_population(params[:250], mesh4)
        scores, idx, _ = make_sharded_eval(wl, mesh4, cfg=cfg,
                                           engine="fused")(p250, real)
        if p250.shape[0] != 252 or real != 250 \
                or not torch.equal(scores[:250], ref.policy_score[:250]) \
                or not torch.equal(idx, top_k_real(ref.policy_score[:250],
                                                   250, 8)[1]) \
                or bool((idx >= 250).any()):
            raise AssertionError("(a) pop 250 padded to 252 differs")
        out["fused_ms_per_eval"] = ms
        return (f"sharded fused eval, pop {POP}, full default trace: every "
                f"field bit-identical to the unsharded eval at 1 shard and "
                f"4 logical shards, elites the stable top-8; pop 250 padded "
                f"to 252 (real_count 250) equal, no pad lane among the "
                f"elites; {ms['1']:.3f} ms per eval at 1 shard, "
                f"{ms['4']:.3f} at 4 (launches per eval "
                f"{out['launches_per_eval_1']} and "
                f"{out['launches_per_eval_4']})")

    case("a", a)

    # (b) the sharded exact eval, and its decision trace
    wl512 = parser.parse_workload(max_pods=512).to(dev)

    def b():
        for trace in (False, True):
            c = SimConfig(decision_trace=trace)
            want = make_population_eval(wl512, cfg=c, device=dev)(params[:16])
            ev = make_sharded_eval(wl512, mesh4, cfg=c)
            got = ev(params[:16])
            results_equal(f"(b) trace={trace}", ev.results(params[:16]), want)
            if not torch.equal(got[0], want.policy_score):
                raise AssertionError("(b) sharded exact scores differ")
            if trace:
                for x, y in zip((got[3].data, got[3].count),
                                (want.trace.data, want.trace.count)):
                    if not torch.equal(x, y):
                        raise AssertionError("(b) returned trace differs")
        return ("exact eval, first 512 pods, pop 16, 4 logical shards: "
                "every field equal to the unsharded exact eval, and with "
                "decision_trace the traces too")

    case("b", b)

    # (c) the generation step through ParametricEvolution
    def c():
        def make():
            return ParametricEvolution(wl, pop_size=POP, cfg=cfg,
                                       engine="fused", mesh=mesh4, seed=0)

        first = make()
        before = first.params.clone()
        scores = first.eval(before).policy_score
        first.run(1)
        lead = top_k_real(scores, POP, 4)[1]
        if not torch.equal(first.params[:4], before[lead]):
            raise AssertionError("(c) the elites left the leading slots")
        straight = make()
        straight.run(3)
        bests = [h.best_score for h in straight.history]
        if any(y < x for x, y in zip(bests, bests[1:])):
            raise AssertionError(f"(c) the best score fell: {bests}")
        half = make()
        half.run(2)
        resumed = make()
        with tempfile.TemporaryDirectory() as tmp:
            resumed.restore_checkpoint(half.save_checkpoint(
                os.path.join(tmp, "pe")))
        resumed.run(1)
        if not torch.equal(resumed.params, straight.params):
            raise AssertionError("(c) the resumed run differs")
        return (f"ParametricEvolution, 4 logical shards, fused, pop {POP}: "
                f"elites in the leading slots, best {bests} never falls, "
                f"2 generations + checkpoint + 1 == 3 in a row")

    case("c", c)

    # (d) the sharded code eval
    champ = load_champion(str(CHAMPION))
    codes = list(template.seed_policies().values()) + [champ.code]
    wl_code = parser.parse_workload(max_pods=CODE_PODS).to(dev)
    mesh2 = population_mesh([dev] * 2)

    def d():
        got = {}
        for engine, seg in (("exact", "0"), ("flat", "32")):
            # CodeEvaluator reads its segment length from the environment
            # (fks_tpu's knob); the caller's value comes back afterwards
            before = os.environ.get("FKS_VM_SEG_STEPS")
            os.environ["FKS_VM_SEG_STEPS"] = seg
            try:
                sharded = CodeEvaluator(wl_code, engine=engine, mesh=mesh2)
                single = CodeEvaluator(wl_code, engine=engine, device=dev)
            finally:
                if before is None:
                    del os.environ["FKS_VM_SEG_STEPS"]
                else:
                    os.environ["FKS_VM_SEG_STEPS"] = before
            a_, b_ = sharded.evaluate(codes), single.evaluate(codes)
            if [r.score for r in a_] != [r.score for r in b_] \
                    or sharded.vm_batch_count != 1 \
                    or any(not torch.equal(x.result.assigned_node,
                                           y.result.assigned_node)
                           for x, y in zip(a_, b_)):
                raise AssertionError(f"(d) {engine}: sharded != one device")
            got[engine] = [r.score for r in a_]
        return (f"CodeEvaluator, 2 logical shards, {len(codes)} codes (the "
                f"seeds and the 0.5365 champion) on the first {CODE_PODS} "
                f"pods: exact (seg_steps 0) {got['exact']} and flat "
                f"(seg_steps 32) {got['flat']} equal the single-device "
                f"scores and placements")

    case("d", d)

    # (e) the sharded suite eval, both layouts
    def e():
        suite = get_suite("default8", parser.parse_workload(max_pods=512))
        want = make_suite_eval(suite, population=True,
                               device=dev)(params[:8]).policy_score
        scn = LayoutSpec(shard=("candidates", "scenarios"),
                         vmap=("candidates", "scenarios"))
        for label, mesh, layout in (
                ("2 shards", population_mesh([dev] * 2), None),
                ("2 x 2 scenario-sharded", layout_mesh([dev] * 4, 2), scn)):
            robust, per, idx, _ = make_sharded_suite_eval(
                suite, mesh, layout=layout)(params[:8])
            if not torch.equal(per, want) \
                    or not torch.equal(robust, aggregate(want)) \
                    or not torch.equal(idx, top_k_real(aggregate(want), 8,
                                                       8)[1]):
                raise AssertionError(f"(e) {label} differs")
        return ("default8 (first 512 pods), pop 8: the sharded suite eval "
                "on 2 logical shards and on layout_mesh(scenario_shards=2) "
                "equals make_suite_eval(population=True)")

    case("e", e)

    # (f) mesh-sharded serving
    pins = json.loads((ROOT / "tests" / "fixtures" / "serve_pins.json")
                      .read_text())
    first, second = (load_champion(str(ROOT / "policies" / "discovered"
                                       / name)) for name in pins["champions"])
    full = parser.parse_workload()
    queries = pins["queries"]

    def same_as_pins(label, answers, name):
        for got, pin in zip(answers, pins["answers"][name]):
            if got["placements"] != pin["placements"] \
                    or abs(got["score"] - pin["score"]) > TOL:
                raise AssertionError(f"(f) {label} differs from the pins")

    def f():
        held = []
        for cls in (ServeEngine, VMServeEngine):
            eng = cls(first, full, mesh=mesh4)
            st = selftest(eng, count=4, pods_per_query=4)
            if not st["ok"] or st["max_drift"] != 0.0:
                raise AssertionError(f"(f) {cls.__name__} selftest: {st}")
            same_as_pins(cls.__name__, eng.answer_batch(queries),
                         pins["champions"][0])
            with CompileWatcher() as w:
                same_as_pins(cls.__name__ + " warm",
                             eng.answer_batch(queries), pins["champions"][0])
                if cls is VMServeEngine:
                    old = eng.swap_program(second)
                    same_as_pins("swapped", eng.answer_batch(queries),
                                 pins["champions"][1])
                    eng.swap_program(old)
            if w.backend_compile_count:
                raise AssertionError(f"(f) {cls.__name__}: "
                                     f"{w.backend_compile_count} captures "
                                     "warm")
            held.append(cls.__name__)
        return (f"{' and '.join(held)} on 4 logical shards, 0.5365 champion"
                f", default cluster: selftest drift 0, 8 queries equal "
                f"serve_pins.json, 0 captures warm and across swap_program")

    case("f", f)

    # (g) the portfolio
    from fks_tpu_torch.cli import _PORTFOLIO_LOGICS

    def g():
        champs = [ChampionSpec(code=template.fill_template(lg),
                               score=0.5 + 0.1 * i, source=f"<builtin-{i}>")
                  for i, lg in enumerate(_PORTFOLIO_LOGICS[:3])]
        eng = PortfolioEngine(champs, full, n_slots=4, device=dev,
                              envelope=ShapeEnvelope(max_pods=64,
                                                     max_batch=4))
        eng.warmup(lane_buckets=[1, 4], pod_buckets=[16])
        st = portfolio_selftest(eng, count=4)
        if not st["ok"] or st["max_drift"] != 0.0:
            raise AssertionError(f"(g) portfolio_selftest: {st}")
        base = eng.base_pods
        stop, errors = threading.Event(), []

        def hammer(slot):
            i = 0
            while not stop.is_set():
                q = [dict(base[(i + j) % len(base)]) for j in range(3)]
                try:
                    eng.answer_batch([q], slots=[slot])
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(repr(exc))
                    return
                i += 1

        with CompileWatcher() as w:
            threads = [threading.Thread(target=hammer, args=(s,))
                       for s in range(4)]
            for t in threads:
                t.start()
            old = eng.swap_slot(1, champs[2])
            if old.source != "<builtin-1>":
                raise AssertionError("(g) swap_slot's rollback handle")
            eng.swap_slot(1, old)
            stop.set()
            for t in threads:
                t.join(timeout=120)
        if w.backend_compile_count or errors:
            raise AssertionError(f"(g) swap under load: "
                                 f"{w.backend_compile_count} captures, "
                                 f"errors {errors[:2]}")
        router = Router(eng.n_slots, pins={"vip": 1},
                        ab_split={0: 0.5, 2: 0.5})
        expect = Router(eng.n_slots, pins={"vip": 1},
                        ab_split={0: 0.5, 2: 0.5})
        service = PortfolioService(eng, router=router, max_wait_s=0.002)
        server = make_http_server(service, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/query"
        try:
            for k, tenant in enumerate(("vip", "t", "t", "vip", "t")):
                pods = base[k:k + 3]
                want_slot, _ = expect.route(f"h{k}", tenant, pods)
                req = urllib.request.Request(url, data=json.dumps(
                    {"id": f"h{k}", "tenant": tenant, "pods": pods}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    ans = json.loads(r.read())
                solo = eng.answer_batch([pods], slots=[want_slot])[0]
                if ans["slot"] != want_slot \
                        or ans["placements"] != solo["placements"]:
                    raise AssertionError(f"(g) HTTP request {k} routed to "
                                         f"{ans['slot']}, want {want_slot}")
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=60)
        t0 = time.perf_counter()
        sub = subprocess.run(
            [sys.executable, "-m", "fks_tpu_torch.cli", "portfolio",
             "--selftest", "4"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        if sub.returncode != 0:
            raise AssertionError(f"(g) cli portfolio --selftest 4 exited "
                                 f"{sub.returncode}: {sub.stderr[-2000:]}")
        out["cli_portfolio_s"] = time.perf_counter() - t0
        return (f"PortfolioEngine, 3 builtin logics + 1 spare slot, default "
                f"cluster: portfolio_selftest(count=4) ok, max_drift 0.0; "
                f"swap_slot out and back under 4 querying threads: 0 "
                f"captures, no errors; HTTP pin/ab routing as the Router "
                f"says; `cli portfolio --selftest 4` exited 0 in "
                f"{out['cli_portfolio_s']:.1f} s")

    case("g", g)

    # (h) the process group at world size 1
    def h():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        n = init_distributed(f"localhost:{port}", 1, 0, backend="nccl")
        try:
            local = ref.policy_score.contiguous()
            parts = [torch.empty_like(local)]
            dist.all_gather(parts, local)
            if n != 1 or not torch.equal(parts[0], local):
                raise AssertionError("(h) all_gather differs")
        finally:
            dist.destroy_process_group()
        return ("init_distributed over NCCL at world size 1 (localhost): "
                "all_gather of (a)'s score vector equals it; group "
                "destroyed")

    case("h", h)
    out["cases"] = cases
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase {out['seconds']:.1f} s; card {card}")
    return out


INCUMBENT = (ROOT / "policies" / "discovered"
             / "funsearch_20260801_023751_score0.5268.json")


def control_plane_phase(dev, card) -> dict:
    """Phase 14 (module docstring): the control plane on the card — the
    drill matrix, one promotion on the default cluster through the VM
    fast path with its rollback and recovery, a drain with queries in
    flight, and ``follow_ledger`` promoting through the AOT path while a
    client thread queries."""
    import dataclasses
    import shutil
    import tempfile
    import threading

    import numpy as np

    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.obs.history import SLOConfig
    from fks_tpu_torch.obs.telemetry import CompileWatcher
    from fks_tpu_torch.pipeline import (
        PromotionConfig, PromotionController, follow_ledger, run_drills,
    )
    from fks_tpu_torch.resilience import DrainCoordinator, load_serve_state
    from fks_tpu_torch.serve import (
        ServeEngine, ServeService, ShapeEnvelope, VMServeEngine,
        load_champion,
    )

    t_phase = time.perf_counter()
    out = {}

    # (a) the drill matrix on the card: every drill must hold
    t0 = time.perf_counter()
    drills = run_drills(log=lambda m: log(f"[control] (a) {m[:300]}"),
                        device=dev)
    failed = [r for r in drills if not r["ok"]]
    if len(drills) != 18 or failed:
        raise AssertionError(f"drills failed on the card: {failed}")
    out["drills_s"] = time.perf_counter() - t0
    log(f"[control] (a) {len(drills)} drills ok on the card in "
        f"{out['drills_s']:.1f} s; card {card}")

    # (b) one promotion on the default cluster: VM fast path, probation
    # rollback on a forced burn, then recovery from the log alone
    wl = TraceParser().parse_workload()
    incumbent = load_champion(str(INCUMBENT))
    t0 = time.perf_counter()
    veng = VMServeEngine(incumbent, wl, device=dev)
    veng.warmup(pod_buckets=[16])
    windows = [veng.base_pods[i:i + 4] for i in range(8)]
    service = ServeService(veng, max_wait_s=0.002)
    tmp = tempfile.TemporaryDirectory()
    ledger = Path(tmp.name) / "ledger"
    ledger.mkdir()

    def traffic(svc, n, tag):
        futs = [svc.submit({"id": f"{tag}{i}", "pods": windows[i % 8]})
                for i in range(n)]
        return [f.result(timeout=600) for f in futs]

    before = traffic(service, 8, "pre")
    shutil.copy(CHAMPION, ledger)
    ctrl = PromotionController(service, wl, ledger_dir=str(ledger),
                               config=PromotionConfig(shadow_queries=4))
    with CompileWatcher() as w:
        t1 = time.perf_counter()
        promoted = ctrl.poll_once()
        poll_s = time.perf_counter() - t1
        swap_captures = w.backend_compile_count
        post = traffic(service, 20, "post")
        post_captures = w.backend_compile_count - swap_captures
    states = [r["state"] for r in ctrl.log.records]
    if promoted["action"] != "promoted" or promoted["engine_kind"] != "vm" \
            or states != ["PENDING", "SHADOW", "PROMOTED"] \
            or swap_captures or post_captures \
            or service.engine.champion.score != load_champion(
                str(CHAMPION)).score:
        raise AssertionError(f"(b) promotion: {promoted}, states {states},"
                             f" captures {swap_captures}/{post_captures}")
    log(f"[control] (b) PROMOTED 0.5268 -> 0.5365 on the VM fast path: "
        f"poll {poll_s:.2f} s (shadow {promoted['shadow']['shadow_seconds']}"
        f" s, p99 {promoted['shadow']['p99_ms']} ms vs incumbent "
        f"{promoted['shadow']['incumbent_p99_ms']} ms), swap "
        f"{promoted['swap_ms']} ms, {swap_captures} captures on the swap, "
        f"{post_captures} on 20 post-swap queries")
    ctrl.cfg = dataclasses.replace(ctrl.cfg, slo=SLOConfig(p99_ms=1e-6))
    traffic(service, 4, "burn")
    back = ctrl.check_probation()
    again = traffic(service, 8, "back")
    states = [r["state"] for r in ctrl.log.records]
    if back is None or back["action"] != "rolled_back" \
            or states[-1] != "ROLLED_BACK" \
            or service.engine.champion.source != incumbent.source \
            or any(a["placements"] != b["placements"]
                   or a["score"] != b["score"]
                   for a, b in zip(again, before)):
        raise AssertionError(f"(b) rollback: {back}, states {states}")
    recovered = PromotionController(
        service, wl, ledger_dir=str(ledger)).recover()
    if recovered != ctrl.recover() or recovered["active"] is not None:
        raise AssertionError(f"(b) recovery {recovered} != "
                             f"{ctrl.recover()}")
    out["promotion"] = {"poll_s": poll_s, "swap_ms": promoted["swap_ms"],
                        "swap_captures": swap_captures,
                        "post_swap_captures": post_captures,
                        "post_swap_queries": len(post),
                        "seconds": time.perf_counter() - t0}
    log(f"[control] (b) forced burn -> ROLLED_BACK (burn "
        f"{back['burn']['burn_rate']}x), the incumbent serves again with "
        f"its pre-promotion answers; a second controller recovers "
        f"{recovered}; {out['promotion']['seconds']:.1f} s")

    # (c) drain with queries in flight; the state reloads
    t0 = time.perf_counter()
    state_path = str(Path(tmp.name) / "serve_state.json")
    futs = [service.submit({"id": f"d{i}", "pods": windows[i % 8]})
            for i in range(16)]
    dc = DrainCoordinator(service, state_path=state_path, grace_s=600.0)
    report = dc.drain()
    drain_ms = (time.perf_counter() - t0) * 1e3
    answers = [f.result(timeout=1) for f in futs]
    if report["stuck"] or report["shed"] \
            or any(a["placements"] != before[i % 8]["placements"]
                   for i, a in enumerate(answers)):
        raise AssertionError(f"(c) drain: {report}")
    saved = load_serve_state(state_path)
    fresh = ServeService(veng, max_wait_s=0.002)
    preloaded = fresh.preload_replay(saved["replay"])
    fresh.close()
    if saved["requests_served"] != service.requests_served \
            or preloaded != min(64, saved["requests_served"]):
        raise AssertionError(f"(c) state: {saved['requests_served']} "
                             f"served, {preloaded} preloaded")
    out["drain"] = {"drain_ms": drain_ms, "in_flight": len(futs),
                    "completed": report["completed"],
                    "pending": report["pending"],
                    "persisted_replay": len(saved["replay"])}
    log(f"[control] (c) drain with {len(futs)} queries in flight: "
        f"{drain_ms:.1f} ms, {report['completed']} completed (pending "
        f"{report['pending']} at the signal), 0 shed; the state "
        f"({saved['requests_served']} served) reloads and preloads "
        f"{preloaded} replay queries")

    # (d) follow_ledger promotes through the AOT path while a client
    # thread keeps querying: the candidate's ladder is captured on the
    # poll thread while the batcher thread serves
    t0 = time.perf_counter()
    env = ShapeEnvelope(max_pods=16, max_batch=8)
    aot = ServeEngine(incumbent, wl, envelope=env, device=dev)
    aot.warmup()
    service = ServeService(aot, max_wait_s=0.002)
    ledger2 = Path(tmp.name) / "ledger2"
    ledger2.mkdir()
    ctrl = PromotionController(service, wl, ledger_dir=str(ledger2),
                               config=PromotionConfig(shadow_queries=4))
    errors, answered, stop = [], [0], threading.Event()
    sent = []  # (wall-clock start, latency ms) of each answered query

    def client():
        i = 0
        while not stop.is_set():
            t, wall = time.perf_counter(), time.time()
            try:
                service.submit({"pods": windows[i % 8]}).result(timeout=600)
            except Exception as e:  # noqa: BLE001 — the phase's verdict
                errors.append(f"{type(e).__name__}: {e}")
                return
            sent.append((wall, (time.perf_counter() - t) * 1e3))
            answered[0] += 1
            i += 1

    def wait_for(cond, seconds=600):
        deadline = time.monotonic() + seconds
        while not cond() and not errors and time.monotonic() < deadline:
            time.sleep(0.02)

    with CompileWatcher() as w:
        thread = threading.Thread(target=client)
        thread.start()
        try:
            wait_for(lambda: answered[0] >= 16)
            stop_poll, poller = follow_ledger(ctrl, interval=0.05)
            t1, landed = time.perf_counter(), time.time()
            shutil.copy(CHAMPION, ledger2)
            wait_for(lambda: service.swaps > 0)
            promote_s = time.perf_counter() - t1
            during = answered[0]
            wait_for(lambda: answered[0] >= during + 20)
            stop_poll.set()
            poller.join(timeout=600)
        finally:
            stop.set()
            thread.join(timeout=600)
    service.close()
    tmp.cleanup()
    states = [r["state"] for r in ctrl.log.records]
    serving_captures, shadow_captures = w.count_in(""), w.count_in("shadow")
    if errors or states != ["PENDING", "SHADOW", "PROMOTED"] \
            or ctrl.log.records[-1]["engine_kind"] != "aot" \
            or serving_captures or not shadow_captures:
        raise AssertionError(f"(d) follow_ledger: errors {errors[:3]}, "
                             f"states {states}, captures serving "
                             f"{serving_captures} shadow {shadow_captures}")
    # the log's SHADOW and PROMOTED records (wall clock, ms) bound the
    # build and the replay
    at = {r["state"]: r["ts"] for r in ctrl.log.records}
    client_ms = {}
    for name, lo, hi in (("before", 0.0, landed),
                         ("build", landed, at["SHADOW"]),
                         ("replay", at["SHADOW"], at["PROMOTED"]),
                         ("after", at["PROMOTED"], float("inf"))):
        ms = [m for t, m in sent if lo <= t < hi]
        client_ms[name] = ({"queries": len(ms),
                            "p50": float(np.percentile(ms, 50)),
                            "p99": float(np.percentile(ms, 99)),
                            "max": max(ms)} if ms else {"queries": 0})
    out["follow"] = {"promote_s": promote_s, "queries": answered[0],
                     "shadow_captures": shadow_captures,
                     "shadow_capture_s": w.backend_compile_seconds,
                     "serving_captures": serving_captures,
                     "shadow": ctrl.last_shadow,
                     "client_ms": client_ms,
                     "seconds": time.perf_counter() - t0}
    log(f"[control] (d) follow_ledger: PROMOTED through the AOT path "
        f"{promote_s:.1f} s after the champion landed, while a client "
        f"thread answered {answered[0]} queries, none failed; "
        f"{shadow_captures} shadow captures "
        f"({w.backend_compile_seconds:.1f} s) beside the serving thread, "
        f"0 on the serving path; shadow replay p99 "
        f"{ctrl.last_shadow['p99_ms']} ms vs incumbent "
        f"{ctrl.last_shadow['incumbent_p99_ms']} ms; "
        f"{out['follow']['seconds']:.1f} s")
    log(f"[control] (d) client query latency in ms by the query's start "
        f"(before the champion landed / shadow build / shadow replay / "
        f"after the swap): {json.dumps(client_ms)}; card {card}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[control] phase {out['seconds']:.1f} s; card {card}")
    return out


#: phase 15 (e): the evolve loop's pods, and the float tolerance of its
#: pins (fks_tpu's CLI scores in float32, SimConfig(); the card and XLA's
#: CPU backend sum in other orders)
CLI_EVOLVE_PODS = 256
CLI_EVOLVE_TOL = 1e-6
#: phase 15 (f): fks_tpu's ``cli trace-diff --cpu --suite default8
#: --scenario 5`` on the default trace (exit 1: the flat engine's retry
#: rule differs from the exact engine's by design); the port prints the
#: same (tests/test_torch_cli.py holds both to this text)
TRACE_DIFF_FAULT1 = """\
trace-diff: exact vs flat  [best_fit@default8[5:fault1]]
  exact: 16385 steps, fitness 0.446278
  flat: 16462 steps, fitness 0.459356
  FIRST DIVERGENCE at step 9457 (field: kind)
    engine                   kind     pod node        score       margin pending
    exact                    CREATE  4746    9  8040.000000   489.000000    3449
    flat                     RETRY   4727   -1     0.000000     0.000000    3449
"""
#: phase 15 (c) and (d): the synthetic clusters of the two scale runs
#: (nodes, pods)
CLI_FUSED_SHAPE = (16, 8152)
CLI_FLAT_SHAPE = (1000, 10000)


def cli_phase(dev, card, evolve_run_dir) -> dict:
    """Phase 15 (module docstring): the command line on the card, in
    process through ``fks_tpu_torch.cli.main`` with no ``--cpu``; every
    command's exit code must be 0 (a nonzero one raises). Returns the
    seconds of each command and the numbers the summary line carries.
    ``evolve_run_dir`` (a path that does not exist yet, owned by the
    caller: phase 16 reads it) is (e)'s ``evolve --run-dir``."""
    import contextlib
    import io
    import tempfile

    import torch

    from fks_tpu_torch import cli
    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.data.synthetic import synthetic_workload
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.ops import _ext
    from fks_tpu_torch.parallel import make_population_eval
    from fks_tpu_torch.sim import fused

    _ext.fused_sim_library()
    _ext.param_score_library()
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)
    out = {"seconds": {}, "launches": {"fused_sim": 0, "param_score": 0},
           "launches_by_command": {}}

    def counts():
        return {"fused_sim": fused.fused_sim.launches,
                "param_score": parametric.score.launches}

    def run(tag, argv, want_rc=0):
        """``cli.main(argv)`` timed, its kernel launches counted (read
        just before and just after: the comparisons' launches stay out);
        its stdout; raises unless it exits ``want_rc``."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        before = counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in counts().items()}
        out["launches_by_command"][tag] = delta
        for k, v in delta.items():
            out["launches"][k] += v
        out["seconds"][tag] = secs
        if rc != want_rc:
            raise AssertionError(f"cli {' '.join(argv)} exited {rc}:\n"
                                 f"{buf.getvalue()}")
        log(f"[cli] ({tag}) {' '.join(argv[:3])} ...: {secs:.2f} s; "
            f"card {card}")
        return buf.getvalue()

    def schema_ok(*args):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "check_jsonl_schema.py"),
             *args], capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise AssertionError(f"check_jsonl_schema {args}: "
                                 f"{proc.stdout}{proc.stderr}")

    def rows(path):
        return [json.loads(line) for line in Path(path).read_text()
                .splitlines()]

    # (a) simulate best_fit in float64 on the default trace, held to the
    # golden fixture
    golden = json.loads((ROOT / "tests" / "fixtures"
                         / "golden_default.json").read_text())
    want = golden["policies"]["best_fit"]
    m = work / "simulate.jsonl"
    shown = json.loads(run("a", ["simulate", "--policy", "best_fit",
                                 "--f64", "--metrics", str(m)]))
    (sim_row,) = rows(m)
    for k, v in want.items():
        if isinstance(v, list):
            continue
        if isinstance(v, float) and abs(sim_row[k] - v) > 1e-9 or \
                not isinstance(v, float) and sim_row[k] != v:
            raise AssertionError(f"(a) simulate {k}: {sim_row[k]} vs "
                                 f"golden {v}")
    if int(shown["scheduled"]) != want["scheduled_pods"] \
            or shown["events"] != want["events_processed"]:
        raise AssertionError(f"(a) simulate printed {shown}")
    schema_ok("--require", "ts,kind", str(m))
    log(f"[cli] (a) simulate best_fit --f64: score "
        f"{sim_row['policy_score']:.12f}, {sim_row['events_processed']} "
        f"events, every field equal to golden_default.json (floats within "
        f"1e-9); --metrics rows pass tools/check_jsonl_schema.py")

    # (b) bench best_fit,first_fit in float64: the best_fit row is (a)'s
    m = work / "bench.jsonl"
    table = run("b", ["bench", "--policies", "best_fit,first_fit", "--f64",
                      "--metrics", str(m)])
    bench = {r["policy"]: r for r in rows(m)}
    timed = {"ts", "wall_s", "kind"}
    if {k: v for k, v in bench["best_fit"].items() if k not in timed} != \
            {k: v for k, v in sim_row.items() if k not in timed}:
        raise AssertionError(f"(b) bench best_fit {bench['best_fit']} != "
                             f"simulate {sim_row}")
    schema_ok("--require", "ts,kind", str(m))
    log(f"[cli] (b) bench: best_fit row equal to (a), first_fit "
        f"{bench['first_fit']['policy_score']:.12f}\n{table.rstrip()}")

    # (c) scale on the fused kernel, 16 nodes x 8,152 synthetic pods, pop
    # 256: one launch, the scores of a direct population eval
    nodes, pods = CLI_FUSED_SHAPE
    shown = json.loads(run("c", [
        "scale", "--engine", "fused", "--nodes-count", str(nodes),
        "--pods-count", str(pods), "--pop", str(POP)]))
    launches = out["launches_by_command"]["c"]["fused_sim"]
    if launches != 1:
        raise AssertionError(f"(c) scale --engine fused launched the "
                             f"kernel {launches} times, not once")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = make_population_eval(
        synthetic_workload(nodes, pods, seed=0), engine="fused",
        device=dev)(parametric.init_population(gen, POP, noise=0.1))
    for k, v in (("score_min", res.policy_score.min()),
                 ("score_max", res.policy_score.max())):
        if shown[k] != round(float(v), 4):
            raise AssertionError(f"(c) scale {k} {shown[k]} != direct eval "
                                 f"{float(v)}")
    out["fused"] = {"evals_per_sec": shown["evals_per_sec"],
                    "wall_s": shown["wall_s"], "launches": launches}
    log(f"[cli] (c) scale --engine fused, {nodes} x {pods}, pop {POP}: "
        f"{shown['evals_per_sec']} evals/s ({shown['wall_s']} s: the "
        f"eval call, the kernel and the result's fields; the plan is built "
        f"before it), 1 launch, score min/max {shown['score_min']}/"
        f"{shown['score_max']} equal to a direct fused eval")

    # (d) scale on the flat engine at 1,000 nodes x 10,000 pods, pop 4,
    # the auto-prefilter probing parametric.score
    # the command's own SimResult (a spy on the population eval it builds)
    # gives the event count; scale prints none
    import fks_tpu_torch.parallel as par

    nodes, pods = CLI_FLAT_SHAPE
    results, real_eval = [], par.make_population_eval

    def spy(*args, **kw):
        evaluate = real_eval(*args, **kw)

        def kept(pop):
            results.append(evaluate(pop))
            return results[-1]
        return kept

    par.make_population_eval = spy
    try:
        shown = json.loads(run("d", [
            "scale", "--engine", "flat", "--nodes-count", str(nodes),
            "--pods-count", str(pods), "--pop", "4", "--seed", "1"]))
    finally:
        par.make_population_eval = real_eval
    ps_launches = out["launches_by_command"]["d"]["param_score"]
    if not ps_launches:
        raise AssertionError("(d) scale never launched param_score")
    if shown["node_prefilter_k"] != 0 or not shown["prefilter_auto"]:
        raise AssertionError(f"(d) the auto-prefilter picked k = "
                             f"{shown['node_prefilter_k']}, not 0")
    (res,) = results
    events = int(res.events_processed.sum())
    if shown["score_max"] != round(float(res.policy_score.max()), 4):
        raise AssertionError(f"(d) scale score_max {shown['score_max']} "
                             f"!= its eval's "
                             f"{float(res.policy_score.max())}")
    out["flat_1k"] = {"events": events, "wall_s": shown["wall_s"],
                      "events_per_s": events / shown["wall_s"],
                      "param_score_launches": ps_launches}
    log(f"[cli] (d) scale --engine flat, {nodes} x {pods}, pop 4: auto "
        f"k = 0, "
        f"{ps_launches} param_score wrapper calls, {events} events in "
        f"{shown['wall_s']} s = {events / shown['wall_s']:.1f} events/s "
        f"with the capture (SimConfig() as the command builds it; phase "
        f"10's dense run has first_fit lanes and track_ctime=False)")

    # (e) evolve --fake-llm --profile on the first 256 pods, held to
    # fks_tpu's CLI pins; then mem renders the run's memory view
    pins = json.loads((ROOT / "tests" / "fixtures"
                       / "evolve_cli_prefix256_pins.json").read_text())
    (work / "config.json").write_text(json.dumps(pins["config"]))
    run_dir = Path(evolve_run_dir)
    keep = cli._parse_workload
    cli._parse_workload = lambda args: TraceParser().parse_workload(
        max_pods=CLI_EVOLVE_PODS)
    try:
        run("e", ["evolve", "--fake-llm", "--profile", "--config",
                  str(work / "config.json"), "--checkpoint",
                  str(work / "ck.json"), "--metrics",
                  str(work / "evolve.jsonl"), "--run-dir", str(run_dir)])
    finally:
        cli._parse_workload = keep

    ck = json.loads((work / "ck.json").read_text())
    gens = [{k: v for k, v in r.items()
             if k not in EVOLVE_TIME_FIELDS + ("ts", "kind")}
            for r in rows(work / "evolve.jsonl")]
    pins_close("(e) generations", gens, pins["generations"],
               CLI_EVOLVE_TOL)
    pins_close("(e) population", [[sha(p["code"]), p["score"]]
                                  for p in ck["population"]],
               pins["population"], CLI_EVOLVE_TOL)
    pins_close("(e) best", [sha(ck["best"]["code"]), ck["best"]["score"]],
               pins["best"], CLI_EVOLVE_TOL)
    schema_ok("--run-dir", str(run_dir))
    metrics = rows(run_dir / "metrics.jsonl")
    (total,) = [r for r in metrics if r["kind"] == "device_profile"
                and r["stage"] == "__total__"]
    if total["attributed_fraction"] < 0.95:
        raise AssertionError(f"(e) the profiler attributed "
                             f"{total['attributed_fraction']} of the wall")
    stages = {}
    for r in metrics:
        if r["kind"] == "device_profile" and r["stage"] != "__total__" \
                and r.get("depth", 0) == 0:
            stages[r["stage"]] = stages.get(r["stage"], 0.0) + \
                r["wall_seconds"]
    view = run("e-mem", ["mem", "--run-dir", str(run_dir)])
    if "footprint ladder" not in view:
        raise AssertionError(f"(e) mem rendered no footprint:\n{view}")
    out["evolve"] = {"attributed_fraction": total["attributed_fraction"],
                     "measured_wall_s": total["measured_wall_seconds"],
                     "capture_s": total["compile_seconds"],
                     "stage_seconds": stages,
                     "best": ck["best"]["score"]}
    log(f"[cli] (e) evolve --fake-llm --profile, {len(gens)} generations "
        f"on the first {CLI_EVOLVE_PODS} pods: best "
        f"{ck['best']['score']:.12f}; generation rows, population and best "
        f"equal fks_tpu's CLI pins (floats within {CLI_EVOLVE_TOL}); "
        f"__total__ attributes {total['attributed_fraction']:.4f} of "
        f"{total['measured_wall_seconds']:.2f} s "
        f"({total['compile_seconds']:.2f} s of graph captures); stage "
        f"seconds "
        f"{ {k: round(v, 2) for k, v in stages.items()} }; run dir passes "
        f"the schema tool; mem:\n{view.rstrip()}")

    # (f) trace-diff on a fault-injected default8 scenario: fks_tpu's
    # exit code and text (fitness within 1e-6, float32 on the card)
    shown = run("f", ["trace-diff", "--engines", "exact,flat", "--suite",
                      "default8", "--scenario", "5"], want_rc=1)
    for got, want in zip(shown.splitlines(),
                         TRACE_DIFF_FAULT1.splitlines()):
        if "fitness" in want:
            name, value = want.rsplit(" ", 1)
            if not got.startswith(name + " ") or \
                    abs(float(got.rsplit(" ", 1)[1]) - float(value)) > 1e-6:
                raise AssertionError(f"(f) {got!r} vs fks_tpu {want!r}")
        elif got != want:
            raise AssertionError(f"(f) {got!r} vs fks_tpu {want!r}")
    if len(shown.splitlines()) != len(TRACE_DIFF_FAULT1.splitlines()):
        raise AssertionError(f"(f) trace-diff printed:\n{shown}")
    log(f"[cli] (f) exit 1, fks_tpu's first divergence (the flat engine's "
        f"retry rule):\n{shown.rstrip()}")

    # (g) loadgen for 5 s with the hermetic template champion
    summary = json.loads(run("g", ["loadgen", "--duration", "5"]))
    gated = ("loadgen_qps", "loadgen_p99_ms", "loadgen_shed_rate",
             "loadgen_fairness_index")
    if any(k not in summary for k in gated) or summary["errors"] \
            or not summary["completed"]:
        raise AssertionError(f"(g) loadgen summary {summary}")
    out["loadgen"] = {k: summary[k] for k in gated + ("requests",
                                                      "completed")}
    log(f"[cli] (g) loadgen 5 s: {summary['requests']} requests, "
        f"{summary['completed']} completed, 0 failed, "
        + ", ".join(f"{k} {summary[k]}" for k in gated))

    # (h) one watermark sample, and the VM swap leak drill (reduced)
    sample = json.loads(run("h-sample", ["mem", "--sample"]))
    devs = [d for d in sample["devices"] if "bytes_in_use" in d]
    if not devs or any(d["platform"] != "gpu" or not d["bytes_limit"]
                       for d in devs):
        raise AssertionError(f"(h) mem --sample: {sample}")
    drill = json.loads(run("h-drill", ["mem", "--drill", "vm_swap_leak",
                                       "--swaps", "10", "--batches",
                                       "40"]))
    if not drill["ok"] or drill["drift_count"] or drill["drift_bytes"]:
        raise AssertionError(f"(h) vm_swap_leak: {drill}")
    out["mem"] = {"in_use_bytes": devs[0]["bytes_in_use"],
                  "peak_bytes": devs[0]["peak_bytes_in_use"],
                  "limit_bytes": devs[0]["bytes_limit"],
                  "drill_baseline_count": drill["baseline_count"],
                  "drill_baseline_bytes": drill["baseline_bytes"]}
    log(f"[cli] (h) mem --sample: {devs[0]['bytes_in_use']} B in use, peak "
        f"{devs[0]['peak_bytes_in_use']} B, limit {devs[0]['bytes_limit']} "
        f"B; vm_swap_leak 10 swaps x 40 batches: drift 0 blocks / 0 bytes "
        f"over {drill['baseline_count']} live allocator blocks")
    tmp.cleanup()
    out["total_s"] = time.perf_counter() - t_phase
    log(f"[cli] phase {out['total_s']:.1f} s; card {card}")
    return out


#: phase 16 (b): fks_tpu's ``cli layout --explore`` workload
#: (``synthetic_workload(16, 32, seed)``, default8, pop 64) on 4 logical
#: shards of the card; (c) the step profiler's cut depth; (d) the tier
#: benchmark's prefix and candidates (the fewest it takes), and the keys
#: it must return without its generation
EXPLORE_SHARDS = 4
PROFILE_STEPS = 512
PROFILE_LANES = (1, 16, 256)
TIERS_PODS = 128  # 256 before phase 17
TIERS_CANDIDATES = 3
TIERS_KEYS = {
    "device", "engine", "workload", "vm_first_s", "vm_skipped_candidates",
    "vm_warm_s", "vm_tier_hits", "vm_evals_per_sec", "vm_batch_first_s",
    "vm_batch_pop", "vm_batch_launches", "vm_batch_warm_s",
    "vm_batch_evals_per_sec", "jit_compile_run_s", "jit_warm_s",
    "parametric_pop", "parametric_sweep_s", "parametric_evals_per_sec",
    "exact_best_fit_s", "exact_events", "exact_us_per_event"}


def readback_phase(dev, card, evolve_run_dir) -> dict:
    """Phase 16 (module docstring): reading runs back and the tooling, in
    process, no ``--cpu``; every command must exit with its expected
    code. ``evolve_run_dir`` is phase 15 (e)'s ``evolve --profile`` run
    directory. Both kernels' launches are counted around each case."""
    import contextlib
    import io
    import tempfile

    import torch

    from fks_tpu_torch import cli
    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.data.synthetic import synthetic_workload
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.obs import NULL
    from fks_tpu_torch.obs.history import RunHistory
    from fks_tpu_torch.obs.layout import explore_layouts
    from fks_tpu_torch.ops import _ext
    from fks_tpu_torch.scenarios import get_suite
    from fks_tpu_torch.sim import fused
    from fks_tpu_torch.tools import measure_tiers, profile_step

    _ext.fused_sim_library()
    _ext.param_score_library()
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)
    out = {"seconds": {}, "launches": {"fused_sim": 0, "param_score": 0},
           "launches_by_case": {}}

    def counts():
        return {"fused_sim": fused.fused_sim.launches,
                "param_score": parametric.score.launches}

    @contextlib.contextmanager
    def case(tag):
        """Seconds and kernel launches of one case (read just before and
        just after it)."""
        torch.cuda.synchronize()
        before = counts()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        out["seconds"][tag] = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in counts().items()}
        out["launches_by_case"][tag] = delta
        for k, v in delta.items():
            out["launches"][k] += v

    def run(argv, want_rc=0):
        """``cli.main(argv)``'s stdout; raises unless it exits
        ``want_rc``."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        if rc != want_rc:
            raise AssertionError(f"cli {' '.join(argv)} exited {rc} (want "
                                 f"{want_rc}):\n{buf.getvalue()}")
        return buf.getvalue()

    # (a) the read-back commands on phase 15 (e)'s run and the golden run
    golden = str(ROOT / "tests" / "fixtures" / "golden_run")
    total = [json.loads(line) for line in
             (Path(evolve_run_dir) / "metrics.jsonl").read_text()
             .splitlines()]
    (total,) = [r for r in total if r.get("kind") == "device_profile"
                and r.get("stage") == "__total__"]
    share = f"attributed {100 * total['attributed_fraction']:.1f}% of"
    with case("a"):
        for d in (str(evolve_run_dir), golden):
            text = run(["report", d])
            if d != golden and share not in text:
                raise AssertionError(f"(a) report lacks '{share}':\n{text}")
            exported = run(["export-metrics", d])
            if not exported.endswith("# EOF\n"):
                raise AssertionError("(a) export-metrics: no # EOF")
            run(["compare", d, d])
            run(["watch", d, "--once"])
            run(["layout", "--run-dir", d])
        spans = run(["spans", str(evolve_run_dir), "--critical-path",
                     "--min-fraction", "0.95"])
        out["critical_path"] = spans.strip().splitlines()[1:]
    log(f"[readback] (a) report, export-metrics, compare (exit 0), watch "
        f"--once, layout on the evolve run and the golden run; the report "
        f"shows '{share}'; spans --critical-path:\n{spans.rstrip()}")

    # (b) the layout explorer on logical shards of the card, then the CLI
    # on the real card count; the priors land in a temporary root only
    root = work / "history"
    root.mkdir()
    suite = get_suite("default8", synthetic_workload(16, 32, seed=0))
    with case("b"):
        summary = explore_layouts(
            suite, devices=[dev] * EXPLORE_SHARDS, population=64,
            engine="flat", recorder=NULL, history=RunHistory(str(root)),
            workload_key="pop64_default8")
    if summary["layouts_probed"] != 3 or summary["parity_max_abs"] != 0.0:
        raise AssertionError(f"(b) explorer: {summary}")
    if out["launches_by_case"]["b"]["param_score"] == 0:
        raise AssertionError("(b) the explorer never launched param_score")
    prior = RunHistory(str(root)).layout_prior("pop64_default8",
                                               str(EXPLORE_SHARDS))
    if prior is None or prior["layout_key"] != summary["best_layout_key"]:
        raise AssertionError(f"(b) layout prior {prior}")
    out["explore"] = {
        "probes": [{k: p[k] for k in ("mesh_shape", "layout_key",
                                      "first_call_seconds",
                                      "steady_seconds",
                                      "pad_waste_fraction",
                                      "parity_max_abs")}
                   for p in summary["probes"]],
        "layout_best_over_default": summary["layout_best_over_default"]}
    for p in summary["probes"]:
        log(f"[readback] (b) layout {p['mesh_shape']} {p['layout_key']}: "
            f"first call {p['first_call_seconds']} s (graph captures), "
            f"steady {p['steady_seconds']} s, pad waste "
            f"{p['pad_waste_fraction']}, parity {p['parity_max_abs']}")
    with case("b-cli"):
        shown = json.loads(run(["layout", "--explore", "--engine", "flat",
                                "--history-root", str(root)]))
    if shown["devices"] != torch.cuda.device_count() \
            or shown["parity_max_abs"] != 0.0:
        raise AssertionError(f"(b) layout --explore: {shown}")
    log(f"[readback] (b) {EXPLORE_SHARDS} logical shards: "
        f"{summary['layouts_probed']} layouts, parity 0, best "
        f"{summary['best_mesh_shape']} "
        f"({summary['layout_best_over_default']}x the default); "
        f"layout --explore on {shown['devices']} card(s): "
        f"{shown['layouts_probed']} layout(s), steady "
        f"{shown['best_steady_seconds']} s; priors only under the "
        f"temporary root")

    # (c) the step profiler at the default trace's shapes, steps cut
    lines = []
    with case("c"):
        rows, prof = profile_step.profile(
            TraceParser().parse_workload(), PROFILE_STEPS, PROFILE_LANES,
            dev, log=lines.append)
    if {n for _, n, _ in rows} != set(profile_step.VARIANTS):
        raise AssertionError(f"(c) variants {rows}")
    if out["launches_by_case"]["c"]["param_score"] == 0:
        raise AssertionError("(c) the profiler never launched param_score")
    prof_json = profile_step.payload(rows, PROFILE_LANES, PROFILE_STEPS,
                                     profile_step.device_name(dev), prof)
    out["profile_step"] = {f"{n}@l{ln}": u for ln, n, u in rows}
    log("[readback] (c) profile_step, " + f"{PROFILE_STEPS} steps per "
        "variant (captured 16-step chunks between CUDA events), us per "
        f"step; card {card}:\n" + "\n".join(
            lines + profile_step.summary_lines(rows, PROFILE_LANES)))
    widths = {k: v for k, v in prof_json.items() if k.startswith("lanes")}
    log(f"[readback] (c) --json: {json.dumps(widths)}")

    # (d) the tier benchmark on the first pods
    with case("d"):
        tiers = measure_tiers.measure(
            TraceParser().parse_workload(max_pods=TIERS_PODS),
            candidates=TIERS_CANDIDATES, generation=False, device=dev)
    # the tool isolates the exact tier's faults and skips failed VM
    # candidates; here either fails the phase
    if "exact_error" in tiers:
        raise AssertionError(f"(d) the exact tier failed: "
                             f"{tiers['exact_error']}")
    if set(tiers) != TIERS_KEYS:
        raise AssertionError(f"(d) keys {sorted(set(tiers) ^ TIERS_KEYS)} "
                             f"differ: {tiers}")
    numbers = {k: v for k, v in tiers.items()
               if k != "vm_skipped_candidates" and not isinstance(v, str)}
    if tiers["vm_skipped_candidates"] != 0 \
            or tiers["vm_tier_hits"] != TIERS_CANDIDATES \
            or tiers["vm_batch_pop"] != TIERS_CANDIDATES \
            or tiers["workload"] != f"16x{TIERS_PODS}" \
            or not all(math.isfinite(v) and v > 0 for v in numbers.values()):
        raise AssertionError(f"(d) measure_tiers: {tiers}")
    out["tiers"] = tiers
    log(f"[readback] (d) measure_tiers on the first {TIERS_PODS} pods, "
        f"{TIERS_CANDIDATES} candidates, no generation; no candidate "
        f"skipped, the exact tier held, every number finite and positive; "
        f"card {card}: {json.dumps(tiers)}")

    # (e) the port lints clean
    with case("e"):
        shown = run(["lint"])
    log(f"[readback] (e) {shown.strip().splitlines()[-1]}")
    tmp.cleanup()
    out["total_s"] = time.perf_counter() - t_phase
    log(f"[readback] seconds per case "
        f"{ {k: round(v, 2) for k, v in out['seconds'].items()} }; "
        f"launches by case {out['launches_by_case']}; phase "
        f"{out['total_s']:.1f} s; card {card}")
    return out

#: phase 17: the discovered-policy schema of tools/discover.py
DISCOVER_KEYS = {"score", "generation", "code", "timestamp", "search_score",
                 "engine", "weights"}
#: phase 17 (a): generations of the fused search at POP
DISCOVER_GENS = 20
#: phase 17 (b): the 0.5365 champion's exact-engine score (its file's)
CHAMPION_EXACT = 0.5364651
#: phase 17 (e): steps of the probes and their widths
PROBE_STEPS = 256
PROBE_LANES = (16, 256)


def entry_points_phase(dev, card) -> dict:
    """Phase 17 (module docstring): the last entry points, in process, on
    the card: champion discovery (fused, then exact), ``entry`` and
    ``dryrun_multichip``, two gates of the runner, the probes. Both
    kernels' launches are counted around each case."""
    import contextlib
    import io
    import tempfile

    import torch

    from fks_tpu_torch import entry
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.ops import _ext
    from fks_tpu_torch.sim import fused
    from fks_tpu_torch.tools import (
        discover, probe_floor, probe_ops, run_full_suite,
    )

    _ext.fused_sim_library()
    _ext.param_score_library()
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)
    out = {"seconds": {}, "launches_by_case": {}}

    def counts():
        return {"fused_sim": fused.fused_sim.launches,
                "param_score": parametric.score.launches}

    @contextlib.contextmanager
    def case(tag):
        """Seconds and kernel launches of one case (the counts set to 0
        just before it and read just after)."""
        torch.cuda.synchronize()
        fused.fused_sim.launches = parametric.score.launches = 0
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        out["seconds"][tag] = time.perf_counter() - t0
        out["launches_by_case"][tag] = counts()

    def run_discover(tag, argv):
        """``discover.main(argv)`` into ``work/tag``: (record, saved file,
        metric rows, stderr)."""
        d = work / tag
        d.mkdir()
        argv = argv + ["--out", str(d / "out"), "--checkpoint",
                       str(d / "ck"), "--metrics", str(d / "m.jsonl")]
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = discover.main(argv)
        if rc != 0:
            raise AssertionError(f"discover {argv} exited {rc}:\n"
                                 f"{se.getvalue()}")
        record = json.loads(so.getvalue().splitlines()[-1])
        (saved,) = (d / "out").iterdir()
        doc = json.loads(saved.read_text())
        if set(doc) != DISCOVER_KEYS or set(record) != DISCOVER_KEYS - {
                "code"} or not re.match(
                    r"^funsearch_\d{8}_\d{6}_score\d\.\d{4}\.json$",
                    saved.name) or not (d / "ck.npz").is_file():
            raise AssertionError(f"discover {tag}: {saved.name} {sorted(doc)}"
                                 f" is not fks_tpu's schema")
        rows = [json.loads(line)
                for line in (d / "m.jsonl").read_text().splitlines()]
        timing = re.search(r"\((\S+) s per generation\); exact re-scoring "
                           r"(\S+) s", se.getvalue())
        out[tag] = {"s_per_generation": float(timing.group(1)),
                    "rescore_s": float(timing.group(2)),
                    "score": record["score"],
                    "search_score": record["search_score"],
                    "generation": record["generation"]}
        return record, rows

    # (a) the fused search at pop 256 from the 0.5365 champion
    with case("a"):
        record, rows = run_discover("a", [
            "--engine", "fused", "--pop", str(POP), "--gens",
            str(DISCOVER_GENS), "--init-from", str(CHAMPION)])
    bests = [r["best"] for r in rows]
    if [r["generation"] for r in rows] != list(range(1, DISCOVER_GENS + 1)) \
            or any(b < a for a, b in zip(bests, bests[1:])) \
            or any(r["kind"] != "discover_gen" or r["engine"] != "fused"
                   for r in rows) \
            or record["generation"] != DISCOVER_GENS \
            or not 0.0 <= record["score"] <= 1.0:
        raise AssertionError(f"(a) discover rows {rows}, record {record}")
    if out["launches_by_case"]["a"]["fused_sim"] != DISCOVER_GENS:
        raise AssertionError(f"(a) fused_sim launched "
                             f"{out['launches_by_case']['a']} times, not "
                             f"once per generation")
    log(f"[entry] (a) discover --engine fused --pop {POP} --gens "
        f"{DISCOVER_GENS} --init-from the 0.5365 champion: best "
        f"{bests[0]:.6f} -> {bests[-1]:.6f} (never decreasing), "
        f"{out['a']['s_per_generation']:.4f} s per generation, exact "
        f"re-scoring {out['a']['rescore_s']:.3f} s (score "
        f"{record['score']:.6f}), launches {out['launches_by_case']['a']}; "
        f"fks_tpu's schema; card {card}")

    # (b) the exact engine: the champion's exact score carries over, the
    # search's batched score equals the champion file's re-scoring alone
    with case("b"):
        record, rows = run_discover("b", [
            "--engine", "exact", "--pop", "4", "--elite-k", "1", "--gens",
            "1", "--init-from", str(CHAMPION)])
    if record["search_score"] < CHAMPION_EXACT - 1e-6 \
            or abs(record["score"] - record["search_score"]) > 1e-9 \
            or out["launches_by_case"]["b"]["param_score"] == 0:
        raise AssertionError(f"(b) discover exact: {record}, launches "
                             f"{out['launches_by_case']['b']}")
    log(f"[entry] (b) discover --engine exact --pop 4 --gens 1: search "
        f"{record['search_score']:.9f} (>= {CHAMPION_EXACT} - 1e-6), exact "
        f"re-scoring alone {record['score']:.9f} (within 1e-9), "
        f"{out['b']['s_per_generation']:.3f} s per generation, re-scoring "
        f"{out['b']['rescore_s']:.3f} s, launches "
        f"{out['launches_by_case']['b']}")

    # (c) the driver entry points: one device, then 4 logical shards
    with case("c"):
        fn, args = entry.entry()
        got = float(fn(*args))
        cfn, cargs = entry.entry(device="cpu")
        want = float(cfn(*cargs))
        dry = entry.dryrun_multichip(4)
    if not abs(got - want) <= 1e-6:
        raise AssertionError(f"(c) entry {got} != CPU {want}")
    log(f"[entry] (c) entry() {got:.8f}, the CPU's {want:.8f} (within "
        f"1e-6); dryrun_multichip(4) "
        f"on {dry['devices']}: generation step, sharded eval, hybrid mesh "
        f"and sharded code eval == their single-device runs "
        f"({out['seconds']['c']:.2f} s, launches "
        f"{out['launches_by_case']['c']})")

    # (d) two gates of the runner, on the card (no --cpu)
    with case("d"):
        gates = {g: getattr(run_full_suite, g)(cpu=False)
                 for g in ("trends_gate", "trace_gate")}
    if not all(g["ok"] for g in gates.values()):
        raise AssertionError(f"(d) gates {gates}")
    log(f"[entry] (d) run_full_suite {gates} "
        f"({out['seconds']['d']:.1f} s)")

    # (e) the probes: the loop floor (parts A-B) and the primitives
    with case("e"):
        floor = probe_floor.part_a_b(
            PROBE_STEPS, dev, log=lambda s: log(f"[entry] (e) {s}"))
        ops = probe_ops.probe(PROBE_LANES, PROBE_STEPS, dev,
                              log=lambda s: log(f"[entry] (e) {s}"))
    numbers = [v for row in floor.values() for v in row.values()] + [
        us for _, _, us in ops]
    if not all(math.isfinite(v) and v > 0 for v in numbers):
        raise AssertionError(f"(e) probes {floor} {ops}")
    out["probe_floor"] = floor
    out["probe_ops"] = [[ln, n, us] for ln, n, us in ops]
    tmp.cleanup()
    out["total_s"] = time.perf_counter() - t_phase
    log(f"[entry] seconds per case "
        f"{ {k: round(v, 2) for k, v in out['seconds'].items()} }; "
        f"launches by case {out['launches_by_case']}; phase "
        f"{out['total_s']:.1f} s; card {card}")
    return out


def main() -> int:
    if not (ROOT / "fks_tpu_torch" / "csrc" / "fused_sim.cu").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout that holds "
                         "fks_tpu_torch/")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fks_tpu_torch.convert import load_champion_weights
    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.ops import _ext
    from fks_tpu_torch.parallel import make_population_eval
    from fks_tpu_torch.sim import fused
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.testing import (
        contended_workload, roomy_workload, tied_workload,
    )
    for name in ("golden_default.json", "golden_micro.json",
                 "golden_scenario_fault.json", "vm_prefix512_pins.json",
                 "evolve_prefix256_pins.json", "serve_pins.json"):
        if not (ROOT / "tests" / "fixtures" / name).is_file():
            raise SystemExit(f"chip_smoke.py needs tests/fixtures/{name}")

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. the card
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[card] nvidia-smi: {card}")
    log(f"[card] torch: {kind}, {props.multi_processor_count} SMs, "
        f"max SM clock {max_clock_mhz} MHz, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- 2. build: one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_ext.build, KERNELS)))
    _ext.fused_sim_library()
    _ext.param_score_library()
    for name, so in built.items():
        log(f"[build] {so.relative_to(ROOT)}")
    log(f"[build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} "
        f"s (parallel nvcc)")
    for line in _ext.ptxas_report("fused_sim").splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                raise AssertionError(f"the kernel spills registers: {line}")

    # ---- 3. kernel vs plain version on the card
    def check(name, wl, cfg, params):
        plan = fused.make_fused_population_run(wl, cfg, device=dev).plan
        got = fused.fused_sim(plan, params)
        torch.cuda.synchronize()
        want = fused.fused_sim_plain(plan, params)
        err = compare_raw(name, got, want)
        steps = int(got[5][:, 1].sum())
        log(f"[check] {name}: pop {params.shape[0]}, {steps} lane-steps, "
            f"ints exact, max abs err {err:.3g} (tol {TOL}) ok")
        return err

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    max_err = 0.0
    max_err = max(max_err, check(
        "roomy", roomy_workload(), SimConfig(track_ctime=False),
        parametric.init_population(gen, 8, noise=0.2)))
    max_err = max(max_err, check(
        "contended", contended_workload(),
        SimConfig(track_ctime=False, max_steps=4 * 96),
        parametric.init_population(gen, 8, noise=0.5)))
    max_err = max(max_err, check(
        "tied", tied_workload(), SimConfig(track_ctime=False),
        parametric.init_population(gen, 8, noise=0.5)))
    parser = TraceParser()
    for pod_file in ("openb_pod_list_multigpu50.csv",
                     "openb_pod_list_cpu250.csv"):
        t0 = time.perf_counter()
        max_err = max(max_err, check(
            pod_file, parser.parse_workload(pod_file=pod_file).to(dev),
            SimConfig(track_ctime=False, max_steps=2000),
            parametric.init_population(gen, 8)))
        log(f"[check] {pod_file} pop 8 took {time.perf_counter() - t0:.1f} s")
    wl = parser.parse_workload().to(dev)
    cfg = SimConfig(track_ctime=False)

    # ---- 4. the main path at pop 256
    gen.manual_seed(1)
    params = parametric.init_population(gen, POP)
    params[4] = load_champion_weights(CHAMPION, device=dev)
    evaluate = make_population_eval(wl, cfg=cfg, engine="fused", device=dev)
    res = evaluate(params)  # warm-up
    torch.cuda.synchronize()
    fused.fused_sim.launches = 0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        res = evaluate(params)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = fused.fused_sim.launches
    if launches == 0:
        raise AssertionError("the main path never launched the fused kernel")
    scores = res.policy_score
    if scores.shape != (POP,) or not bool(torch.isfinite(scores).all()) \
            or not bool(((scores >= 0) & (scores <= 1)).all()):
        raise AssertionError(f"bad policy scores: {scores}")
    events = int(res.events_processed.sum())
    log(f"[main] pop {POP} default trace (16 nodes x 8152 pods): "
        f"{wall:.4f} s/eval, {POP / wall:.1f} evals/s, {events} events, "
        f"best {float(scores.max()):.6f}, mean {float(scores.mean()):.6f}, "
        f"champion lane {float(scores[4]):.6f}, "
        f"launches {launches} ({reps} evals), card {card}")

    plan = evaluate.plan
    kernel_ms = cuda_ms(lambda: fused.fused_sim(plan, params), 3)
    fused.fused_sim.launches = 0  # timing launches are not main-path ones
    got = fused.fused_sim(plan, params)
    fused.fused_sim.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fused.fused_sim_plain(plan, params)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_err = max(max_err, compare_raw("main-path pop 256", got, want))
    steps = got[5][:, 1]
    lane_steps = int(steps.sum())
    max_lane_steps = int(steps.max())
    mean_lane_steps = float(steps.double().mean())
    ns_per_critical_step = kernel_ms * 1e6 / max_lane_steps
    log(f"[main] kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{lane_steps} lane-steps (per lane max {max_lane_steps}, mean "
        f"{mean_lane_steps:.1f}), {ns_per_critical_step:.1f} ns per step "
        f"of the longest lane, kernel == plain ok")

    # bound: the shared-memory words the kernel moves on every event — its
    # 32 threads read 3 x run chunk minima (run = chunks per thread) and
    # write the slot's ev and aux and the chunk's two minima — and on every
    # CREATE the five words per node of the fit test; GPU rows of GPU pods,
    # the float scores of feasible nodes, histogram and bookkeeping words
    # are left out, so this is a floor. CREATEs are placements (aux >= 0)
    # plus failed placements (frag_count) plus aborted allocations.
    # Device-memory bytes are read/written once.
    run = -(-(plan.q // 32) // 32)
    creates = int((got[0] >= 0).sum() + got[5][:, 4].sum()
                  + got[5][:, 6].sum())
    smem_words = lane_steps * (3 * run + 4) + creates * 5 * plan.n
    sm_bytes_per_s = (props.multi_processor_count
                      * SMEM_BYTES_PER_CLOCK_PER_SM * max_clock_mhz * 1e6)
    smem_bound_ms = smem_words * 4 / sm_bytes_per_s * 1e3
    io_bytes = (params.numel() * 4 + plan.ev0.numel() * 4
                + plan.feat.numel() * 4 + sum(o.numel() * 4 for o in got))
    hbm_bound_ms = io_bytes / HBM_BYTES_PER_S * 1e3

    # ---- 4b. the parametric score kernel against its plain version
    ps = param_score_phase(dev, card)

    # (phase 5, ParametricEvolution on the fused engine, is phase 17 (a))

    # the parametric score kernel's launches, counted from 0 around each
    # path that runs the parametric policy on the exact or flat engine
    ps_launches = {}

    def counted(phase, fn, *args):
        parametric.score.launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        ps_launches[phase] = parametric.score.launches
        parametric.score.launches = 0
        return out

    # ---- 6. the exact heap engine
    counted("6", exact_phase, dev, wl, params, card)
    if ps_launches["6"] == 0:
        raise AssertionError("the exact engine's parametric population "
                             "never launched the param_score kernel")

    # ---- 7. the policies on the card
    zoo_phase(dev)

    # ---- 8. scenario suites
    counted("8", scenario_phase, dev, wl, params, card)

    # ---- 9. code candidates
    summary = {"code": code_phase(dev, card)}

    # ---- 10. 1,000 nodes
    summary["scale"], probe_inputs = counted("10", scale_phase, dev, card)

    # ---- 11. the evolve loop
    summary["evolve"] = counted("11", evolve_phase, dev, card, probe_inputs)
    for phase in ("8", "10", "11"):
        if ps_launches[phase] == 0:
            raise AssertionError(f"phase {phase} never launched param_score")
    log(f"[param_score] launches by phase: {ps_launches}")

    # ---- 12. serving
    fused.fused_sim.launches = parametric.score.launches = 0
    summary["serve"] = serve_phase(dev, card)
    serve_launches = {"fused_sim": fused.fused_sim.launches,
                      "param_score": parametric.score.launches}
    log(f"[serve] kernel launches in phase 12: {serve_launches} (the "
        f"champion is a VM program: the serve path runs no hand kernel)")

    # ---- 13. the mesh and the portfolio
    fused.fused_sim.launches = parametric.score.launches = 0
    summary["mesh"] = mesh_phase(dev, card, wl, params, res)
    mesh_launches = {"fused_sim": fused.fused_sim.launches,
                     "param_score": parametric.score.launches}
    if not all(mesh_launches.values()):
        raise AssertionError(f"phase 13 left a kernel unlaunched: "
                             f"{mesh_launches}")
    ps_launches["13"] = mesh_launches["param_score"]
    log(f"[mesh] kernel launches in phase 13: {mesh_launches}")

    # ---- 14. the control plane
    fused.fused_sim.launches = parametric.score.launches = 0
    summary["control"] = control_plane_phase(dev, card)
    control_launches = {"fused_sim": fused.fused_sim.launches,
                        "param_score": parametric.score.launches}
    ps_launches["14"] = control_launches["param_score"]
    log(f"[control] kernel launches in phase 14: {control_launches} (the "
        f"control plane serves code champions: VM programs and the "
        f"transpiled tier, no hand kernel)")

    # ---- 15. the command line
    import tempfile
    kept = tempfile.TemporaryDirectory()
    evolve_run_dir = Path(kept.name) / "evolve_run"
    fused.fused_sim.launches = parametric.score.launches = 0
    summary["cli"] = cli_phase(dev, card, evolve_run_dir)
    cli_launches = summary["cli"]["launches"]
    if not all(cli_launches.values()):
        raise AssertionError(f"phase 15 left a kernel unlaunched: "
                             f"{cli_launches}")
    ps_launches["15"] = cli_launches["param_score"]
    log(f"[cli] kernel launches in phase 15 (the commands' own, by "
        f"command {summary['cli']['launches_by_command']}): "
        f"{cli_launches}")

    # ---- 16. reading back and tooling
    fused.fused_sim.launches = parametric.score.launches = 0
    summary["readback"] = readback_phase(dev, card, evolve_run_dir)
    kept.cleanup()
    rb_launches = summary["readback"]["launches"]
    if rb_launches["param_score"] == 0:
        raise AssertionError(f"phase 16 never launched param_score: "
                             f"{rb_launches}")
    ps_launches["16"] = rb_launches["param_score"]
    log(f"[readback] kernel launches in phase 16: {rb_launches}")

    # ---- 17. the last entry points
    summary["entry"] = entry_points_phase(dev, card)
    entry_launches = {k: sum(c[k] for c in
                             summary["entry"]["launches_by_case"].values())
                      for k in KERNELS}
    if not all(entry_launches.values()):
        raise AssertionError(f"phase 17 left a kernel unlaunched: "
                             f"{entry_launches}")
    ps_launches["17"] = entry_launches["param_score"]
    log(f"[entry] kernel launches in phase 17: {entry_launches}")

    # ---- summary
    log(f"[summary] {json.dumps(summary)}")
    log(f"[card] {card}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_sim", "route": "cuda",
        "source": "fks_tpu_torch/csrc/fused_sim.cu",
        "replaces": "fks_tpu/sim/fused.py:471",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(smem_bound_ms, hbm_bound_ms),
        "bound_by": "bytes", "library_ms": None,
        "bound_note": "floor of shared-memory bytes: per lane-step "
                      "(3 x run + 4) words (chunk minima read, slot and "
                      "chunk minima written), per CREATE 5 x N node words, "
                      "over SMs x 128 B/clock x max SM clock; the kernel is "
                      "latency-bound on its longest lane "
                      "(ns_per_critical_step)",
        "smem_bound_ms": smem_bound_ms, "hbm_bound_ms": hbm_bound_ms,
        "smem_bytes_per_lane_step": 4 * (3 * run + 4),
        "creates": creates, "lane_steps": lane_steps,
        "max_lane_steps": max_lane_steps,
        "mean_lane_steps": mean_lane_steps,
        "ns_per_critical_step": ns_per_critical_step,
        "pop": POP, "check": "ok",
        "launches_by_phase": {"4": launches,
                              "13": mesh_launches["fused_sim"],
                              "14": control_launches["fused_sim"],
                              "15": cli_launches["fused_sim"],
                              "16": rb_launches["fused_sim"],
                              "17": entry_launches["fused_sim"]},
        "mesh_launches_per_eval": {
            "1_shard": summary["mesh"]["launches_per_eval_1"],
            "4_logical_shards": summary["mesh"]["launches_per_eval_4"]},
        "card": card,
    }, {
        "name": "param_score", "route": "cuda",
        "source": "fks_tpu_torch/csrc/param_score.cu",
        "replaces": "fks_tpu/models/parametric.py:103",
        "launches": ps_launches["6"], "max_abs_err": ps["max_abs_err"],
        "ms": ps["times"]["L256_N16"]["ms"],
        "marginal_ms": ps["times"]["L256_N16"]["marginal_ms"],
        "floor_ms": ps["times"]["L256_N16"]["floor_ms"],
        "floor_marginal_ms": ps["times"]["L256_N16"]["floor_marginal_ms"],
        "plain_ms": ps["times"]["L256_N16"]["plain_ms"],
        "bound_ms": ps["times"]["L256_N16"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "bound_note": "the views read once and the scores written once "
                      "over the HBM rate, at the main path's shape (phase "
                      "6: 256 lanes x 16 nodes x 8 GPUs, shared totals); "
                      "about 60 float32 operations per score are far "
                      "below the float32 rate; an empty kernel of the same "
                      "grid (floor_ms) is the launch floor. fks_tpu runs "
                      "parametric.score as plain XLA: no TPU kernel, no "
                      "library call",
        "launches_by_phase": ps_launches, "times": ps["times"],
        "probe": ps["probe"], "scores_checked": ps["checked"],
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
