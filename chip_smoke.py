#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fks_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build ``fks_tpu_torch/csrc/fused_sim.cu`` for sm_90a and print the
   ``-Xptxas -v`` report (registers, shared memory, spills); spills fail;
3. hold the kernel against its plain PyTorch version on the card, on the
   same inputs: integer outputs exact, float outputs within 2e-6
   (rtol and atol), on the roomy and contended workloads of fks_tpu's
   tests/test_fused.py, the tied workload (equal times across queue
   chunks, retries onto held times), the multigpu50 and cpu250 OpenB
   traces at pop 8 cut to 2,000 steps (multi-GPU picks, retry storms,
   chunk counts that are not a multiple of 32) and the full default OpenB
   trace at pop 8;
4. the main path: ``make_population_eval(engine="fused")`` on the full
   default trace (16 nodes x 8,152 pods) at pop 256 — the seeds plus
   jitter, with the 0.5365 champion's weights in one lane — timed, its
   launch count read, the lane-step distribution (``acci[:, 1]``) and the
   kernel time per step of the longest lane reported, and the kernel's raw
   outputs held against the plain version at the same inputs;
5. ``ParametricEvolution`` for 3 generations at pop 256 on the fused
   engine: the best score must not decrease;
6. the exact heap engine (plain PyTorch ops, no hand kernel; ``SYNC_EVERY``
   steps per captured CUDA graph): ``golden_micro`` through
   ``micro_best_fit``; the full default trace through ``best_fit`` and
   ``funsearch_4901`` in float64, held to ``golden_default.json``
   (integers exact, floats within 1e-9), the best_fit run driven step by
   step under ``torch.cuda.set_sync_debug_mode("error")`` for its eager
   steps and graph replays; ``make_population_eval(engine="exact")`` at
   pop 256 on phase 4's population, then lanes 0 and 4 alone, which must
   equal their batched results exactly;
7. the policies on the card: every zoo policy (``ZOO``,
   ``BASELINE_FACTORIES``, ``micro_best_fit``) and ``parametric.score``,
   in float32 and float64, on 4 x 256 random views; the integer scores
   must equal the same views scored on the CPU;
8. scenario suites (plain PyTorch ops replayed as CUDA graphs, no hand
   kernel): ``golden_scenario_fault.json`` through the exact and flat
   engines with first_fit and best_fit, held to its pins (score within
   1e-5; counts, the per-CREATE assignments from the decision trace and
   the fault rows exact); ``default8`` on the full default trace through
   the exact engine for the first 32 of phase 4's population (256 lanes),
   timed, with the champion's eight scores and its mean, min and
   CVaR-0.25 robust scores; the champion alone on the suite and on
   ``fault2`` alone, equal to its batched results exactly; ``default8``
   through the flat engine for the champion, timed; the champion's
   decision trace on ``fault1`` (its score equals the untraced run, its
   fault rows the scenario's fault count) and ``trace_diff`` of the exact
   engine against itself (no divergence);
9. code candidates at the default cluster's width (16 nodes, G = 8; plain
   PyTorch, no hand kernel): the two template seeds and the 13
   discovered champions, transpiled and lowered to the funsearch VM, in
   float64 and float32 on 4 x 256 random views — the VM's integer scores
   on the card equal the transpiled policy's on the card and on the CPU;
   the 15 programs stacked (capacity 512, 16 lanes) through the exact and
   the flat engine in float64 on the first 512 pods of the default trace,
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
12. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the fks_tpu package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHAMPION = (ROOT / "policies" / "discovered"
            / "funsearch_20260801_045536_score0.5365.json")
TOL = 2e-6
POP = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
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


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
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
        assert_golden_micro, assert_golden_parity, assert_result_matches,
        golden_micro_workload, result_fields,
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
    want = result_fields(batched)
    for lane in (0, 4):
        alone = make_population_eval(wl, cfg=cfg, engine="exact",
                                     device=dev)(params[lane:lane + 1])
        assert_result_matches(alone, {k: v[lane:lane + 1]
                                      for k, v in want.items()},
                              rtol=0, atol=0)
    log(f"[exact] lanes 0 and 4 alone equal their batched results exactly; "
        f"phase {time.perf_counter() - t_phase:.1f} s")


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
    t0 = time.perf_counter()
    alone = make_suite_eval(suite, cfg=cfg, device=dev)(params[4])
    torch.cuda.synchronize()
    wall_alone = time.perf_counter() - t0
    assert_result_matches(alone, want, rtol=0, atol=0)
    i2 = suite.names.index("fault2")
    w2 = suite.workloads[i2]
    one = engine.make_population_run_fn(w2, parametric.score, cfg)(
        params[4:5], engine.initial_state(w2, cfg))
    assert_result_matches(one, {k: v[i2:i2 + 1] for k, v in want.items()},
                          rtol=0, atol=0)
    log(f"[scenarios] the champion alone on default8 ({len(suite)} lanes, "
        f"{wall_alone:.3f} s) and on fault2 alone (1 lane) equal its batched "
        f"results exactly")

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
    if score != float(alone.policy_score[i1]) \
            or fault_rows != w1.faults.num_events \
            or sum(r["kind"] == "NODE_DOWN" for r in rows) * 2 != fault_rows:
        raise AssertionError(
            f"traced fault1 run: score {score} (untraced "
            f"{float(alone.policy_score[i1])}), {fault_rows} fault rows of "
            f"{w1.faults.num_events}")
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

    # (b, c) the 15 programs stacked (capacity 512, 16 lanes) through the
    # exact and the flat engine on the first 512 pods, float64
    wl = TraceParser().parse_workload(max_pods=pins["pods"]).to(dev)
    progs = [vm.compile_policy(c, 16, 8, capacity=512) for c in codes]
    progs += [progs[-1]] * (vm.bucket_lanes(len(progs)) - len(progs))
    stacked = vm.stack_programs(progs, capacity=512)
    lanes = len(progs)
    cfg = SimConfig(score_dtype=torch.float64)
    out = {}
    for eng in ("exact", "flat"):
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


def held_to_pins(name, fs, pin):
    """A FunSearch run against its fks_tpu pins: per generation the stats
    without their time fields, the final population and best as
    (canonical-key sha1, score); integers exact, floats within 1e-9."""
    import dataclasses
    import hashlib

    from fks_tpu_torch.funsearch import transpiler

    def sha(code):
        return hashlib.sha1(transpiler.canonical_key(code).encode()).hexdigest()

    def close(got, want, where):
        if isinstance(want, float) and isinstance(got, float):
            if abs(got - want) > 1e-9:
                raise AssertionError(f"{name} {where}: {got!r} vs fks_tpu "
                                     f"pin {want!r}")
        elif isinstance(want, dict):
            if sorted(got) != sorted(want):
                raise AssertionError(f"{name} {where}: keys differ")
            for k in want:
                close(got[k], want[k], f"{where}.{k}")
        elif isinstance(want, list):
            if len(got) != len(want):
                raise AssertionError(f"{name} {where}: {got} vs pin {want}")
            for i, (a, b) in enumerate(zip(got, want)):
                close(a, b, f"{where}[{i}]")
        elif got != want:
            raise AssertionError(f"{name} {where}: {got!r} vs fks_tpu pin "
                                 f"{want!r}")

    gens = [{k: v for k, v in dataclasses.asdict(h).items()
             if k not in EVOLVE_TIME_FIELDS} for h in fs.history]
    close(gens, pin["generations"], "generations")
    close([[sha(c), sc] for c, sc in fs.population], pin["population"],
          "population")
    close([sha(fs.best[0]), fs.best[1]], pin["best"], "best")


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
    caps, _, replays, ms = graph_report(ev._vm_pop_run.graphs)
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
        bev._vm_pop_run.graphs, bev._budget_eval._probe_run.graphs)
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
    from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
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
                 "evolve_prefix256_pins.json"):
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

    # ---- 2. build
    t0 = time.perf_counter()
    so = _ext.build("fused_sim")
    _ext.fused_sim_library()
    log(f"[build] {so.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
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
    t0 = time.perf_counter()
    max_err = max(max_err, check(
        "default-trace", wl, cfg, parametric.init_population(gen, 8)))
    log(f"[check] default-trace pop 8 took {time.perf_counter() - t0:.1f} s")

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

    # ---- 5. evolution
    fused.fused_sim.launches = 0
    t0 = time.perf_counter()
    pe = ParametricEvolution(wl, pop_size=POP, cfg=cfg, engine="fused",
                             device=dev, seed=0)
    pe.run(3)
    torch.cuda.synchronize()
    bests = [h.best_score for h in pe.history]
    if any(b < a for a, b in zip(bests, bests[1:])) or len(bests) != 3:
        raise AssertionError(f"evolution best score decreased: {bests}")
    log(f"[evolve] 3 generations pop {POP}: best {bests}, mean "
        f"{[round(h.mean_score, 6) for h in pe.history]}, "
        f"{time.perf_counter() - t0:.2f} s, launches "
        f"{fused.fused_sim.launches}")

    # ---- 6. the exact heap engine
    exact_phase(dev, wl, params, card)

    # ---- 7. the policies on the card
    zoo_phase(dev)

    # ---- 8. scenario suites
    scenario_phase(dev, wl, params, card)

    # ---- 9. code candidates
    summary = {"code": code_phase(dev, card)}

    # ---- 10. 1,000 nodes
    summary["scale"], probe_inputs = scale_phase(dev, card)

    # ---- 11. the evolve loop
    summary["evolve"] = evolve_phase(dev, card, probe_inputs)

    # ---- 12. summary
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
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
