"""The port's command line: ``python -m fks_tpu_torch.cli <command> ...``.

Port of fks_tpu.cli, all 20 of its subcommands (fks_tpu/cli.py; the
parsers at :1668-2257), with fks_tpu's flags, defaults, printed JSON and
tables, ``--metrics`` rows and exit codes:

    bench [--policies a,b,...] [--trace F] [--nodes F] [--f64]
    simulate --policy best_fit [--f64] [--validate]
    evolve [--config F] [--fake-llm] [--checkpoint F] [--wal F] [--profile]
    scale [--nodes-count N] [--pods-count P] [--pop C] [--code-pop K]
    serve [--champion F] [--queries F | --http PORT | --selftest N]
    loadgen [--tenants SPEC] [--duration S] [--http [PORT]]
    portfolio [--champion F ...] [--selftest N | --http PORT]
    pipeline [--drill]
    trace-diff --engines exact,flat [--policy P | --code F] [--scenario I]
    scenarios [--suite NAME [--scenario I]]
    mem [--run-dir DIR | --sample | --drill NAME]
    report DIR | export-metrics DIR [--out F] | watch DIR [--once]
    spans DIR [--trace ID | --slowest N | --check-complete |
               --critical-path]
    compare BASELINE|auto CANDIDATE [--threshold SPEC] [--history-root R]
    trends ROOT [--fail-on-alert] [--write-index]
    layout [--run-dir DIR | --explore [--devices N] [--history-root R]]
    lint [PATHS ...]
    traces

``bench`` prints the policy table, ``simulate`` one policy's JSON,
``evolve`` runs FunSearch (``--profile`` attributes its wall time per
stage, ``obs.profiler``), ``scale`` times a synthetic population run,
``loadgen`` drives a multi-tenant arrival mix against a warm serve
service, ``trace-diff`` replays one policy through two engines and
reports the first divergent step (exit 0 none, 1 divergence, 2 error),
``scenarios`` lists or describes scenario suites, ``mem`` renders a run's
memory view, takes one watermark sample or runs a memory drill, and
``traces`` lists the trace files. ``report``, ``export-metrics``,
``watch``, ``spans`` and ``layout`` read a run directory back (either
package's: the text is fks_tpu's), ``compare`` and ``trends`` judge runs
against each other and their history (exit 1 on a regression or, with
``--fail-on-alert``, an alert; 2 on bad input), ``layout --explore``
measures every valid layout of a suite over the devices, and ``lint``
checks the port's captured step bodies (``analysis.lint``; the port has
no jaxpr pins, so ``--pins`` and ``--write-pins`` exit 2). As in
fks_tpu, two of them write into a history root: ``layout --explore``
its ``layouts.json`` prior into ``--history-root`` when that directory
exists (default ``$FKS_BENCH_RESULTS_DIR``, else ``benchmarks/results``,
which ``compare --baseline auto`` also reads), and ``trends
--write-index`` its ``history.jsonl`` into ROOT. ``serve``,
``portfolio`` and
``pipeline`` serve champions, a routed portfolio of them and the
promotion pipeline. Every command but ``trace-diff`` and ``traces``
takes fks_tpu's common flags: ``--cpu``, ``--metrics F`` (JSONL metric
rows), ``--run-dir DIR`` (flight-record the run in fks_tpu's layout) and
``--engine``.

Every command runs on the card (``--device cuda``, the default) and
raises without one; ``--cpu`` (or ``--device cpu``) runs the plain
PyTorch path on the CPU. ``--devices N`` shards the lane axis over a
mesh: on the card the first N CUDA devices (it raises when there are
fewer), on the CPU N logical shards of the one CPU device. fks_tpu's
``--devices`` instead sizes a virtual CPU device mesh and requires
``--cpu``. ``scale`` draws its population from ``--seed`` with a
``torch.Generator``, so its weights, and with them its scores, differ
from fks_tpu's ``jax.random`` draw.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys


def _parse_workload(args):
    from fks_tpu_torch.data import TraceParser

    return TraceParser().parse_workload(
        node_file=args.nodes, pod_file=args.trace,
        max_pods=getattr(args, "first_pods", None))


def _device(args) -> str:
    return "cpu" if args.cpu else getattr(args, "device", "cuda")


def _mesh(args):
    """``--devices N``: a population mesh of the first N CUDA devices
    (raises with fewer), or of N logical shards on the CPU; None for 0."""
    if not args.devices:
        return None
    from fks_tpu_torch.parallel.mesh import cuda_devices, population_mesh

    if _device(args) == "cpu":
        return population_mesh(["cpu"] * args.devices)
    return population_mesh(cuda_devices(args.devices))


def _metrics_writer(args):
    """Context manager: a MetricsWriter when ``--metrics`` was given
    (opened up front so bad paths fail fast, closed on every exit path),
    else a null context yielding None."""
    if getattr(args, "metrics", ""):
        from fks_tpu_torch.utils.logging import MetricsWriter

        return MetricsWriter(args.metrics)
    return contextlib.nullcontext(None)


def _flight_recorder(args, command):
    """Context manager installing the process-wide flight recorder when
    ``--run-dir`` was given (``obs.recording``), else the shared
    NullRecorder. Opened up front, so an unwritable run directory fails
    before any device work."""
    from fks_tpu_torch import obs

    if not getattr(args, "run_dir", ""):
        return obs.recording(obs.NULL)
    return obs.recording(obs.FlightRecorder(
        args.run_dir, meta={"command": command, "argv": sys.argv[1:]}))


def _result_row(name, res, wall):
    return {
        "policy": name,
        "score": round(float(res.policy_score), 4),
        "scheduled": f"{int(res.scheduled_pods)}",
        "cpu%": round(100 * float(res.avg_cpu_utilization), 1),
        "mem%": round(100 * float(res.avg_memory_utilization), 1),
        "gpu%": round(100 * float(res.avg_gpu_count_utilization), 1),
        "milli%": round(100 * float(res.avg_gpu_memory_utilization), 1),
        "frag": round(float(res.gpu_fragmentation_score), 3),
        "snaps": int(res.num_snapshots),
        "events": int(res.events_processed),
        "max_nodes": int(res.max_nodes),
        "wall_s": round(wall, 3),
    }


def _print_table(rows):
    if not rows:
        return
    cols = list(rows[0].keys())
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in cols}
    line = "  ".join(c.rjust(widths[c]) for c in cols)
    print(line)
    print("-" * len(line))
    for r in rows:
        print("  ".join(str(r[c]).rjust(widths[c]) for c in cols))


def _pick_simulate(args):
    from fks_tpu_torch.sim import get_engine
    return get_engine(args.engine).simulate


def cmd_bench(args) -> int:
    """The reference benchmark table: every requested policy against the
    workload, with wall time (fks_tpu/cli.py:194)."""
    import torch

    from fks_tpu_torch import obs
    from fks_tpu_torch.models import zoo
    from fks_tpu_torch.obs.telemetry import record_devices
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.utils.logging import result_record

    simulate = _pick_simulate(args)
    wl = _parse_workload(args)
    names = (args.policies.split(",") if args.policies else list(zoo.ZOO))
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = SimConfig(score_dtype=dtype, validate_invariants=args.validate)
    print(f"workload: {wl.num_nodes} nodes x {wl.num_pods} pods "
          f"({args.nodes} x {args.trace})", file=sys.stderr)
    rows = []
    with _flight_recorder(args, "bench") as rec, \
            obs.watch_compiles(rec), _metrics_writer(args) as metrics:
        if rec.enabled:
            rec.annotate_meta(engine=args.engine, trace=args.trace,
                              workload={"nodes": wl.num_nodes,
                                        "pods": wl.num_pods})
            record_devices(rec)
        for name in names:
            if name not in zoo.ZOO:
                print(f"unknown policy {name!r}; have {list(zoo.ZOO)}",
                      file=sys.stderr)
                return 2
            with obs.span("policy", policy=name) as t:
                res = t.sync(simulate(wl, zoo.ZOO[name](dtype=dtype), cfg,
                                      device=_device(args)))
            wall = t.seconds
            rows.append(_result_row(name, res, wall))
            if metrics:
                metrics.write("bench", result_record(res), policy=name,
                              wall_s=wall, trace=args.trace, nodes=args.nodes)
            rec.metric("bench", result_record(res), policy=name,
                       wall_s=wall, trace=args.trace, nodes=args.nodes)
            if args.validate and int(res.invariant_violations):
                print(f"WARNING: {name}: {int(res.invariant_violations)} "
                      "invariant violations", file=sys.stderr)
    _print_table(rows)
    return 0


def cmd_simulate(args) -> int:
    """One policy, detailed JSON (fks_tpu/cli.py:243)."""
    import torch

    from fks_tpu_torch import obs
    from fks_tpu_torch.models import zoo
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.utils.logging import result_record

    simulate = _pick_simulate(args)
    wl = _parse_workload(args)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = SimConfig(score_dtype=dtype, validate_invariants=args.validate)
    with _flight_recorder(args, "simulate") as rec, \
            obs.watch_compiles(rec), \
            _metrics_writer(args) as metrics:  # up front: bad paths fail fast
        with obs.span("simulate", policy=args.policy) as t:
            res = t.sync(simulate(wl, zoo.ZOO[args.policy](dtype=dtype), cfg,
                                  device=_device(args)))
        wall = t.seconds
        n_pods = wl.num_pods
        gpu_pods = int((wl.pods.num_gpu[:n_pods] > 0).sum())
        out = _result_row(args.policy, res, wall)
        out.update({
            "gpu_pods": gpu_pods, "cpu_only_pods": n_pods - gpu_pods,
            "success_rate": round(
                100 * int(res.scheduled_pods) / max(1, n_pods), 2),
            "failed": bool(res.failed), "truncated": bool(res.truncated),
            "invariant_violations": int(res.invariant_violations),
        })
        if metrics:
            metrics.write("simulate", result_record(res), policy=args.policy,
                          wall_s=wall, trace=args.trace, nodes=args.nodes)
        rec.metric("simulate", result_record(res), policy=args.policy,
                   wall_s=wall, trace=args.trace, nodes=args.nodes)
    print(json.dumps(out, indent=2))
    return 0


def _divergence_bound(trace: str, path: str = ""):
    """Latest measured flat-vs-exact divergence for ``trace`` from the
    divergence audit (``obs.watchdog.audit_main``'s JSONL):
    ``(drift, cascades)`` where drift is the arithmetic max|d| with
    retry-cascade rows excluded (falling back to max|d| for rows written
    before cascades were counted) and cascades counts panel policies
    whose flat run blew the event budget. None when no audit row
    exists (fks_tpu/cli.py:285)."""
    path = path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks", "results", "divergence_audit.jsonl")
    found = None
    try:
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if row.get("trace") == trace and \
                        row.get("max_abs_d") is not None:
                    found = row  # latest row wins
    except OSError:
        return None
    if found is None:
        return None
    drift = found.get("max_drift")
    if drift is None:
        drift = found["max_abs_d"]
    return float(drift), int(found.get("flat_cascades", 0))


def cmd_evolve(args) -> int:
    """The FunSearch evolution loop, with a hermetic ``--fake-llm`` mode,
    checkpoint/resume and the generation WAL (fks_tpu/cli.py:318)."""
    from fks_tpu_torch.funsearch import EvolutionConfig, FakeLLM
    from fks_tpu_torch.funsearch import evolution as evo
    from fks_tpu_torch.sim.engine import SimConfig

    cfg = (EvolutionConfig.from_json(args.config) if args.config
           else EvolutionConfig())
    for flag, field in (("generations", "generations"),
                        ("parametric_rounds", "parametric_rounds"),
                        ("parity_sample", "parity_sample"),
                        ("parity_tol", "parity_tol"),
                        ("suite", "scenario_suite"),
                        ("robust_agg", "robust_aggregation"),
                        ("budget", "budget_schedule"),
                        ("budget_eta", "budget_eta"),
                        ("probe_suite", "probe_suite"),
                        ("probe_steps", "probe_steps")):
        if getattr(args, flag) is not None:
            setattr(cfg, field, getattr(args, flag))
    if args.wal and not args.checkpoint:
        print("note: --wal without --checkpoint only protects the first "
              "generation; pass --checkpoint so every generation boundary "
              "is durable", file=sys.stderr)
    backend = FakeLLM(seed=cfg.seed) if args.fake_llm else None
    if backend is None and not cfg.llm.api_key:
        print("no API key in config; use --fake-llm for hermetic runs",
              file=sys.stderr)
        return 2
    if args.engine != "exact":
        # search on a fast engine ranks by a fitness that can differ from
        # the exact replica's; surface the bound measured on this trace
        bound = _divergence_bound(args.trace)
        if bound is not None:
            drift, cascades = bound
            casc = (f"; {cascades} panel polic"
                    f"{'y' if cascades == 1 else 'ies'} hit a retry "
                    "cascade (flat score 0 — culled, never over-promoted)"
                    if cascades else "")
            print(f"note: measured flat-vs-exact drift on {args.trace}: "
                  f"max|d|={drift:.4f}{casc} (panel of seed + champion "
                  "policies; tools/divergence_audit.py). NEW BEST "
                  "admissions are exact-rescored; treat fast-engine "
                  "rankings within the drift bound as ties.",
                  file=sys.stderr)
        else:
            print(f"note: no divergence audit row for {args.trace}; run "
                  "tools/divergence_audit.py --traces "
                  f"{args.trace} for a measured flat-vs-exact bound",
                  file=sys.stderr)
    from fks_tpu_torch import obs
    from fks_tpu_torch.obs.telemetry import record_devices

    wl = _parse_workload(args)
    with _flight_recorder(args, "evolve") as rec, \
            obs.watch_compiles(rec), _metrics_writer(args) as metrics:
        if rec.enabled:
            rec.annotate_meta(engine=args.engine, trace=args.trace,
                              nodes=args.nodes,
                              workload={"nodes": wl.num_nodes,
                                        "pods": wl.num_pods})
            record_devices(rec)
        on_gen = None
        if metrics:
            def on_gen(st):
                # streamed per generation: an interrupted evolution still
                # leaves a complete metric trail up to the crash point
                metrics.write("generation", dataclasses.asdict(st))
        fs = evo.run(wl, cfg, backend=backend,
                     sim_config=SimConfig(watchdog=args.watchdog),
                     checkpoint_path=args.checkpoint,
                     wal_path=args.wal, out_dir=args.out,
                     engine=args.engine, on_generation=on_gen,
                     profile=args.profile, device=_device(args))
        if fs.best:
            rec.annotate_meta(best_score=fs.best[1],
                              best_exact=fs.best_exact,
                              generations=fs.generation)
        if fs.sentinel.alerts:
            rec.annotate_meta(parity_alerts=fs.sentinel.alerts)
    if fs.best:
        print(f"best fitness: {fs.best[1]:.4f}")
        # on interrupt evo.run already persisted champions
        if args.out and not getattr(fs, "interrupted", False):
            path = fs.save_top_policies(args.out, k=5)
            print(f"saved top policies to {path}")
            print(f"saved best policy to {fs.save_best_policy(args.out)}")
    if fs.sentinel.alerts:
        # drift beyond the tolerance: the fitness the selection trusted
        # disagrees with the exact reference evaluator
        print(f"PARITY ALERT: {fs.sentinel.alerts} generation(s) exceeded "
              f"drift tolerance {cfg.parity_tol:g} (max drift "
              f"{fs.sentinel.max_drift:.3g}); see the run dir's alert "
              "events", file=sys.stderr)
        return 3
    if getattr(fs, "llm_outage", False):
        # the run halted on the LLM-outage circuit breaker: "endpoint
        # down, retry later", apart from a failed search
        print(f"LLM OUTAGE: halted at generation {fs.generation} after "
              f"{fs.cfg.llm_outage_generations} consecutive generations "
              "with zero drafted candidates; checkpoint saved",
              file=sys.stderr)
        return 4
    return 0


#: the fused kernel's refusals that get ``scale``'s guidance (shape and
#: option guards), told apart from other ValueErrors by their text
_FUSED_GUARDS = ("fused kernel", "node_prefilter_k", "state_pack")


def cmd_scale(args) -> int:
    """Synthetic scale run: an N-node x P-pod generated trace, a
    population evaluated at once, a throughput report
    (fks_tpu/cli.py:440). Runs over a mesh with ``--devices N``, or over
    every card when more than one is visible. ``--code-pop N`` also
    measures the VM code-candidate tier (FakeLLM candidates lowered to
    register programs)."""
    import torch

    from fks_tpu_torch import obs
    from fks_tpu_torch.data.synthetic import synthetic_workload
    from fks_tpu_torch.device import resolve_device
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.obs.telemetry import record_devices, record_mesh
    from fks_tpu_torch.parallel import (
        make_population_eval, make_sharded_eval, num_shards, pad_population,
    )
    from fks_tpu_torch.parallel.mesh import (
        cuda_devices, lead_device, population_mesh,
    )
    from fks_tpu_torch.sim.engine import SimConfig, resolve_auto_prefilter
    from fks_tpu_torch.utils.profiling import ThroughputMeter

    dev = resolve_device(_device(args))
    mesh = _mesh(args)
    if mesh is None and dev.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = population_mesh(cuda_devices())
    with _flight_recorder(args, "scale") as rec, \
            obs.watch_compiles(rec), \
            _metrics_writer(args) as metrics:  # up front: bad paths fail fast
        node_park = None
        if args.openb_nodes:
            from fks_tpu_torch.data.traces import parse_node_yaml
            node_park = parse_node_yaml()
        wl = synthetic_workload(args.nodes_count, args.pods_count,
                                seed=args.seed, nodes=node_park)
        print(f"synthetic workload: {wl.num_nodes} nodes x {wl.num_pods} "
              f"pods, population {args.pop}"
              + (" (OpenB node park)" if node_park else ""),
              file=sys.stderr)
        if rec.enabled:
            rec.annotate_meta(engine=args.engine,
                              workload={"nodes": wl.num_nodes,
                                        "pods": wl.num_pods},
                              population=args.pop)
            record_devices(rec)
        lead = lead_device(mesh) if mesh is not None else dev
        gen = torch.Generator(device=lead)
        gen.manual_seed(args.seed)
        pop = parametric.init_population(gen, args.pop, noise=0.1)
        pk_override = args.prefilter_k
        c = wl.cluster
        if args.engine == "fused" and pk_override is None:
            pk = 0  # the fused kernel has no prefilter path; don't probe
        else:
            pk = resolve_auto_prefilter(
                parametric.score, pop[0], c.n_padded, c.g_padded,
                override=pk_override, recorder=rec, device=lead)
        cfg = SimConfig(node_prefilter_k=pk, state_pack=args.state_pack)
        try:
            if mesh is not None:
                shards = num_shards(mesh)
                padded, real = pad_population(pop, mesh)
                record_mesh(mesh, real_count=args.pop, recorder=rec)
                ev = make_sharded_eval(wl, mesh, cfg=cfg,
                                       elite_k=min(4, args.pop),
                                       engine=args.engine)
                with obs.span("eval", population=args.pop) as t:
                    scores = t.sync(ev(padded, real)[0])[:real]
                mode = f"sharded over {shards} devices"
            else:
                evp = make_population_eval(wl, cfg=cfg, engine=args.engine,
                                           device=dev)
                with obs.span("eval", population=args.pop) as t:
                    res = t.sync(evp(pop))
                scores = res.policy_score
                mode = "vmap on 1 device"
        except ValueError as e:
            if args.engine != "fused" or not any(
                    g in str(e) for g in _FUSED_GUARDS):
                raise  # only the fused kernel's guards get guidance
            print(f"error: {e}\n(try smaller --nodes-count/--pods-count, "
                  f"or --engine flat)", file=sys.stderr)
            return 2
        meter = ThroughputMeter()
        meter.add(args.pop, t.seconds)
        out = {
            "mode": mode, "engine": args.engine,
            "nodes": wl.num_nodes, "pods": wl.num_pods,
            "population": args.pop, "wall_s": round(t.seconds, 3),
            "evals_per_sec": round(meter.rate, 3),
            "score_min": round(float(scores.min()), 4),
            "score_max": round(float(scores.max()), 4),
            "node_prefilter_k": cfg.node_prefilter_k,
            "prefilter_auto": pk_override is None,
            "state_pack": cfg.state_pack,
            "openb_nodes": node_park is not None,
        }
        if args.code_pop > 0:
            rc = _scale_code_tier(args, wl, cfg, mesh, dev, rec, out)
            if rc:
                return rc
        if metrics:
            metrics.write("scale", out)
        rec.metric("scale", out)
    print(json.dumps(out, indent=2))
    return 0


def _scale_code_tier(args, wl, cfg, mesh, dev, rec, out) -> int:
    """``scale --code-pop N``: N FakeLLM candidates lowered to VM
    programs, evaluated at once (over the mesh when there is one); adds
    the ``code_*`` fields to ``out``. Returns 2 when too few candidates
    lower, else 0."""
    from fks_tpu_torch import obs
    from fks_tpu_torch.funsearch import vm
    from fks_tpu_torch.parallel import make_sharded_code_eval, pad_population
    from fks_tpu_torch.parallel.mesh import lead_device
    from fks_tpu_torch.sim import get_engine
    from fks_tpu_torch.sim.engine import resolve_auto_prefilter
    from fks_tpu_torch.sim.types import map_tensors
    from fks_tpu_torch.utils.profiling import ThroughputMeter

    # the fused kernel evaluates parametric weights only; the VM tier
    # runs on the interpreter engines
    code_engine = "flat" if args.engine == "fused" else args.engine
    c = wl.cluster
    progs, _ = vm.lower_fake_candidates(
        c.n_padded, c.g_padded, args.code_pop, capacity=256)
    if len(progs) < args.code_pop:
        print(f"error: FakeLLM lowered only {len(progs)} VM candidates; "
              f"lower --code-pop", file=sys.stderr)
        return 2
    lead = lead_device(mesh) if mesh is not None else dev
    stacked = map_tensors(lambda x: x.to(lead),
                          vm.stack_programs(progs[: args.code_pop]))
    # the code tier probes its own policy cost: VM register programs are
    # the expensive case the prefilter exists for, so auto may choose k>0
    # here while the parametric tier stayed dense
    pk_code = resolve_auto_prefilter(
        vm.score_static, map_tensors(lambda x: x.to(lead), progs[0]),
        c.n_padded, c.g_padded, override=args.prefilter_k, recorder=rec,
        device=lead)
    ccfg = dataclasses.replace(cfg, node_prefilter_k=pk_code)
    if mesh is not None:
        cpadded, creal = pad_population(stacked, mesh)
        cev = make_sharded_code_eval(wl, mesh, cfg=ccfg,
                                     elite_k=min(4, args.code_pop),
                                     engine=code_engine)
        with obs.span("code_eval", code_population=args.code_pop) as ct:
            cres = ct.sync(cev(cpadded, creal)[0])
    else:
        mod = get_engine(code_engine)
        cwl = wl.to(dev)
        crun = mod.make_population_run_fn(cwl, vm.score_static, ccfg)
        with obs.span("code_eval", code_population=args.code_pop) as ct:
            cres = ct.sync(crun(stacked, mod.initial_state(cwl, ccfg)))
    cscores = cres.policy_score[: args.code_pop]
    cmeter = ThroughputMeter()
    cmeter.add(args.code_pop, ct.seconds)
    out.update({
        "code_population": args.code_pop,
        "code_engine": code_engine,
        "code_prefilter_k": pk_code,
        "code_wall_s": round(ct.seconds, 3),
        "code_evals_per_sec": round(cmeter.rate, 3),
        "code_score_max": round(float(cscores.max()), 4),
    })
    return 0


def cmd_serve(args) -> int:
    """Serve a pinned champion as a warm what-if query engine."""
    from fks_tpu_torch.obs.telemetry import watch_compiles

    with _flight_recorder(args, "serve") as rec, watch_compiles(rec):
        return _serve(args, rec)


def _serve(args, rec) -> int:
    from fks_tpu_torch.serve import (
        ServeEngine, ServeService, ShapeEnvelope, latest_champion,
        load_champion, selftest,
    )
    from fks_tpu_torch.serve.artifact import CHAMPION_DIR
    from fks_tpu_torch.serve.service import run_http, run_jsonl

    mesh = _mesh(args)
    device = None if mesh is not None else _device(args)
    ledger_dir = args.ledger_dir or CHAMPION_DIR
    promotion_log = (args.promotion_log
                     or os.path.join(ledger_dir, "promotion.jsonl"))
    if args.artifact:
        engine = ServeEngine.load(args.artifact, recorder=rec,
                                  mesh=mesh, device=device)
    else:
        champ_path = args.champion
        if not champ_path and args.follow_ledger:
            # crash recovery: the promotion log outranks raw ledger
            # order — restart with whatever the last surviving
            # promotion shipped, not merely the best-scored file
            from fks_tpu_torch.pipeline import PromotionLog
            active = PromotionLog(promotion_log).active()
            if active and os.path.exists(active.get("champion", "")):
                champ_path = active["champion"]
                print(f"resuming promoted champion: {champ_path}",
                      file=sys.stderr)
        if not champ_path:
            champ_path = latest_champion(ledger_dir, recorder=rec)
        if not champ_path:
            print("error: no champion JSON found — pass --champion or "
                  "evolve one first (policies/discovered/)",
                  file=sys.stderr)
            return 2
        champion = load_champion(champ_path)
        wl = _parse_workload(args)
        build_kw = dict(
            envelope=ShapeEnvelope(max_pods=args.max_pods,
                                   max_batch=args.max_batch),
            engine=args.engine, prefilter_k=args.prefilter_k,
            state_pack=args.state_pack, mesh=mesh, recorder=rec,
            device=device)
        engine = None
        if args.serve_engine == "vm":
            from fks_tpu_torch.funsearch.vm import VMUnsupported
            from fks_tpu_torch.serve import VMServeEngine
            try:
                engine = VMServeEngine(champion, wl, **build_kw)
            except VMUnsupported as e:
                # coverage gap, not an error: serve it on the closure
                # engine and say so (the recorded event is what a
                # gate asserts on)
                rec.event("vm_swap", outcome="fallback",
                          champion=champ_path, detail=str(e))
                print(f"champion not VM-lowerable ({e}); falling "
                      "back to the AOT closure engine",
                      file=sys.stderr)
        if engine is None:
            engine = ServeEngine(champion, wl, **build_kw)
    if rec.enabled:
        rec.annotate_meta(
            engine=engine.engine_name, engine_kind=engine.engine_kind,
            champion={"score": engine.champion.score,
                      "source": engine.champion.source},
            envelope=engine.envelope.to_json(),
            policy_tier=engine.policy_tier,
            prefilter_k=engine.prefilter_k)
    cap = getattr(engine, "program_capacity", None)
    print(f"serving champion score={engine.champion.score:.4f} "
          f"tier={engine.policy_tier} engine={engine.engine_name} "
          f"kind={engine.engine_kind}"
          + (f" capacity={cap}" if cap else "")
          + f" prefilter_k={engine.prefilter_k}"
          + f" device={engine.device}"
          + (f" shards={engine._shards}" if mesh is not None else ""),
          file=sys.stderr)
    if args.save_artifact:
        if args.warmup:
            engine.warmup()
        path = engine.save(args.save_artifact)
        print(f"artifact saved: {path}", file=sys.stderr)
    if args.selftest:
        result = selftest(engine, count=args.selftest,
                          pods_per_query=args.pods_per_query,
                          tol=args.audit_tol)
        if args.serve_engine == "vm":
            # did the requested VM binding engage, or did the champion
            # fall back to the closure engine?
            result["vm_coverage"] = (1.0 if engine.engine_kind == "vm"
                                     else 0.0)
        if rec.enabled and "snapshot_cache" in result:
            rec.metric("snapshot_cache", **result["snapshot_cache"])
        print(json.dumps(result, indent=2))
        return 0 if result["ok"] else 1
    if args.warmup and not args.save_artifact:
        n = engine.warmup()
        print(f"warm: {n} bucket graphs captured", file=sys.stderr)
    if args.save_artifact and not (args.queries or args.http):
        return 0  # artifact-build invocation, nothing to serve
    slo = None
    if args.slo_p99_ms or args.slo_qps:
        from fks_tpu_torch.obs.history import SLOConfig
        slo = SLOConfig(p99_ms=args.slo_p99_ms, qps=args.slo_qps,
                        error_budget=args.slo_error_budget)
    service = ServeService(engine, recorder=rec,
                           max_wait_s=args.max_wait_ms / 1e3,
                           audit_every=args.audit_every,
                           audit_tol=args.audit_tol, slo=slo,
                           max_queue=args.max_queue,
                           default_deadline_s=args.request_deadline_s,
                           accounting=args.accounting)
    if args.degraded_fallback:
        from fks_tpu_torch.resilience import exact_fallback_factory

        service.enable_degraded_mode(
            exact_fallback_factory(engine.champion, _parse_workload(args),
                                   engine.envelope, recorder=rec),
            rebuild_factory=None)
        print("degraded-mode fallback armed (exact engine on the CPU, "
              "batch 1)", file=sys.stderr)
    drainer = None
    if args.drain_state:
        from fks_tpu_torch.resilience import (
            DrainCoordinator, load_serve_state,
        )

        if os.path.exists(args.drain_state):
            try:
                n = service.preload_replay(
                    load_serve_state(args.drain_state)["replay"])
                print(f"replay buffer preloaded: {n} queries from "
                      f"{args.drain_state}", file=sys.stderr)
            except ValueError as e:
                print(f"ignoring stale drain state: {e}",
                      file=sys.stderr)
        drainer = DrainCoordinator(service,
                                   state_path=args.drain_state,
                                   recorder=rec)
    stop_follow = None
    if args.follow_ledger:
        from fks_tpu_torch.obs.history import SLOConfig
        from fks_tpu_torch.pipeline import (
            PromotionConfig, PromotionController, follow_ledger,
        )
        controller = PromotionController(
            service, ledger_dir=ledger_dir, log_path=promotion_log,
            config=PromotionConfig(slo=slo if slo is not None
                                   else SLOConfig()),
            recorder=rec)
        # one synchronous poll before traffic (a champion newer than
        # the one we loaded promotes up front, deterministically),
        # then the background poll thread takes over
        first = controller.poll_once()
        if first.get("action") != "idle":
            print(f"promotion: {first}", file=sys.stderr)
        stop_follow, _ = follow_ledger(controller,
                                       interval=args.promote_interval)
    # the SIGTERM handler goes in after the synchronous poll: the handler
    # drains on the main thread's behalf and waits for the drain, which
    # could not finish while that same thread held a capture or an
    # engine's batch turn for the poll
    if drainer is not None and not drainer.install():
        print("warning: SIGTERM handler unavailable off the main "
              "thread; drain runs on normal shutdown only",
              file=sys.stderr)
    errors = 0
    try:
        if args.http:
            print(f"listening on http://127.0.0.1:{args.http} "
                  "(POST /query, GET /stats, GET /healthz)",
                  file=sys.stderr)
            run_http(service, args.http,
                     deadline_s=args.request_deadline_s,
                     drain_coordinator=drainer)
        elif args.queries and args.queries != "-":
            with open(args.queries) as f:
                errors = run_jsonl(service, f)
        else:
            errors = run_jsonl(service)  # stdin
    finally:
        if stop_follow is not None:
            stop_follow.set()
        if drainer is not None and drainer.report is None:
            # normal shutdown still drains + persists (idempotent
            # with the SIGTERM path)
            drainer.drain()
        if drainer is not None:
            drainer.uninstall()
        service.close()
        print(json.dumps(service.summary()), file=sys.stderr)
    return 1 if errors else 0


#: deterministic built-in portfolio (fks_tpu's): four template logics with
#: distinct placement behaviour, so the portfolio selftest runs before any
#: evolution has produced a ledger. Raw-milli scores: the normalized
#: variants collapse into all-tie policies under the template's int()
#: truncation and could not catch a cross-slot routing bug.
_PORTFOLIO_LOGICS = (
    "score = 1000",
    "score = node.cpu_milli_left - pod.cpu_milli",
    "score = node.memory_mib_left - pod.memory_mib",
    "score = pod.cpu_milli - node.cpu_milli_left",
)


def cmd_portfolio(args) -> int:
    """Multi-tenant champion-portfolio serving (``portfolio``): N resident
    policies in one set of graphs, routed per request. ``--selftest N``
    runs the per-slot parity sweep and then swaps one slot out and back
    under live traffic with a capture watcher; ``--http`` serves the
    routed front instead."""
    from fks_tpu_torch import obs
    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.portfolio import (
        PortfolioEngine, PortfolioService, Router, portfolio_selftest,
        vm_coverage_split,
    )
    from fks_tpu_torch.serve import ChampionSpec, ShapeEnvelope, load_champion
    from fks_tpu_torch.serve.service import run_http, run_jsonl

    mesh = _mesh(args)
    device = None if mesh is not None else _device(args)
    with _flight_recorder(args, "portfolio") as rec, \
            obs.watch_compiles(rec):
        if args.champion:
            champs = [load_champion(p) for p in args.champion]
            wl = _parse_workload(args)
        else:
            from fks_tpu_torch.data.synthetic import synthetic_workload
            champs = [ChampionSpec(code=template.fill_template(lg),
                                   score=0.5 + 0.1 * i,
                                   source=f"<builtin-{i}>")
                      for i, lg in enumerate(_PORTFOLIO_LOGICS)]
            wl = synthetic_workload(16, 32, seed=args.seed)
        resident, outside = vm_coverage_split(
            champs, wl.cluster.n_padded, wl.cluster.g_padded)
        if not resident:
            print("error: no champion is VM-lowerable at this cluster "
                  "shape — a portfolio needs at least one resident slot",
                  file=sys.stderr)
            return 2
        for c in outside:
            print(f"champion {c.source or '<inline>'} outside the VM "
                  "vocabulary; excluded from the slot table (serve it "
                  "through the Router's fallback engine)", file=sys.stderr)
        n_slots = args.slots or len(resident) + 1  # +1 spare staging slot
        engine = PortfolioEngine(
            resident, wl, n_slots=n_slots,
            envelope=ShapeEnvelope(max_pods=args.max_pods,
                                   max_batch=args.max_batch),
            engine=args.engine, mesh=mesh, recorder=rec, device=device)
        print(f"portfolio: {len(resident)} resident / {len(outside)} "
              f"fallback champions, {engine.n_slots} slots, "
              f"capacity={engine.program_capacity}, device={engine.device}"
              + (f", shards={engine._shards}" if mesh is not None else ""),
              file=sys.stderr)
        engine.warmup()
        if args.selftest:
            return _portfolio_selftest_run(args, engine, resident,
                                           portfolio_selftest)
        pins = {}
        for spec in args.pin:
            tenant, _, slot = spec.partition("=")
            pins[tenant] = int(slot)
        ab = {}
        for spec in args.ab:
            slot, _, weight = spec.partition("=")
            ab[int(slot)] = float(weight)
        router = Router(engine.n_slots, pins=pins, ab_split=ab or None)
        service = PortfolioService(engine, router=router, recorder=rec,
                                   max_wait_s=args.max_wait_ms / 1e3,
                                   max_queue=args.max_queue,
                                   accounting=True)
        try:
            if args.http:
                print(f"listening on http://127.0.0.1:{args.http} "
                      "(POST /query, GET /stats, GET /healthz)",
                      file=sys.stderr)
                run_http(service, args.http)
            else:
                run_jsonl(service)
        finally:
            service.close()
            print(json.dumps(service.summary()), file=sys.stderr)
    return 0


def _portfolio_selftest_run(args, engine, resident, portfolio_selftest):
    """The selftest body: per-slot and mixed-batch parity, then one slot
    swapped out and back while threads query every resident slot, with
    zero graph captures."""
    import threading

    from fks_tpu_torch.funsearch import template
    from fks_tpu_torch.obs.telemetry import CompileWatcher
    from fks_tpu_torch.serve import ChampionSpec

    result = portfolio_selftest(engine, count=args.selftest,
                                pods_per_query=args.pods_per_query,
                                tol=args.audit_tol)
    target = min(1, engine.n_slots - 1)
    promoted = ChampionSpec(
        code=template.fill_template(
            "score = 3000 + (node.cpu_milli_left - pod.cpu_milli) "
            "/ max(1, node.cpu_milli_total)"),
        score=9.9, source="<promoted>")
    base = engine.base_pods
    stop = threading.Event()
    errors = []

    def _hammer(slot):
        i = 0
        while not stop.is_set():
            q = [dict(base[(i + j) % len(base)]) for j in range(3)]
            try:
                ans = engine.answer_batch([q], slots=[slot])[0]
                if ans.get("score") is None:
                    errors.append(f"slot {slot}: empty answer")
            except Exception as e:  # noqa: BLE001 — surfaced in result
                errors.append(f"slot {slot}: {type(e).__name__}: {e}")
                return
            i += 1

    watcher = CompileWatcher().install()
    try:
        threads = [threading.Thread(target=_hammer, args=(s,))
                   for s in range(min(len(resident), engine.n_slots))]
        for t in threads:
            t.start()
        old = engine.swap_slot(target, promoted)
        engine.swap_slot(target, old)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        compiles = watcher.backend_compile_count
    finally:
        stop.set()
        watcher.uninstall()
    result["swap"] = {"slot": target, "swaps": 2, "compiles": compiles,
                      "errors": errors[:5],
                      **{k: engine.last_swap_breakdown[k]
                         for k in ("swap_ms", "h2d_ms", "h2d_bytes")}}
    result["ok"] = bool(result["ok"] and compiles == 0 and not errors)
    print(json.dumps(result, indent=2))
    return 0 if result["ok"] else 1


def cmd_pipeline(args) -> int:
    """Promotion-pipeline utilities (``pipeline``). Default: print the
    promotion.jsonl state-machine status (per-attempt states, the active
    promotion, interrupted attempts, torn lines). ``--drill`` runs the
    deterministic fault-injection drill matrix on the device instead and
    exits nonzero on any failed drill."""
    from fks_tpu_torch.serve.artifact import CHAMPION_DIR

    ledger_dir = args.ledger_dir or CHAMPION_DIR
    log_path = args.log or os.path.join(ledger_dir, "promotion.jsonl")
    if args.drill:
        from fks_tpu_torch import obs
        from fks_tpu_torch.pipeline import run_drills

        with _flight_recorder(args, "pipeline") as rec, \
                obs.watch_compiles(rec):
            results = run_drills(log=lambda m: print(m, file=sys.stderr),
                                 only=args.only, device=_device(args))
            ok = all(r["ok"] for r in results)
            if rec.enabled:
                rec.annotate_meta(drills=len(results), drills_ok=ok)
        print(json.dumps({"ok": ok, "drills": results}, indent=2))
        return 0 if ok else 1
    from fks_tpu_torch.pipeline import PromotionLog

    print(json.dumps(PromotionLog(log_path).summary(), indent=2))
    return 0



def cmd_loadgen(args) -> int:
    """Drive a sustained multi-tenant arrival mix against a warm serve
    service (``obs.workload.run_loadgen``) and print the summary — the
    four gated keys ``loadgen_qps`` / ``loadgen_p99_ms`` /
    ``loadgen_shed_rate`` / ``loadgen_fairness_index`` plus per-tenant
    breakdowns (fks_tpu/cli.py:792). Accounting is always on. Default is
    a hermetic template champion over a synthetic workload; ``--http``
    routes through the localhost HTTP front instead of the in-process
    client."""
    from fks_tpu_torch import obs
    from fks_tpu_torch.obs.history import SLOConfig
    from fks_tpu_torch.obs.workload import (
        http_client, parse_tenant_spec, run_loadgen, service_client,
    )
    from fks_tpu_torch.serve import (
        ChampionSpec, ServeEngine, ServeService, ShapeEnvelope,
        load_champion, make_http_server,
    )

    try:
        plan = parse_tenant_spec(args.tenants)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    with _flight_recorder(args, "loadgen") as rec, obs.watch_compiles(rec):
        if args.champion:
            champion = load_champion(args.champion)
            wl = _parse_workload(args)
        else:
            # hermetic default: a template champion over a synthetic
            # workload, so loadgen runs before any evolution has produced
            # a ledger (and repeat runs are bit-identical)
            from fks_tpu_torch.data.synthetic import synthetic_workload
            from fks_tpu_torch.funsearch import template

            champion = ChampionSpec(
                code=template.fill_template("score = 1000"),
                source="<loadgen-default>")
            wl = synthetic_workload(16, 32, seed=args.seed)
        engine = ServeEngine(
            champion, wl,
            envelope=ShapeEnvelope(max_pods=args.max_pods,
                                   max_batch=args.max_batch),
            engine=args.engine, recorder=rec, device=_device(args))
        engine.warmup()  # measure serving, not first-call captures
        slo = (SLOConfig(p99_ms=args.slo_p99_ms) if args.slo_p99_ms
               else None)
        service = ServeService(engine, recorder=rec, slo=slo,
                               max_queue=args.max_queue,
                               accounting=True,
                               workload_every=args.workload_every)
        if rec.enabled:
            rec.annotate_meta(tenants=args.tenants,
                              duration_s=args.duration,
                              front="http" if args.http is not None
                              else "in-process")
        server = None
        try:
            if args.http is not None:
                import threading

                server = make_http_server(service, args.http)
                port = server.server_address[1]
                threading.Thread(target=server.serve_forever,
                                 daemon=True).start()
                send = http_client(port)
                print(f"loadgen -> http://127.0.0.1:{port}/query",
                      file=sys.stderr)
            else:
                send = service_client(service)
            summary = run_loadgen(send, plan, duration_s=args.duration,
                                  seed=args.seed, recorder=rec)
        finally:
            if server is not None:
                server.shutdown()
                server.server_close()
            service.close()
            # record the serve-side view: tenant_stats / workload_mix /
            # slo_burn rows land in the run dir even when the request
            # count never crossed a workload_every window
            service.summary()
    print(json.dumps(summary, indent=2))
    return 0


def cmd_trace_diff(args) -> int:
    """Replay one policy through two engines with the decision trace on
    and report the first divergent scheduling step (``obs.tracing``;
    fks_tpu/cli.py:1346). Exit code contract: 0 = no divergence,
    1 = divergence found, 2 = error."""
    from fks_tpu_torch.obs import tracing
    from fks_tpu_torch.sim.engine import SimConfig

    engines = [e.strip() for e in args.engines.split(",") if e.strip()]
    if len(engines) != 2:
        print(f"--engines needs exactly two comma-separated names, got "
              f"{engines}", file=sys.stderr)
        return 2
    bad = [e for e in engines if e not in ("exact", "flat")]
    if bad:
        print(f"unsupported trace engine(s) {bad}: the fused kernel does "
              "not carry the decision trace; use 'exact' and/or 'flat'",
              file=sys.stderr)
        return 2
    wl = _parse_workload(args)
    label = args.code or args.policy
    if args.scenario is not None:
        # replay on one suite scenario (fault-injected variants included:
        # both trace engines carry NODE_DOWN/NODE_UP rows)
        from fks_tpu_torch.scenarios import get_suite

        try:
            suite = get_suite(args.suite, wl)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not 0 <= args.scenario < len(suite):
            print(f"error: --scenario {args.scenario} out of range for "
                  f"suite {suite.name!r} ({len(suite)} scenarios)",
                  file=sys.stderr)
            return 2
        wl = suite.workloads[args.scenario]
        label = (f"{label}@{suite.name}"
                 f"[{args.scenario}:{suite.names[args.scenario]}]")
    code = ""
    if args.code:
        try:
            with open(args.code) as f:
                code = f.read()
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    try:
        param_policy, params = tracing.policy_params(
            wl, policy_name=args.policy, code=code)
    except Exception as e:  # noqa: BLE001 — bad policy/code is a usage error
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    cfg_kw = {"cond_policy": True}
    if args.max_steps:
        cfg_kw["max_steps"] = args.max_steps
    # duplicate engine names (exact-vs-exact self-consistency) get #i tags
    # so the record's per-engine keys stay distinct
    names = [f"{e}#{i}" if engines.count(e) > 1 else e
             for i, e in enumerate(engines)]
    specs = [(name, eng, param_policy, params)
             for name, eng in zip(names, engines)]
    with _flight_recorder(args, "trace-diff") as rec:
        record = tracing.trace_diff(
            wl, specs, cfg=SimConfig(**cfg_kw), score_tol=args.tol,
            recorder=rec, label=label, device=_device(args))
    print(tracing.format_diff(record))
    return 1 if record["divergent"] else 0


def cmd_scenarios(args) -> int:
    """Scenario-suite discovery (fks_tpu/cli.py:1461): with no flags, list
    the registered suites; with ``--suite`` materialize one against the
    workload and print its summary; with ``--scenario I`` one scenario,
    with its NODE_DOWN/NODE_UP timeline. ``--run-dir`` lands the suite
    summary as a ``scenario_suite`` metric. Host-side only: it launches
    nothing on the device."""
    from fks_tpu_torch.scenarios import list_suites

    if not args.suite:
        print(json.dumps(list_suites(), indent=2))
        return 0
    from fks_tpu_torch.ops.heap import KIND_NODE_DOWN
    from fks_tpu_torch.scenarios import get_suite

    wl = _parse_workload(args)
    with _flight_recorder(args, "scenarios") as rec:
        try:
            suite = get_suite(args.suite, wl)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        desc = suite.describe()
        rec.metric("scenario_suite", desc)
        if args.scenario is None:
            print(json.dumps(desc, indent=2))
            return 0
        if not 0 <= args.scenario < len(suite):
            print(f"error: --scenario {args.scenario} out of range for "
                  f"suite {suite.name!r} ({len(suite)} scenarios)",
                  file=sys.stderr)
            return 2
        fe = suite.workloads[args.scenario].faults
        m = fe.mask.bool()
        row = dict(desc["scenarios"][args.scenario], fault_timeline=[
            {"time": int(t), "node": int(nd),
             "kind": ("NODE_DOWN" if int(k) == KIND_NODE_DOWN
                      else "NODE_UP")}
            for t, nd, k in zip(fe.time[m].tolist(), fe.node[m].tolist(),
                                fe.kind[m].tolist())])
    print(json.dumps(row, indent=2))
    return 0


def cmd_mem(args) -> int:
    """Memory observability (``obs.memory``; fks_tpu/cli.py:1511). Three
    modes: the memory view of a recorded run from ``--run-dir``'s JSONL
    (the footprint ladder, the per-layout roll-up, the watermark table
    and the leak sentinel's verdicts); ``--sample``, one live watermark
    sample as JSON; ``--drill NAME``, one memory drill, exit 0/1 on its
    verdict (``vm_swap_leak``: swaps and served batches with zero net
    growth of the live tensors; ``snapshot_cache_bound``: the snapshot
    cache under its byte ceiling)."""
    if args.drill:
        from fks_tpu_torch.obs import get_recorder
        from fks_tpu_torch.obs.memory import run_drill

        kw = {}
        if args.drill == "vm_swap_leak":
            kw = {"swaps": args.swaps, "batches": args.batches}
        with _flight_recorder(args, "mem"):
            res = run_drill(args.drill, recorder=get_recorder(),
                            device=_device(args), **kw)
        print(json.dumps(res))
        return 0 if res.get("ok") else 1
    if args.sample:
        from fks_tpu_torch.device import resolve_device
        from fks_tpu_torch.obs.memory import WatermarkSampler

        resolve_device(_device(args))  # no card: raise, never sample the CPU
        sampler = WatermarkSampler(enabled=True, trace_host=True)
        sampler.start()
        try:
            rec = sampler.sample(stage="cli")
        finally:
            sampler.stop()
        print(json.dumps(rec))
        return 0
    if not args.run_dir:
        print("error: mem needs --run-dir DIR (view mode), --sample, or "
              "--drill NAME", file=sys.stderr)
        return 2
    from fks_tpu_torch.obs.report import _memory_section, load_run

    try:
        _meta, _events, metrics = load_run(args.run_dir)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    lines = _memory_section(metrics)
    if not lines:
        print(f"(no memory records in {args.run_dir} — footprints land "
              "when an instrumented command compiles under --run-dir)")
        return 0
    print("\n".join(lines))
    return 0


def cmd_report(args) -> int:
    """Render a flight-recorder run directory (written by ``--run-dir``)
    back into fks_tpu's summary — generations table with a fitness
    sparkline, budget rungs, the profiler's attribution, SLOs, tenants,
    memory, layouts, captures and span hotspots — from the JSONL files
    alone (fks_tpu/cli.py:1087)."""
    from fks_tpu_torch.obs.report import render_report

    try:
        print(render_report(args.run_dir))
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def cmd_export_metrics(args) -> int:
    """Render a run directory as OpenMetrics text exposition; ``--out``
    replaces the file atomically (fks_tpu/cli.py:1102)."""
    from fks_tpu_torch.obs.exporter import to_openmetrics

    try:
        text = to_openmetrics(args.run_dir)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.out:
        # atomic replace: a scraper must never read a half-written file
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, args.out)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(text)
    return 0


def cmd_watch(args) -> int:
    """Live-tail a run directory with a heartbeat liveness verdict
    (HEALTHY / STALE / DEAD at 2x / 10x the run's own cadence); exits 0
    when the run finishes ok, 1 on error status or a dead run, 2 when it
    is no run directory (fks_tpu/cli.py:1126)."""
    from fks_tpu_torch.obs.exporter import watch

    try:
        return watch(args.run_dir, interval=args.interval, once=args.once)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 0


def cmd_spans(args) -> int:
    """Causal-trace viewer over a run directory's ``trace_span`` events
    (``obs.trace_ctx``): list traces, one request's waterfall
    (``--trace``, an unambiguous id prefix too), the slowest requests
    (``--slowest``), every served request's complete waterfall
    (``--check-complete``), or each generation's critical path
    (``--critical-path``, gated by ``--min-fraction``); fks_tpu's text
    and exit codes (fks_tpu/cli.py:1142)."""
    from fks_tpu_torch.obs import trace_ctx
    from fks_tpu_torch.obs.report import load_run

    try:
        _meta, events, metrics = load_run(args.run_dir)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    spans = trace_ctx.trace_spans(events)
    by = trace_ctx.traces_by_id(spans)

    if args.trace:
        match = by.get(args.trace)
        if match is None:  # allow unambiguous prefixes (ids are long)
            hits = [t for t in by if t.startswith(args.trace)]
            if len(hits) != 1:
                print(f"error: trace {args.trace!r} "
                      f"{'is ambiguous' if hits else 'not found'} "
                      f"({len(by)} traces in run)", file=sys.stderr)
                return 2
            match = by[hits[0]]
        print(trace_ctx.render_waterfall(match))
        return 0

    def _root(tid):
        roots = [s for s in by[tid] if not s.get("parent_id")]
        return roots[0] if len(roots) == 1 else None

    if args.check_complete:
        # the metric stream is the ground truth for what was served; the
        # event stream must reconstruct each such request's waterfall
        served = [m for m in metrics if m.get("kind") == "serve_request"
                  and m.get("trace_id")]
        bad = [m["trace_id"] for m in served
               if not trace_ctx.waterfall_complete(by.get(m["trace_id"], []))]
        print(f"served requests: {len(served)}  "
              f"complete waterfalls: {len(served) - len(bad)}")
        for tid in bad[:10]:
            print(f"  INCOMPLETE {tid}")
        if not served:
            print("error: no traced serve_request metrics in run",
                  file=sys.stderr)
            return 1
        return 1 if bad else 0

    if args.critical_path:
        gens = sorted(t for t in by if _root(t) is not None
                      and _root(t).get("path") == "generation")
        if not gens:
            print("error: no generation traces in run", file=sys.stderr)
            return 1
        failed = 0
        print(f"{'trace':<22} {'wall s':>8} {'attr %':>7} "
              f"{'dev-idle s':>10} {'llm-idle s':>10}  bounding")
        for tid in gens:
            cp = trace_ctx.critical_path(by[tid])
            if not cp.get("ok"):
                failed += 1
                print(f"{tid:<22} (no root span)")
                continue
            frac = cp["attributed_fraction"]
            low = frac < args.min_fraction
            failed += low
            print(f"{tid:<22} {cp['wall_seconds']:>8.3f} "
                  f"{frac * 100:>6.1f}% {cp['device_idle_seconds']:>10.3f} "
                  f"{cp['llm_idle_seconds']:>10.3f}  "
                  f"{cp['bounding_stage']}"
                  f"{'  << below min-fraction' if low else ''}")
        return 1 if failed else 0

    order = sorted(
        by, key=lambda t: -max(float(s.get("seconds", 0.0))
                               for s in by[t]))
    if args.slowest:
        shown = [t for t in order
                 if _root(t) is not None
                 and _root(t).get("path") == trace_ctx.SERVE_ROOT]
        for tid in shown[: args.slowest]:
            print(trace_ctx.render_waterfall(by[tid]))
            print()
        if not shown:
            print("error: no serve/request traces in run", file=sys.stderr)
            return 1
        return 0

    print(f"{len(by)} traces, {len(spans)} spans")
    for tid in order[:30]:
        root = _root(tid)
        path = root.get("path", "?") if root else "(torn)"
        wall = max(float(s.get("seconds", 0.0)) for s in by[tid])
        print(f"  {tid:<24} {path:<16} {wall * 1e3:>10.3f} ms  "
              f"{len(by[tid])} spans")
    if len(by) > 30:
        print(f"  ... {len(by) - 30} more (use --trace/--slowest)")
    return 0


def cmd_compare(args) -> int:
    """Cross-run regression gate (``obs.compare``): diff two run dirs or
    bench JSONL files on the shared metric vocabulary and exit 1 when the
    candidate regresses past a threshold, 2 on bad input. ``--baseline
    auto`` (the word ``auto`` as BASELINE) resolves the best healthy run
    under ``--history-root`` (fks_tpu/cli.py:1242)."""
    from fks_tpu_torch.obs.compare import (
        compare_runs, format_comparison, has_regression,
        parse_threshold_overrides,
    )

    baseline = args.baseline
    if baseline == "auto":
        from fks_tpu_torch.obs.history import resolve_auto_baseline

        root = args.history_root or _default_history_root()
        baseline = resolve_auto_baseline(root)
        if baseline is None:
            print(f"error: no healthy historical run under {root} to "
                  "auto-select as baseline", file=sys.stderr)
            return 2
        print(f"auto baseline: {baseline}", file=sys.stderr)
    try:
        thresholds = (parse_threshold_overrides(args.threshold)
                      if args.threshold else None)
        rows = compare_runs(baseline, args.candidate,
                            thresholds=thresholds)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(format_comparison(rows, baseline, args.candidate))
    return 1 if has_regression(rows) else 0


def _default_history_root() -> str:
    """``$FKS_BENCH_RESULTS_DIR``, else benchmarks/results under the repo
    root (fks_tpu/cli.py:1282)."""
    return os.environ.get("FKS_BENCH_RESULTS_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks", "results")


def cmd_trends(args) -> int:
    """Cross-run trend report (``obs.history``): index every run dir and
    bench evidence file under ROOT, render per-metric sparklines, flag
    regressions with the robust z-score pass. Exit 0 rendered, 1 with
    ``--fail-on-alert`` when a metric alerted, 2 bad or empty root
    (fks_tpu/cli.py:1293)."""
    from fks_tpu_torch.obs.history import RunHistory
    from fks_tpu_torch.obs.report import sparkline

    try:
        hist = RunHistory(args.root)
        hist.scan()
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not hist.entries:
        print(f"error: no runs indexed under {args.root}", file=sys.stderr)
        return 2
    if args.write_index:
        path = hist.write_index()
        print(f"indexed {len(hist.entries)} entries -> {path}",
              file=sys.stderr)
    metrics = ([m.strip() for m in args.metric.split(",") if m.strip()]
               if args.metric else None)
    reports = hist.trends(metrics=metrics, window=args.window, z=args.z)
    print(f"trend report: {len(hist.entries)} indexed entries "
          f"under {args.root}")
    total_alerts = 0
    with _flight_recorder(args, "trends") as rec:
        for rep in reports:
            rec.metric("trend_report",
                       {k: rep[k] for k in ("metric", "runs", "alerts",
                                            "higher_is_better", "window",
                                            "z", "values", "labels")})
            arrow = ("higher=better" if rep["higher_is_better"]
                     else "lower=better")
            print(f"\n{rep['metric']}  ({rep['runs']} runs, {arrow})")
            print(f"  {sparkline(rep['values'])}  latest "
                  f"{rep['values'][-1]:g}")
            for a in rep["alerts"]:
                total_alerts += 1
                print(f"  ALERT {a['direction']} at {a['run']}: "
                      f"{a['value']:g} vs prior median {a['median']:g} "
                      f"(robust z {a['z']:+.1f})")
    if not reports:
        print("\nno watched metrics present in the indexed entries")
    print(f"\n{total_alerts} trend alert(s)")
    if total_alerts and args.fail_on_alert:
        return 1
    return 0


def cmd_layout(args) -> int:
    """Layout observability (``obs.layout``; fks_tpu/cli.py:1571). View
    (default): the per-layout cost ledger of ``--run-dir``'s JSONL.
    ``--explore``: measure every valid layout of the (population x suite)
    shape over the devices (``--devices N``: the first N CUDA devices, or
    N logical CPU shards with ``--cpu``; default every card, or the one
    CPU; ``--logical-shards N`` deals N logical shards over them),
    persist the best into the ``RunHistory`` under ``--history-root``
    when that directory exists, and print the summary JSON; exit 1 when
    the chosen layout (``--mesh-shape CxS``, default the candidates-only
    layout) is measurably dominated, 2 on a ``--mesh-shape`` that is not
    among the valid layouts."""
    if args.explore:
        from fks_tpu_torch.data.synthetic import synthetic_workload
        from fks_tpu_torch.obs import get_recorder
        from fks_tpu_torch.obs.layout import explore_layouts
        from fks_tpu_torch.parallel.mesh import cuda_devices
        from fks_tpu_torch.scenarios import get_suite

        if _device(args) == "cpu":
            devices = ["cpu"] * (args.devices or 1)
        else:
            devices = cuda_devices(args.devices or None)
        logical = getattr(args, "logical_shards", 0)
        if logical:
            # round robin over the devices: several layouts on one card
            devices = [devices[i % len(devices)] for i in range(logical)]
        wl = synthetic_workload(16, 32, seed=args.seed)
        suite = get_suite(args.suite, wl)
        wkey = f"pop{args.pop}_{args.suite}"
        history = None
        root = args.history_root or _default_history_root()
        if os.path.isdir(root):
            from fks_tpu_torch.obs.history import RunHistory
            history = RunHistory(root)
        engine = args.engine if args.engine != "fused" else "flat"
        with _flight_recorder(args, "layout"):
            summary = explore_layouts(
                suite, devices=devices, population=args.pop, engine=engine,
                recorder=get_recorder(), history=history,
                workload_key=wkey)
        chosen = summary["default_layout_key"]
        chosen_steady = summary["default_steady_seconds"]
        if args.mesh_shape:
            match = [p for p in summary["probes"]
                     if p["mesh_shape"] == args.mesh_shape]
            if not match:
                shapes = [p["mesh_shape"] for p in summary["probes"]]
                print(f"error: --mesh-shape {args.mesh_shape} not among "
                      f"the valid layouts {shapes}", file=sys.stderr)
                return 2
            chosen = match[0]["layout_key"]
            chosen_steady = match[0]["steady_seconds"]
        best = summary["best_steady_seconds"]
        dominated = (summary["best_layout_key"] != chosen
                     and best > 0
                     and chosen_steady / best > 1.05)
        summary["chosen_layout_key"] = chosen
        summary["chosen_dominated"] = dominated
        print(json.dumps(summary, indent=2))
        if dominated:
            print(f"DOMINATED: chosen layout {chosen} is "
                  f"{chosen_steady / best:.2f}x slower than "
                  f"{summary['best_layout_key']}", file=sys.stderr)
            return 1
        return 0
    if not args.run_dir:
        print("error: layout needs --run-dir DIR (view mode) or "
              "--explore", file=sys.stderr)
        return 2
    from fks_tpu_torch.obs.report import _layout_section, load_run

    try:
        _meta, _events, metrics = load_run(args.run_dir)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    lines = _layout_section(metrics)
    if not lines:
        print(f"(no layout records in {args.run_dir} — ledger rows land "
              "when a sharded entry point runs under --run-dir)")
        return 0
    print("\n".join(lines))
    return 0


def cmd_lint(args) -> int:
    """The capture-invariant lint (``analysis.lint``; fks_tpu/cli.py:1419)
    over the given paths (default: the port's package): exit 0 clean, 1
    findings, 2 error; one ``lint_report`` row under ``--run-dir``. The
    port has no jaxpr pins: ``--pins`` and ``--write-pins`` exit 2,
    ``--no-pins`` changes nothing."""
    from fks_tpu_torch.analysis import lint

    if args.pins or args.write_pins:
        print("error: the port has no jaxpr pins (a captured CUDA graph "
              "has no lowered program to hash); lint checks the captured "
              "step bodies only", file=sys.stderr)
        return 2
    paths = args.paths or [os.path.dirname(os.path.abspath(__file__))]
    findings = lint.lint_paths(paths)
    for f in findings:
        print(f)
    ok = not findings
    with _flight_recorder(args, "lint") as rec:
        rec.metric("lint_report", {
            "paths": list(paths),
            "findings": [f.to_json() for f in findings],
            "pin_drift": [],
            "ok": ok,
        })
    print(f"lint: {len(findings)} finding(s), 0 pin message(s) -> "
          f"{'clean' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_traces(args) -> int:
    """Dataset discovery (fks_tpu/cli.py:1654)."""
    from fks_tpu_torch.data import TraceParser

    parser = TraceParser()
    print("node files:")
    for f in parser.get_available_node_files():
        print(f"  {f}")
    print("pod files:")
    for f in parser.get_available_pod_files():
        print(f"  {f}")
    return 0


def _add_trace_flags(p) -> None:
    p.add_argument("--trace", default="openb_pod_list_default.csv",
                   help="pod CSV under benchmarks/traces/csv/")
    p.add_argument("--nodes", default="gpu_models_filtered.csv",
                   help="node CSV under benchmarks/traces/csv/")


def _add_devices_flag(p, what: str) -> None:
    p.add_argument("--devices", type=int, default=0,
                   help=f"{what} over the first N CUDA devices (raises "
                        "with fewer), or with --cpu over N logical CPU "
                        "shards; unlike fks_tpu, it does not require "
                        "--cpu (0 = one device)")


def _common_parser() -> argparse.ArgumentParser:
    """fks_tpu's ``common`` parent (fks_tpu/cli.py:1671-1687), with the
    port's ``--device``."""
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the same as --device cpu)")
    common.add_argument("--device", default="cuda",
                        help="where the command runs: 'cuda' (default; "
                             "raises without a card) or 'cpu' (the plain "
                             "PyTorch path)")
    common.add_argument("--metrics", default="",
                        help="append JSONL metric records to this file")
    common.add_argument("--run-dir", default="",
                        help="flight-recorder run directory (meta.json, "
                             "events.jsonl, metrics.jsonl, heartbeat), in "
                             "fks_tpu's layout")
    common.add_argument("--engine", choices=("exact", "flat", "fused"),
                        default="exact",
                        help="simulation engine: 'exact' replicates the "
                             "reference bit for bit; 'flat' is the "
                             "throughput engine (documented retry-rule "
                             "divergence, fks_tpu_torch.sim.flat); 'fused' "
                             "is the CUDA whole-loop kernel (parametric "
                             "populations — 'scale' command only)")
    return common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fks_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = _common_parser()

    b = sub.add_parser("bench", help="policy comparison table",
                       parents=[common])
    _add_trace_flags(b)
    b.add_argument("--policies", default="",
                   help="comma-separated zoo policy names (default: all)")
    b.add_argument("--f64", action="store_true",
                   help="float64 evaluator arithmetic (exact reference "
                        "parity)")
    b.add_argument("--validate", action="store_true",
                   help="enable the per-event invariant audit")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("simulate", help="one policy, detailed JSON result",
                       parents=[common])
    _add_trace_flags(s)
    s.add_argument("--policy", default="best_fit")
    s.add_argument("--f64", action="store_true")
    s.add_argument("--validate", action="store_true")
    s.set_defaults(fn=cmd_simulate)

    e = sub.add_parser("evolve", help="run FunSearch evolution",
                       parents=[common])
    _add_trace_flags(e)
    e.add_argument("--config", default="",
                   help="reference-format llm_config.json")
    e.add_argument("--fake-llm", action="store_true",
                   help="deterministic offline codegen backend")
    e.add_argument("--checkpoint", default="",
                   help="evolution checkpoint path")
    e.add_argument("--wal", default="",
                   help="generation write-ahead log path "
                        "(resilience.wal): drafted candidates and eval "
                        "outcomes are fsync'd mid-generation and the loop "
                        "checkpoints every generation — a kill "
                        "mid-generation resumes without re-spending LLM "
                        "calls or device evals (pair with --checkpoint)")
    e.add_argument("--out", default="",
                   help="directory for champion JSONs")
    e.add_argument("--generations", type=int, default=None)
    e.add_argument("--parametric-rounds", type=int, default=None,
                   help="device-resident weight-evolution generations to "
                        "interleave per LLM generation (hybrid mode; the "
                        "champion is rendered to source and competes in "
                        "the code population)")
    e.add_argument("--watchdog", action="store_true",
                   help="enable the numerics watchdog (SimConfig."
                        "watchdog): NaN/Inf policy scores are masked to 0 "
                        "and flagged in SimResult.numeric_flags; "
                        "violations land as 'watchdog' events in the run "
                        "dir")
    e.add_argument("--parity-sample", type=int, default=None,
                   help="per generation, re-score this many sampled "
                        "population members through the exact reference "
                        "evaluator and alert on fitness drift (0 = off; "
                        "exit 3 when any generation alerts)")
    e.add_argument("--parity-tol", type=float, default=None,
                   help="parity drift tolerance (default 1e-5; raise "
                        "above the measured divergence bound for "
                        "--engine flat)")
    e.add_argument("--suite", default=None,
                   help="score candidates by composite ROBUST fitness "
                        "over this scenario suite (try 'default8') "
                        "instead of single-trace fitness — one batched "
                        "evaluation covers every scenario, fault-injected "
                        "variants included")
    e.add_argument("--robust-agg", choices=("mean", "min", "cvar"),
                   default=None,
                   help="how per-scenario scores fold into the robust "
                        "score (default mean; cvar = mean of the worst "
                        "quarter)")
    e.add_argument("--budget", choices=("none", "halving"), default=None,
                   help="eval-budget allocation over the suite "
                        "(funsearch.budget): 'halving' probes the whole "
                        "generation cheaply, then only the top 1/eta "
                        "advance to the full suite (requires --suite)")
    e.add_argument("--budget-eta", type=int, default=None,
                   help="survivor fraction denominator for --budget "
                        "halving (default 2: keep the top half)")
    e.add_argument("--probe-suite", default=None,
                   help="probe-rung suite name (default smoke3)")
    e.add_argument("--probe-steps", type=int, default=None,
                   help="probe-rung event budget (truncated trace "
                        "prefix; 0 = full trace on the probe suite)")
    e.add_argument("--first-pods", type=int, default=argparse.SUPPRESS,
                   help="read only the first N pods of --trace (the port's "
                        "own flag: a FakeLLM generation on the full trace "
                        "is VM-bound, tens of minutes on the card)")
    e.add_argument("--profile", action="store_true",
                   help="attribute wall time per pipeline stage (codegen/"
                        "preflight/transpile/device-eval/rank/ledger) with "
                        "the CUDA-graph-capture vs compute split and lane "
                        "occupancy — device_profile records in the run "
                        "dir. Off adds no device fence")
    e.set_defaults(fn=cmd_evolve)

    sc = sub.add_parser("scale", help="synthetic scale run + throughput",
                        parents=[common])
    sc.add_argument("--nodes-count", "--nodes", dest="nodes_count",
                    type=int, default=1000)
    sc.add_argument("--pods-count", "--pods", dest="pods_count",
                    type=int, default=100000)
    sc.add_argument("--pop", type=int, default=8)
    sc.add_argument("--seed", type=int, default=0,
                    help="workload seed, and the seed of the population's "
                         "torch.Generator draw (fks_tpu draws it with "
                         "jax.random, so the weights and scores differ "
                         "from fks_tpu's for the same seed)")
    sc.add_argument("--prefilter-k", type=int, default=None,
                    help="SimConfig.node_prefilter_k: score only the "
                         "top-k statically-feasible nodes per event "
                         "(0 = dense scan, bit-identical to the default "
                         "program). Default: auto — a cheap policy-cost "
                         "probe enables the prefilter for expensive "
                         "policies on big node parks and leaves cheap "
                         "parametric scoring dense "
                         "(sim.engine.resolve_auto_prefilter)")
    sc.add_argument("--state-pack", action="store_true",
                    help="SimConfig.state_pack: narrow flat-engine carry "
                         "columns to 16-bit where the value range "
                         "provably fits (exact integer packing)")
    sc.add_argument("--openb-nodes", action="store_true",
                    help="draw the node park from the vendored OpenB "
                         "node list (benchmarks/traces/node_yaml/, 1213 "
                         "nodes; --nodes-count selects a prefix) instead "
                         "of the synthetic archetype sampler")
    sc.add_argument("--code-pop", type=int, default=0,
                    help="also measure the VM code-candidate tier with N "
                         "FakeLLM-lowered register programs (0 = off); "
                         "sharded over the mesh when there is one")
    _add_devices_flag(sc, "shard the population")
    sc.set_defaults(fn=cmd_scale)

    sv = sub.add_parser("serve",
                        help="serve a pinned champion as a warm what-if "
                             "query engine (JSONL/HTTP)", parents=[common])
    _add_trace_flags(sv)
    sv.add_argument("--champion", default="",
                    help="champion JSON from the evolution ledger "
                         "(default: best under policies/discovered/)")
    sv.add_argument("--artifact", default="",
                    help="load a saved serve artifact directory instead of "
                         "building from --champion/--trace")
    sv.add_argument("--serve-engine", choices=("aot", "vm"), default="aot",
                    help="champion binding: 'aot' makes the policy a "
                         "constant of per-champion graphs (the exact "
                         "reference); 'vm' serves the champion as data — "
                         "register-program tables in champion-agnostic "
                         "graphs, so a hot-swap is a table copy with zero "
                         "captures (VM-unlowerable champions fall back to "
                         "aot)")
    sv.add_argument("--save-artifact", default="",
                    help="persist the built engine (artifact.json) to this "
                         "directory")
    sv.add_argument("--max-pods", type=int, default=1024,
                    help="shape envelope: largest query (pods per what-if)")
    sv.add_argument("--max-batch", type=int, default=8,
                    help="shape envelope: largest coalesced request batch")
    sv.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="flush policy: max ms the oldest pending request "
                         "waits for batch-mates (default 5)")
    sv.add_argument("--request-deadline-s", type=float, default=60.0,
                    help="per-request deadline budget in seconds (default "
                         "60); a request's own deadline_ms field wins; "
                         "shed/expired requests answer a structured 503 "
                         "with Retry-After (0 = no deadline)")
    sv.add_argument("--max-queue", type=int, default=0,
                    help="bounded request queue: admission control sheds "
                         "submits beyond this depth with a typed 503 "
                         "(0 = unbounded)")
    sv.add_argument("--degraded-fallback", action="store_true",
                    help="arm degraded-mode serving: on a classified "
                         "device fault, flip to a reduced-batch exact "
                         "fallback engine on the CPU (same champion and "
                         "ladder); off by default")
    sv.add_argument("--drain-state", default="",
                    help="on SIGTERM, drain the batcher and persist the "
                         "replay buffer + summary to this path (loaded "
                         "back on the next start to refill shadow-eval "
                         "replay traffic)")
    sv.add_argument("--prefilter-k", type=int, default=None,
                    help="SimConfig.node_prefilter_k override (default: "
                         "auto via the policy-cost probe)")
    sv.add_argument("--state-pack", action="store_true",
                    help="SimConfig.state_pack for the serving engine; "
                         "also engages the 16-bit packed query-upload "
                         "path (bit-identical answers)")
    _add_devices_flag(sv, "mesh-sharded serving: shard the lane axis")
    sv.add_argument("--warmup", action="store_true",
                    help="capture every (lane, pod) shape bucket before "
                         "answering")
    sv.add_argument("--queries", default="",
                    help="answer request JSONL from this file ('-' or "
                         "empty = stdin), one answer line per request")
    sv.add_argument("--http", type=int, default=0,
                    help="serve a localhost HTTP listener on this port "
                         "instead of JSONL")
    sv.add_argument("--selftest", type=int, default=0,
                    help="run the batched-vs-unbatched exact-parity sweep "
                         "with N queries and exit (nonzero on drift)")
    sv.add_argument("--pods-per-query", type=int, default=4,
                    help="query size for --selftest (default 4)")
    sv.add_argument("--audit-every", type=int, default=0,
                    help="ParitySentinel-audit every Nth served answer "
                         "against the unbatched exact engine (0 = off)")
    sv.add_argument("--audit-tol", type=float, default=1e-5,
                    help="audit/selftest score drift tolerance")
    sv.add_argument("--slo-p99-ms", type=float, default=0.0,
                    help="SLO: target p99 latency in ms (0 = unset)")
    sv.add_argument("--slo-qps", type=float, default=0.0,
                    help="SLO: target sustained queries/sec (0 = unset)")
    sv.add_argument("--slo-error-budget", type=float, default=0.01,
                    help="fraction of requests allowed over the p99 "
                         "target (default 0.01)")
    sv.add_argument("--follow-ledger", action="store_true",
                    help="run the promotion controller alongside serving: "
                         "tail the champion ledger, shadow-gate each new "
                         "champion, hot-swap on promotion, roll back on "
                         "SLO burn (fks_tpu_torch.pipeline)")
    sv.add_argument("--ledger-dir", default="",
                    help="champion ledger directory to follow (default: "
                         "policies/discovered/)")
    sv.add_argument("--promotion-log", default="",
                    help="promotion.jsonl path (default: "
                         "<ledger-dir>/promotion.jsonl)")
    sv.add_argument("--promote-interval", type=float, default=5.0,
                    help="seconds between ledger polls (default 5)")
    sv.add_argument("--accounting", action="store_true",
                    help="per-tenant accounting + query fingerprinting "
                         "(obs.workload); off by default")
    sv.set_defaults(fn=cmd_serve)

    lg = sub.add_parser(
        "loadgen",
        help="drive a sustained multi-tenant arrival mix against a warm "
             "serve service and print the gated loadgen summary",
        parents=[common])
    _add_trace_flags(lg)
    lg.add_argument("--tenants", default="a:closed:2,b:closed:2,c:open:25",
                    help="arrival plan, comma-separated "
                         "name:mode:amount[:pods] — 'closed' amount = "
                         "worker count (submit-wait-repeat), 'open' "
                         "amount = Poisson qps (arrivals never wait on "
                         "responses); pods = pods per query (default 2)")
    lg.add_argument("--duration", type=float, default=5.0,
                    help="seconds to sustain the arrival plan (default 5)")
    lg.add_argument("--seed", type=int, default=0,
                    help="loadgen RNG seed (open-loop arrival gaps; also "
                         "the synthetic-workload seed)")
    lg.add_argument("--champion", default="",
                    help="champion JSON to serve (default: a hermetic "
                         "built-in template champion over a synthetic "
                         "workload)")
    lg.add_argument("--http", type=int, nargs="?", const=0, default=None,
                    help="route through the concurrent localhost HTTP "
                         "front on this port (bare --http = ephemeral "
                         "port) instead of the in-process client")
    lg.add_argument("--max-pods", type=int, default=64,
                    help="shape envelope: largest query (default 64)")
    lg.add_argument("--max-batch", type=int, default=4,
                    help="shape envelope: largest coalesced batch "
                         "(default 4)")
    lg.add_argument("--max-queue", type=int, default=0,
                    help="bounded queue depth for admission-control "
                         "shedding (0 = unbounded)")
    lg.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="per-tenant SLO p99 target feeding burn rates "
                         "(default 50; 0 = unset)")
    lg.add_argument("--workload-every", type=int, default=100,
                    help="emit tenant_stats/workload_mix every N served "
                         "requests (default 100)")
    lg.set_defaults(fn=cmd_loadgen)

    pf = sub.add_parser(
        "portfolio",
        help="serve N resident champions from one set of graphs with "
             "per-request routing (pin / affinity / A-B / coverage "
             "fallback)", parents=[common])
    _add_trace_flags(pf)
    pf.add_argument("--champion", action="append", default=[],
                    help="champion JSON to load into a slot (repeatable; "
                         "default: four deterministic built-in template "
                         "champions over a synthetic workload)")
    pf.add_argument("--slots", type=int, default=0,
                    help="slot-table size (default: resident champions "
                         "+ 1 spare slot)")
    pf.add_argument("--seed", type=int, default=0,
                    help="synthetic-workload seed for the built-in "
                         "champion set (default 0)")
    _add_devices_flag(pf, "mesh-sharded serving: shard the lane axis")
    pf.add_argument("--max-pods", type=int, default=64,
                    help="shape envelope: largest query (default 64)")
    pf.add_argument("--max-batch", type=int, default=4,
                    help="shape envelope: largest coalesced batch per "
                         "shard (default 4)")
    pf.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="flush policy: max ms the oldest pending "
                         "request waits for batch-mates (default 5)")
    pf.add_argument("--max-queue", type=int, default=0,
                    help="bounded queue depth for admission-control "
                         "shedding (0 = unbounded)")
    pf.add_argument("--pin", action="append", default=[],
                    help="tenant pin rule tenant=slot (repeatable)")
    pf.add_argument("--ab", action="append", default=[],
                    help="A/B split rule slot=weight (repeatable; weights "
                         "normalized; assignment keyed by a deterministic "
                         "request-id hash)")
    pf.add_argument("--http", type=int, default=0,
                    help="serve a localhost HTTP listener on this port "
                         "instead of JSONL over stdin")
    pf.add_argument("--selftest", type=int, default=0,
                    help="run the per-slot + mixed-batch parity sweep "
                         "with N queries per slot, then swap one slot "
                         "out and back under live traffic with a capture "
                         "watcher, and exit (nonzero on drift or any "
                         "capture)")
    pf.add_argument("--pods-per-query", type=int, default=3,
                    help="query size for --selftest (default 3)")
    pf.add_argument("--audit-tol", type=float, default=1e-5,
                    help="selftest score drift tolerance")
    pf.set_defaults(fn=cmd_portfolio)

    pp = sub.add_parser(
        "pipeline", parents=[common],
        help="promotion-pipeline status / fault-injection drills")
    pp.add_argument("--ledger-dir", default="",
                    help="champion ledger directory (default: "
                         "policies/discovered/)")
    pp.add_argument("--log", default="",
                    help="promotion.jsonl path (default: "
                         "<ledger-dir>/promotion.jsonl)")
    pp.add_argument("--drill", action="store_true",
                    help="run the deterministic fault-injection drill "
                         "matrix (corrupt champion, device-eval error, "
                         "p99 regression, kill -9 at every state, "
                         "rollback-on-burn, zero-capture swap, VM double "
                         "swap, portfolio slot promotion, LLM outage, "
                         "plus the resilience matrix: deadline storm, "
                         "queue overload, device loss mid-batch and on a "
                         "sharded engine, degrade-then-recover, SIGTERM "
                         "drain, WAL resume) and exit nonzero on any "
                         "failure")
    pp.add_argument("--only", default="",
                    help="comma-separated drill-name substrings: run only "
                         "the matching drills (e.g. "
                         "--only deadline_storm,wal_resume)")
    pp.set_defaults(fn=cmd_pipeline)

    td = sub.add_parser(
        "trace-diff",
        help="replay one policy through two engines with decision traces "
             "and report the first divergent step (exit 1 on divergence)")
    _add_trace_flags(td)
    td.add_argument("--engines", default="exact,flat",
                    help="two comma-separated engines from {exact, flat} "
                         "(the fused kernel cannot carry the trace); "
                         "repeat one (exact,exact) for a self-check")
    td.add_argument("--policy", default="best_fit",
                    help="zoo policy to replay (ignored with --code)")
    td.add_argument("--code", default="",
                    help="candidate source file to replay on the "
                         "funsearch VM instead of a zoo policy")
    td.add_argument("--suite", default="default8",
                    help="scenario suite providing --scenario variants "
                         "(default default8)")
    td.add_argument("--scenario", type=int, default=None,
                    help="replay on suite scenario INDEX (0-based) instead "
                         "of the base workload — fault-injected scenarios "
                         "diff NODE_DOWN/NODE_UP rows too")
    td.add_argument("--max-steps", type=int, default=0,
                    help="cap replay steps (0 = engine default)")
    td.add_argument("--tol", type=float, default=1e-5,
                    help="score/margin comparison tolerance (default 1e-5)")
    td.add_argument("--cpu", action="store_true",
                    help="replay on the CPU (default: the card)")
    td.add_argument("--run-dir", default="",
                    help="flight-recorder run directory for the "
                         "decision_trace / trace_diff records")
    td.set_defaults(fn=cmd_trace_diff)

    sn = sub.add_parser("scenarios",
                        help="list scenario suites / describe one suite "
                             "or scenario", parents=[common])
    _add_trace_flags(sn)
    sn.add_argument("--suite", default="",
                    help="materialize this suite against the workload and "
                         "print its summary (omit to list registered "
                         "suites)")
    sn.add_argument("--scenario", type=int, default=None,
                    help="describe one scenario (0-based index) incl. its "
                         "fault timeline")
    sn.set_defaults(fn=cmd_scenarios)

    mm = sub.add_parser(
        "mem",
        help="memory observability: footprint ladder / watermark view "
             "of a run, one live sample, or a leak drill (exit 1 on a "
             "failed drill)", parents=[common])
    mm.add_argument("--drill",
                    choices=("vm_swap_leak", "snapshot_cache_bound"),
                    default="",
                    help="run one deterministic memory drill and exit "
                         "0/1 on its verdict")
    mm.add_argument("--swaps", type=int, default=50,
                    help="vm_swap_leak: swap_program iterations "
                         "(default 50)")
    mm.add_argument("--batches", type=int, default=200,
                    help="vm_swap_leak: interleaved serve batches "
                         "(default 200)")
    mm.add_argument("--sample", action="store_true",
                    help="take one live watermark sample (host RSS + "
                         "per-card allocator counters) and print it as "
                         "JSON")
    mm.add_argument("--devices", type=int, default=0,
                    help="fks_tpu's flag (the size of its virtual CPU "
                         "mesh); accepted for its command lines, the "
                         "drills here run one engine on one device")
    mm.set_defaults(fn=cmd_mem)

    r = sub.add_parser("report",
                       help="summarize a flight-recorder run directory")
    r.add_argument("run_dir", help="directory written by --run-dir")
    r.set_defaults(fn=cmd_report)

    x = sub.add_parser("export-metrics",
                       help="render a run directory as OpenMetrics text")
    x.add_argument("run_dir", help="directory written by --run-dir")
    x.add_argument("--out", default="",
                   help="write to this file (atomic replace) instead of "
                        "stdout — point a node_exporter textfile "
                        "collector at it")
    x.set_defaults(fn=cmd_export_metrics)

    w = sub.add_parser("watch",
                       help="live-tail a run directory with a heartbeat "
                            "liveness verdict")
    w.add_argument("run_dir", help="directory written by --run-dir")
    w.add_argument("--interval", type=float, default=5.0,
                   help="seconds between polls (default 5)")
    w.add_argument("--once", action="store_true",
                   help="print one snapshot + verdict and exit")
    w.set_defaults(fn=cmd_watch)

    sp = sub.add_parser("spans",
                        help="causal-trace viewer: per-request latency "
                             "waterfalls and evolve critical paths")
    sp.add_argument("run_dir", help="directory written by --run-dir")
    sp.add_argument("--trace", metavar="ID",
                    help="render the waterfall of one trace "
                         "(unambiguous id prefix accepted)")
    sp.add_argument("--slowest", type=int, metavar="N",
                    help="render the N slowest serve/request waterfalls")
    sp.add_argument("--check-complete", action="store_true",
                    help="exit 1 unless every traced serve_request "
                         "reconstructs a complete waterfall")
    sp.add_argument("--critical-path", action="store_true",
                    help="per-generation critical path with device-idle "
                         "vs LLM-idle seconds")
    sp.add_argument("--min-fraction", type=float, default=0.95,
                    help="with --critical-path: fail if any generation "
                         "attributes less than this fraction of its "
                         "wall (default 0.95)")
    sp.set_defaults(fn=cmd_spans)

    c = sub.add_parser("compare",
                       help="regression-gate a candidate run against a "
                            "baseline (exit 1 on regression)")
    c.add_argument("baseline", help="run dir or bench JSONL file")
    c.add_argument("candidate", help="run dir or bench JSONL file")
    c.add_argument("--threshold", default="",
                   help="comma-separated overrides, e.g. "
                        "'evals_per_sec=rel:0.2,best_score=abs:1e-4'")
    c.add_argument("--history-root", default="",
                   help="with BASELINE 'auto': the history root to select "
                        "the best healthy run from (default: "
                        "benchmarks/results, or $FKS_BENCH_RESULTS_DIR)")
    c.set_defaults(fn=cmd_compare)

    tr = sub.add_parser(
        "trends",
        help="cross-run trend report over a directory of run dirs / bench "
             "evidence (exit 1 with --fail-on-alert on regressions)")
    tr.add_argument("root",
                    help="directory holding flight-recorder run dirs "
                         "and/or bench JSONL evidence files (e.g. "
                         "benchmarks/results)")
    tr.add_argument("--metric", default="",
                    help="comma-separated metrics to watch (default: the "
                         "built-in TREND_METRICS vocabulary)")
    tr.add_argument("--window", type=int, default=5,
                    help="prior-run window the robust median/MAD is "
                         "computed over (default 5)")
    tr.add_argument("--z", type=float, default=3.5,
                    help="robust z-score threshold (MAD units, default "
                         "3.5; the MAD is floored at 2%% of the median so "
                         "flat series don't false-positive)")
    tr.add_argument("--fail-on-alert", action="store_true",
                    help="exit 1 when any watched metric alerts (the CI "
                         "gate mode)")
    tr.add_argument("--write-index", action="store_true",
                    help="persist the scanned entries to ROOT/history.jsonl "
                         "(atomic replace)")
    tr.add_argument("--run-dir", default="",
                    help="flight-recorder run directory for the "
                         "trend_report records")
    tr.set_defaults(fn=cmd_trends)

    ln = sub.add_parser(
        "lint",
        help="capture-invariant AST lints over the port's captured step "
             "bodies (exit 1 on findings)")
    ln.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: "
                         "fks_tpu_torch)")
    ln.add_argument("--pins", default="",
                    help="fks_tpu's pin manifest flag: the port has no "
                         "jaxpr pins, so it exits 2")
    ln.add_argument("--write-pins", action="store_true",
                    help="fks_tpu's flag: the port has no jaxpr pins, so "
                         "it exits 2")
    ln.add_argument("--no-pins", action="store_true",
                    help="fks_tpu's flag; accepted, changes nothing (the "
                         "port checks no pins)")
    ln.add_argument("--cpu", action="store_true",
                    help="fks_tpu's flag; accepted (the lint runs no "
                         "device work)")
    ln.add_argument("--run-dir", default="",
                    help="flight-recorder run directory for the "
                         "lint_report record")
    ln.set_defaults(fn=cmd_lint)

    ly = sub.add_parser(
        "layout",
        help="layout observability: per-layout cost ledger view of a "
             "run, or --explore to measure every valid layout of a "
             "(population x suite x mesh) shape (exit 1 when the chosen "
             "layout is measurably dominated)",
        parents=[common])
    ly.add_argument("--explore", action="store_true",
                    help="enumerate + probe every valid layout and print "
                         "the summary JSON (persists the best into "
                         "RunHistory as a prior)")
    ly.add_argument("--devices", type=int, default=0,
                    help="explore over the first N CUDA devices (raises "
                         "with fewer), or with --cpu over N logical CPU "
                         "shards; unlike fks_tpu, it does not require "
                         "--cpu (0 = every card, or the one CPU)")
    ly.add_argument("--logical-shards", type=int, default=argparse.SUPPRESS,
                    help="with --explore: explore over N logical shards "
                         "dealt round robin over the devices (the port's "
                         "own flag: one card then has several layouts)")
    ly.add_argument("--pop", type=int, default=64,
                    help="explore population size (default 64)")
    ly.add_argument("--suite", default="default8",
                    help="scenario suite to explore (default: default8)")
    ly.add_argument("--mesh-shape", default="",
                    help="the chosen CxS layout to defend (e.g. 4x2); "
                         "default: the candidates-only default layout")
    ly.add_argument("--seed", type=int, default=0,
                    help="synthetic base-workload seed (default 0)")
    ly.add_argument("--history-root", default="",
                    help="RunHistory root for the layout prior (default: "
                         "benchmarks/results, or $FKS_BENCH_RESULTS_DIR)")
    ly.set_defaults(fn=cmd_layout)

    t = sub.add_parser("traces", help="list available trace files")
    t.set_defaults(fn=cmd_traces)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if getattr(args, "engine", "exact") == "fused" and args.cmd != "scale":
        ap.error("--engine fused evaluates parametric populations only — "
                 "it applies to the 'scale' command (other commands run "
                 "single policies or arbitrary evolved code; use "
                 "'exact'/'flat' there)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
