"""The port's command line: ``python -m fks_tpu_torch.cli serve ...``,
``... portfolio ...`` and ``... pipeline ...``.

Port of the ``serve``, ``portfolio`` and ``pipeline`` subcommands of
fks_tpu.cli (fks_tpu/cli.py:589-785, :896-1051 and :1054-1082, arguments
:1812-1927, :1970-2047). ``serve`` serves a pinned champion as a warm
what-if query engine — build or load an artifact, optionally capture
every shape bucket up front, then answer queries over stdin/JSONL, a
file, or a localhost HTTP listener; ``--selftest N`` instead runs the
batched-vs-unbatched exact-parity sweep and exits nonzero on any drift.
``--follow-ledger`` runs the promotion controller beside serving (resume
the last surviving promotion, shadow-gate each new ledger champion,
hot-swap, roll back on SLO burn); ``--drain-state PATH`` drains and
persists the replay buffer on SIGTERM and preloads it on the next start.
``portfolio`` serves N resident champions from one set of graphs with
per-request routing; ``--selftest N`` runs the per-slot and mixed-batch
parity sweep, then swaps one slot out and back under live traffic and
fails on any capture. ``pipeline`` prints the promotion log's status,
or with ``--drill`` runs the fault-injection drill matrix and exits
nonzero on any failed drill. ``--run-dir DIR`` flight-records any of the
three into fks_tpu's run-directory layout.

Runs on the card (``--device cuda``, the default) or, with ``--device
cpu`` (or ``--cpu``), on the plain PyTorch path. ``--devices N`` shards
the lane axis over a mesh: on the card the first N CUDA devices (it
raises when there are fewer), on the CPU N logical shards of the one CPU
device. fks_tpu's ``--devices`` instead sizes a virtual CPU device mesh
and requires ``--cpu``. fks_tpu's other subcommands and the metrics file
wait for ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_workload(args):
    from fks_tpu_torch.data import TraceParser

    return TraceParser().parse_workload(node_file=args.nodes,
                                        pod_file=args.trace)


def _device(args) -> str:
    return "cpu" if args.cpu else args.device


def _mesh(args):
    """``--devices N``: a population mesh of the first N CUDA devices
    (raises with fewer), or of N logical shards on the CPU; None for 0."""
    if not args.devices:
        return None
    from fks_tpu_torch.parallel.mesh import cuda_devices, population_mesh

    if _device(args) == "cpu":
        return population_mesh(["cpu"] * args.devices)
    return population_mesh(cuda_devices(args.devices))


def _flight_recorder(args, command):
    """Context manager installing the process-wide flight recorder when
    ``--run-dir`` was given (``obs.recording``), else the shared
    NullRecorder. Opened up front, so an unwritable run directory fails
    before any device work."""
    from fks_tpu_torch import obs

    if not args.run_dir:
        return obs.recording(obs.NULL)
    return obs.recording(obs.FlightRecorder(
        args.run_dir, meta={"command": command, "argv": sys.argv[1:]}))


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


def _add_run_dir_flag(p) -> None:
    p.add_argument("--run-dir", default="",
                   help="flight-recorder run directory (meta.json, "
                        "events.jsonl, metrics.jsonl, heartbeat), in "
                        "fks_tpu's layout")


def _add_placement_flags(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the engine runs: 'cuda' (default) or "
                        "'cpu' (the plain PyTorch path)")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--devices", type=int, default=0,
                   help="mesh-sharded serving: shard the lane axis over "
                        "the first N CUDA devices (raises with fewer), or "
                        "with --cpu over N logical CPU shards; unlike "
                        "fks_tpu, it does not require --cpu (0 = one "
                        "device)")


def _add_trace_flags(p) -> None:
    p.add_argument("--trace", default="openb_pod_list_default.csv",
                   help="pod CSV under benchmarks/traces/csv/")
    p.add_argument("--nodes", default="gpu_models_filtered.csv",
                   help="node CSV under benchmarks/traces/csv/")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fks_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("serve",
                        help="serve a pinned champion as a warm what-if "
                             "query engine (JSONL/HTTP)")
    _add_placement_flags(sv)
    sv.add_argument("--engine", choices=("exact", "flat", "fused"),
                    default="exact",
                    help="simulation engine: 'exact' replicates the "
                         "reference bit-for-bit; 'flat' trades the "
                         "documented retry-rule divergence for throughput; "
                         "'fused' refuses (parametric populations only)")
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
    _add_run_dir_flag(sv)
    sv.set_defaults(fn=cmd_serve)

    pf = sub.add_parser(
        "portfolio",
        help="serve N resident champions from one set of graphs with "
             "per-request routing (pin / affinity / A-B / coverage "
             "fallback)")
    _add_placement_flags(pf)
    pf.add_argument("--engine", choices=("exact", "flat"), default="exact",
                    help="simulation engine (default exact)")
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
    _add_run_dir_flag(pf)
    pf.set_defaults(fn=cmd_portfolio)

    pp = sub.add_parser(
        "pipeline",
        help="promotion-pipeline status / fault-injection drills")
    pp.add_argument("--device", default="cuda",
                    help="where --drill runs its serve stack: 'cuda' "
                         "(default) or 'cpu'")
    pp.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
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
    _add_run_dir_flag(pp)
    pp.set_defaults(fn=cmd_pipeline)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
