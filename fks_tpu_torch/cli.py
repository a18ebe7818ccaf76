"""The port's command line: ``python -m fks_tpu_torch.cli serve ...``.

Port of the ``serve`` subcommand of fks_tpu.cli (fks_tpu/cli.py:589-700,
arguments :1812-1927): serve a pinned champion as a warm what-if query
engine — build or load an artifact, optionally capture every shape bucket
up front, then answer queries over stdin/JSONL, a file, or a localhost
HTTP listener. ``--selftest N`` instead runs the batched-vs-unbatched
exact-parity sweep and exits nonzero on any drift.

Runs on the card (``--device cuda``, the default) or, with ``--device
cpu``, on the plain PyTorch path. fks_tpu's other subcommands, the run
directory and the metrics file wait for ROADMAP queue 1 item 6; options
that need the mesh, the promotion log or the drain coordinator raise and
name their item.
"""
from __future__ import annotations

import argparse
import json
import sys


def _parse_workload(args):
    from fks_tpu_torch.data import TraceParser

    return TraceParser().parse_workload(node_file=args.nodes,
                                        pod_file=args.trace)


def _check_waiting_options(args) -> None:
    """Options of fks_tpu's serve that wait for unported modules."""
    if args.devices:
        raise ValueError("--devices (mesh-sharded serving) needs "
                         "parallel/mesh.py: ROADMAP queue 1 item 3")
    if args.follow_ledger:
        raise ValueError("--follow-ledger needs pipeline.PromotionLog and "
                         "the promotion controller: ROADMAP queue 1 item 5")
    if args.drain_state:
        raise ValueError("--drain-state needs resilience/drain.py: ROADMAP "
                         "queue 1 item 5")


def cmd_serve(args) -> int:
    """Serve a pinned champion as a warm what-if query engine."""
    _check_waiting_options(args)
    from fks_tpu_torch import obs
    from fks_tpu_torch.obs.telemetry import watch_compiles
    from fks_tpu_torch.serve import (
        ServeEngine, ServeService, ShapeEnvelope, latest_champion,
        load_champion, selftest,
    )
    from fks_tpu_torch.serve.artifact import CHAMPION_DIR
    from fks_tpu_torch.serve.service import run_http, run_jsonl

    rec = obs.get_recorder()
    with watch_compiles(rec):
        ledger_dir = args.ledger_dir or CHAMPION_DIR
        if args.artifact:
            engine = ServeEngine.load(args.artifact, recorder=rec,
                                      device=args.device)
        else:
            champ_path = args.champion or latest_champion(ledger_dir,
                                                          recorder=rec)
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
                state_pack=args.state_pack, recorder=rec,
                device=args.device)
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
              + f" device={engine.device}", file=sys.stderr)
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
        errors = 0
        try:
            if args.http:
                print(f"listening on http://127.0.0.1:{args.http} "
                      "(POST /query, GET /stats, GET /healthz)",
                      file=sys.stderr)
                run_http(service, args.http,
                         deadline_s=args.request_deadline_s)
            elif args.queries and args.queries != "-":
                with open(args.queries) as f:
                    errors = run_jsonl(service, f)
            else:
                errors = run_jsonl(service)  # stdin
        finally:
            service.close()
            print(json.dumps(service.summary()), file=sys.stderr)
    return 1 if errors else 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fks_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("serve",
                        help="serve a pinned champion as a warm what-if "
                             "query engine (JSONL/HTTP)")
    sv.add_argument("--device", default="cuda",
                    help="where the engine runs: 'cuda' (default) or "
                         "'cpu' (the plain PyTorch path)")
    sv.add_argument("--engine", choices=("exact", "flat", "fused"),
                    default="exact",
                    help="simulation engine: 'exact' replicates the "
                         "reference bit-for-bit; 'flat' trades the "
                         "documented retry-rule divergence for throughput; "
                         "'fused' refuses (parametric populations only)")
    sv.add_argument("--trace", default="openb_pod_list_default.csv",
                    help="pod CSV under benchmarks/traces/csv/")
    sv.add_argument("--nodes", default="gpu_models_filtered.csv",
                    help="node CSV under benchmarks/traces/csv/")
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
                    help="(waits for resilience/drain.py; raises)")
    sv.add_argument("--prefilter-k", type=int, default=None,
                    help="SimConfig.node_prefilter_k override (default: "
                         "auto via the policy-cost probe)")
    sv.add_argument("--state-pack", action="store_true",
                    help="SimConfig.state_pack for the serving engine; "
                         "also engages the 16-bit packed query-upload "
                         "path (bit-identical answers)")
    sv.add_argument("--devices", type=int, default=0,
                    help="(mesh-sharded serving waits for the mesh; "
                         "raises unless 0)")
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
                    help="(the promotion controller waits for pipeline/; "
                         "raises)")
    sv.add_argument("--ledger-dir", default="",
                    help="champion ledger directory (default: "
                         "policies/discovered/)")
    sv.add_argument("--accounting", action="store_true",
                    help="per-tenant accounting + query fingerprinting "
                         "(obs.workload); off by default")
    sv.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
