"""The CI gate runner of the port: 15 gates, the port's tests, one row.

Port of fks_tpu's ``tools/run_full_suite.py``. It runs fks_tpu's 15
gates under their names and in their order, each a function returning
``{"ok": ...}`` with fks_tpu's detail keys, each driving ``python -m
fks_tpu_torch.cli`` with the arguments of fks_tpu's gate; then pytest;
then it appends one evidence row with fks_tpu's keys (the pass, fail and
deselected counts, wall time, git revision, every gate) and prints it.

- obs_gate: ``tools/check_jsonl_schema.py`` (stdlib only) and ``compare``
  of tests/fixtures/golden_run against itself, both exit 0;
- trace_gate: ``trace-diff --engines exact,exact`` finds no divergence;
- scale_gate: a small ``scale`` with the prefilter and packed state;
- serve_gate, sharded_serve_gate: the champion-serving selftest, then on
  a mesh with 16-bit packed state;
- lint_gate: ``lint`` is clean;
- trends_gate: an injected 30% drop in a synthetic 10-run history raises
  exactly one alert, the clean series none;
- promote_gate, resilience_gate: ``pipeline --drill`` (all, then the
  resilience drills);
- vm_serve_gate: the VM engine's selftest and the double hot swap;
- span_trace_gate: complete waterfalls for a recorded serve selftest,
  >= 95% of a recorded evolve generation on traced stages;
- memory_gate: the ``vm_swap_leak`` and ``snapshot_cache_bound`` drills;
- loadgen_gate: two closed-loop tenants through the HTTP front;
- portfolio_gate: a 4-champion portfolio selftest on a mesh;
- layout_gate: the layout explorer finds >= 2 valid layouts at parity.

Every gate runs on the card unless ``--cpu`` is given; with ``--cpu``
every gate passes ``--cpu``, as fks_tpu's always do. Where the port
departs from fks_tpu's gate it says so at the gate:

- lint_gate needs a clean ``lint`` and checks no jaxpr pins (the port
  has none: its ``--pins`` exits 2);
- sharded_serve_gate, memory_gate and portfolio_gate take ``--devices``
  equal to the card count on the card (8 logical CPU shards with
  ``--cpu``, as fks_tpu's 8 virtual devices); layout_gate on the card
  deals ``--logical-shards 8`` over the cards (one card has one layout);
- span_trace_gate's evolve reads the first 256 pods (``--first-pods``):
  a FakeLLM generation on the full trace is VM-bound, tens of minutes
  on the card and hours on the CPU;
- loadgen_gate runs ``cli loadgen --http`` (fks_tpu runs ``bench.py
  --stage loadgen``) and applies that stage's checks itself: requests
  completed, no errors, shed rate <= 0.05, fairness >= 0.8, and no
  graph capture after the first served request (fks_tpu's
  ``steady_state_recompiles``);
- the pytest step runs the port's tests (``tests/test_torch_*.py``), not
  the whole suite: with ``--cpu`` all of them, fast and slow; on the
  card the gpu-marked ones, in the files that collect there without the
  reference (``test_files``);
- the row goes to ``--out`` (default ``build/full_suite.jsonl``, which
  git ignores), never under ``benchmarks/``.

Usage: python -m fks_tpu_torch.tools.run_full_suite [--cpu] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "build", "full_suite.jsonl")
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_run")
#: the gates, in fks_tpu's order (its main's)
GATES = ("obs_gate", "trace_gate", "scale_gate", "serve_gate",
         "sharded_serve_gate", "lint_gate", "trends_gate", "promote_gate",
         "resilience_gate", "vm_serve_gate", "span_trace_gate",
         "memory_gate", "loadgen_gate", "portfolio_gate", "layout_gate")
#: fks_tpu's shard count for its virtual-device gates
CPU_SHARDS = 8
#: span_trace_gate's evolve pods (module docstring)
EVOLVE_PODS = 256
RESILIENCE_DRILLS = ("deadline_storm,queue_overload,device_loss,degrade,"
                     "sigterm,wal_resume")


def cli(*args: str) -> List[str]:
    """``python -m fks_tpu_torch.cli ARGS``."""
    return [sys.executable, "-m", "fks_tpu_torch.cli", *args]


def _on(cpu: bool) -> List[str]:
    return ["--cpu"] if cpu else []


def _shards(cpu: bool) -> str:
    """``--devices`` of a mesh gate: fks_tpu's 8 virtual devices as 8
    logical CPU shards, else every card."""
    if cpu:
        return str(CPU_SHARDS)
    import torch

    return str(max(1, torch.cuda.device_count()))


def _run(cmd, timeout=None) -> subprocess.CompletedProcess:
    """``subprocess.run`` from the repository root, output captured; a
    command past its time limit reads as exit 124."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                              timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return subprocess.CompletedProcess(
            cmd, 124, e.stdout or "", f"timed out after {timeout} s")


def _tail(proc) -> str:
    return (proc.stderr or proc.stdout or "")[-500:]


def _single(cmd, timeout) -> dict:
    """A gate of one command that must exit 0."""
    proc = _run(cmd, timeout)
    ok = proc.returncode == 0
    detail = {"rc": proc.returncode}
    if not ok:
        detail["err"] = _tail(proc)
    return {"ok": ok, **detail}


def _steps(steps, timeout) -> dict:
    """A gate of several commands, each of which must exit 0; stops at
    the first that does not."""
    detail, ok = {}, True
    for name, cmd in steps:
        proc = _run(cmd, timeout)
        detail[f"{name}_rc"] = proc.returncode
        if proc.returncode != 0:
            ok = False
            detail[f"{name}_err"] = _tail(proc)
            break
    return {"ok": ok, **detail}


def obs_gate(cpu: bool = False) -> dict:
    """Schema-check the golden run dir and self-compare it (exit 0
    expected). Returns {"ok": bool, ...}."""
    schema = _run([sys.executable,
                   os.path.join(REPO, "tools", "check_jsonl_schema.py"),
                   "--run-dir", GOLDEN])
    compare = _run(cli("compare", GOLDEN, GOLDEN))
    ok = schema.returncode == 0 and compare.returncode == 0
    detail = {"schema_rc": schema.returncode, "compare_rc": compare.returncode}
    if not ok:
        detail["schema_err"] = (schema.stderr or "")[-500:]
        detail["compare_err"] = _tail(compare)
    return {"ok": ok, **detail}


def trace_gate(cpu: bool = False) -> dict:
    """Trace-diff self-consistency: exact-vs-exact on the default trace
    must exit 0 (no divergence)."""
    return _single(cli("trace-diff", *_on(cpu), "--engines", "exact,exact",
                       "--policy", "first_fit", "--max-steps", "256"), None)


def scale_gate(cpu: bool = False) -> dict:
    """Scale-tier smoke: a small ``scale`` run with prefiltering and
    packed state dtypes must complete (exit 0)."""
    return _single(cli("scale", *_on(cpu), "--nodes", "64", "--pods", "512",
                       "--pop", "2", "--prefilter-k", "8", "--state-pack",
                       "--engine", "flat"), 600)


def _selftest(*extra: str) -> List[str]:
    return [*extra, "--selftest", "4", "--pods-per-query", "3",
            "--max-pods", "16", "--max-batch", "4"]


def serve_gate(cpu: bool = False) -> dict:
    """Serving parity: batched warm-path answers against the unbatched
    exact engine (golden-trace queries) must exit 0."""
    return _single(cli("serve", *_selftest(*_on(cpu))), 600)


def sharded_serve_gate(cpu: bool = False) -> dict:
    """The same selftest on a mesh (``--devices``: module docstring) with
    16-bit packed uploads, 0.0 drift and identical placements."""
    return _single(cli("serve", *_selftest(*_on(cpu), "--devices",
                                           _shards(cpu), "--state-pack")),
                   600)


def lint_gate(cpu: bool = False) -> dict:
    """The port's lint must be clean (exit 0). Unlike fks_tpu's gate no
    jaxpr pins are checked: a captured CUDA graph has no lowered program
    to hash, and the port's ``--pins`` exits 2."""
    return _single(cli("lint", *_on(cpu)), 600)


def promote_gate(cpu: bool = False) -> dict:
    """Promotion-drill matrix: every deterministic fault-injection drill
    must pass (``pipeline --drill`` exits 0)."""
    return _single(cli("pipeline", *_on(cpu), "--drill"), 900)


def span_trace_gate(cpu: bool = False) -> dict:
    """Causal-trace completeness: a recorded serve selftest must produce
    a complete waterfall for every served request, and a recorded 1-gen
    fake-LLM evolve (on the first ``EVOLVE_PODS`` pods) must attribute
    >= 95% of the generation wall to traced stages."""
    with tempfile.TemporaryDirectory() as tmp:
        serve_dir = os.path.join(tmp, "serve")
        evolve_dir = os.path.join(tmp, "evolve")
        return _steps((
            ("serve", cli("serve", *_selftest(*_on(cpu)),
                          "--run-dir", serve_dir)),
            ("serve_waterfalls", cli("spans", serve_dir,
                                     "--check-complete")),
            ("evolve", cli("evolve", *_on(cpu), "--fake-llm",
                           "--generations", "1", "--first-pods",
                           str(EVOLVE_PODS), "--run-dir", evolve_dir)),
            ("critical_path", cli("spans", evolve_dir, "--critical-path",
                                  "--min-fraction", "0.95")),
        ), 900)


def resilience_gate(cpu: bool = False) -> dict:
    """Resilience-drill matrix: deadline storm, queue overload, device
    loss mid-batch, degrade-then-recover, SIGTERM drain and WAL resume
    must pass (``pipeline --drill --only ...`` exits 0)."""
    return _single(cli("pipeline", *_on(cpu), "--drill", "--only",
                       RESILIENCE_DRILLS), 900)


def vm_serve_gate(cpu: bool = False) -> dict:
    """VM-native serving: the champion-as-data selftest must exit 0, and
    the double hot-swap drill must promote twice with zero graph
    captures on the serving path."""
    return _steps((
        ("selftest", cli("serve", *_selftest(*_on(cpu), "--serve-engine",
                                             "vm"))),
        ("double_swap", cli("pipeline", *_on(cpu), "--drill", "--only",
                            "vm_double_swap")),
    ), 900)


def memory_gate(cpu: bool = False) -> dict:
    """Memory drills: zero net live-memory growth across repeated
    swap+serve cycles (``vm_swap_leak``; ``--devices`` as the mesh gates,
    which ``mem`` accepts and ignores), and the snapshot cache holding
    its byte cap while re-hitting recent entries."""
    return _steps((
        ("vm_swap_leak", cli("mem", *_on(cpu), "--devices", _shards(cpu),
                             "--drill", "vm_swap_leak")),
        ("snapshot_cache_bound", cli("mem", *_on(cpu), "--drill",
                                     "snapshot_cache_bound")),
    ), 900)


def _steady_captures(run_dir: str) -> int:
    """Graph captures (``compile`` events) at or after the first served
    request of a ``loadgen --run-dir``: the steady state's."""
    def rows(name):
        path = os.path.join(run_dir, name)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    served = [r["ts"] for r in rows("metrics.jsonl")
              if r.get("kind") == "serve_request"]
    if not served:
        return 0
    first = min(served)
    return sum(1 for r in rows("events.jsonl")
               if r.get("kind") == "compile" and r["ts"] >= first)


def loadgen_gate(cpu: bool = False) -> dict:
    """Multi-tenant load generation: a short deterministic two-tenant
    closed-loop run through the concurrent HTTP front must complete with
    a bounded shed rate, a Jain fairness index >= 0.8 and zero
    steady-state graph captures (the checks of fks_tpu's ``bench.py
    --stage loadgen``, applied here to ``cli loadgen``'s summary)."""
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "loadgen")
        proc = _run(cli("loadgen", *_on(cpu), "--engine", "flat",
                        "--tenants", "a:closed:2,b:closed:2",
                        "--duration", "2", "--http", "--max-pods", "8",
                        "--max-batch", "2", "--run-dir", run_dir), 900)
        rc = proc.returncode
        if rc == 0:
            try:
                s = json.loads(proc.stdout)
            except json.JSONDecodeError:
                rc = 1
            else:
                if (s["requests"] == 0 or s["completed"] == 0
                        or s["errors"] or s["loadgen_shed_rate"] > 0.05
                        or s["loadgen_fairness_index"] < 0.8
                        or _steady_captures(run_dir)):
                    rc = 1
    ok = rc == 0
    detail = {"rc": rc}
    if not ok:
        detail["err"] = _tail(proc)
    return {"ok": ok, **detail}


def portfolio_gate(cpu: bool = False) -> dict:
    """Portfolio serving: four resident champions on a mesh, per-slot
    and mixed-batch parity (<= 1e-5), one slot promoted mid-traffic with
    zero graph captures."""
    proc = _run(cli("portfolio", *_on(cpu), "--devices", _shards(cpu),
                    "--selftest", "4"), 900)
    ok = proc.returncode == 0
    detail = {"rc": proc.returncode}
    try:
        summary = json.loads(proc.stdout)
        detail["max_drift"] = summary.get("max_drift")
        detail["mixed_max_drift"] = summary.get("mixed_max_drift")
        detail["swap_compiles"] = summary.get("swap", {}).get("compiles")
        detail["n_slots"] = summary.get("n_slots")
    except json.JSONDecodeError:
        ok = False
    if not ok:
        detail["err"] = _tail(proc)
    return {"ok": ok, **detail}


def layout_gate(cpu: bool = False) -> dict:
    """Layout observability: ``layout --explore`` of pop-16 x default8
    must find >= 2 distinct valid layouts, every one parity-equal to the
    default (<= 1e-5), and persist its prior; exit 1 (the default
    dominated) is informational. On the card the explorer deals 8
    logical shards over the cards."""
    where = (["--cpu", "--devices", str(CPU_SHARDS)] if cpu
             else ["--devices", _shards(cpu), "--logical-shards",
                   str(CPU_SHARDS)])
    detail = {}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        proc = _run(cli("layout", "--explore", *where, "--pop", "16",
                        "--suite", "default8", "--history-root", tmp), 900)
        # rc 1 is the dominance verdict, not a machinery failure
        detail["rc"] = proc.returncode
        if proc.returncode not in (0, 1):
            detail["err"] = _tail(proc)
            return {"ok": False, **detail}
        try:
            summary = json.loads(proc.stdout)
        except json.JSONDecodeError:
            detail["err"] = (proc.stdout or "")[-500:]
            return {"ok": False, **detail}
        detail["layouts_probed"] = summary.get("layouts_probed", 0)
        detail["parity_max_abs"] = summary.get("parity_max_abs")
        detail["best_mesh_shape"] = summary.get("best_mesh_shape")
        if summary.get("layouts_probed", 0) < 2:
            ok = False
            detail["err"] = "fewer than 2 distinct valid layouts probed"
        if float(summary.get("parity_max_abs", 1.0)) > 1e-5:
            ok = False
            detail["err"] = (f"layout parity {summary.get('parity_max_abs')}"
                             " > 1e-5")
        prior = os.path.join(tmp, "layouts.json")
        detail["prior_written"] = os.path.exists(prior)
        ok = ok and detail["prior_written"]
    return {"ok": ok, **detail}


def _write_history(root: str, values) -> None:
    now = time.time()
    for i, v in enumerate(values):
        p = os.path.join(root, f"BENCH_r{i:02d}.json")
        with open(p, "w") as f:
            json.dump({"metric": "evals/s", "value": v, "unit": "evals/s",
                       "vs_baseline": round(v / 40.0, 3)}, f)
        ts = now - (len(values) - i) * 3600
        os.utime(p, (ts, ts))


def trends_gate(cpu: bool = False) -> dict:
    """Regression-flagging self-test: an injected 30% drop in a synthetic
    10-run history must alert (rc 1 with --fail-on-alert, exactly one
    alert); the clean series must not (rc 0). Host only."""
    clean = [100.0, 101.5, 99.2, 100.8, 98.9, 101.1, 99.7, 100.4, 99.9,
             100.6]
    regressed = clean[:7] + [70.0, 69.5, 70.3]
    detail = {}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, series, want_rc in (("clean", clean, 0),
                                      ("regressed", regressed, 1)):
            root = os.path.join(tmp, name)
            os.makedirs(root)
            _write_history(root, series)
            proc = _run(cli("trends", root, "--metric", "evals_per_sec",
                            "--fail-on-alert"), 300)
            detail[f"{name}_rc"] = proc.returncode
            if proc.returncode != want_rc:
                ok = False
                detail[f"{name}_err"] = _tail(proc)
            if name == "regressed":
                n = (proc.stdout or "").count("ALERT")
                detail["alerts"] = n
                ok = ok and n == 1
    return {"ok": ok, **detail}


#: a test file that needs JAX, fks_tpu or another test module
_NEEDS_REFERENCE = re.compile(r"^\s*(import|from)\s+(jax|fks_tpu|tests)\b",
                              re.M)
_GPU_MARK = re.compile(r"pytest\.mark\.gpu\b")


def test_files(cpu: bool) -> List[str]:
    """The port's test files the pytest step runs: with ``cpu`` every
    ``tests/test_torch_*.py``; on the card those holding gpu-marked
    tests that collect without the reference (no import of jax, fks_tpu
    or another test module, which the card's machine may lack or
    shadow)."""
    names = sorted(f for f in os.listdir(os.path.join(REPO, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    if cpu:
        return [f"tests/{f}" for f in names]
    keep = []
    for f in names:
        with open(os.path.join(REPO, "tests", f)) as fh:
            src = fh.read()
        if _GPU_MARK.search(src) and not _NEEDS_REFERENCE.search(src):
            keep.append(f"tests/{f}")
    return keep


def pytest_command(cpu: bool) -> List[str]:
    return [sys.executable, "-m", "pytest", *test_files(cpu), "-q",
            "-p", "no:cacheprovider", "-m",
            "slow or not slow" if cpu else "gpu"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fks_tpu_torch.tools.run_full_suite",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run every gate and the tests on the CPU "
                         "(default: the card)")
    ap.add_argument("--out", default=OUT,
                    help="append the evidence row here (default "
                         "build/full_suite.jsonl; never under benchmarks/)")
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    bench = os.path.join(REPO, "benchmarks") + os.sep
    if out.startswith(bench):
        print(f"error: --out {args.out} is under benchmarks/; the port's "
              "rows go elsewhere", file=sys.stderr)
        return 2
    rev = _run(["git", "rev-parse", "--short", "HEAD"]).stdout.strip()
    gates = {}
    for name in GATES:
        t0 = time.time()
        gates[name] = globals()[name](cpu=args.cpu)
        verdict = "ok" if gates[name]["ok"] else "FAILED"
        print(f"{name}: {verdict} ({time.time() - t0:.1f} s)",
              file=sys.stderr, flush=True)
        if not gates[name]["ok"]:
            print(f"{name.replace('_', ' ').upper()} FAILED: "
                  f"{gates[name]}", file=sys.stderr)
    t0 = time.time()
    proc = _run(pytest_command(args.cpu))
    wall = round(time.time() - t0, 1)
    tail = (proc.stdout or "").strip().splitlines()[-1:]
    summary = tail[0] if tail else ""
    counts = {k: int(v) for v, k in re.findall(
        r"(\d+) (passed|failed|error|skipped|deselected|xfailed)", summary)}
    gates_ok = all(g["ok"] for g in gates.values())
    rc = proc.returncode if gates_ok else (proc.returncode or 1)
    row = {"ts": round(time.time(), 1), "rev": rev, "rc": rc,
           "wall_s": wall, **counts, **gates, "summary": summary}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row))
    sys.stderr.write((proc.stdout or "")[-2000:])
    return rc


if __name__ == "__main__":
    sys.exit(main())
