"""The port's run commands (fks_tpu_torch.cli) against fks_tpu's, on the CPU.

Both CLIs read the micro workload (tests/conftest.py, 2 nodes x 6 pods):
their ``_parse_workload`` is patched, as fks_tpu's tests/test_cli.py does.
Each case runs the same argv through both and compares what a user sees:

- ``bench``, ``simulate`` and ``evolve --fake-llm`` (with ``--checkpoint``,
  ``--wal`` and ``--out``): the printed table or JSON and the
  ``--metrics`` rows, without wall times, rates and timestamps;
- ``scale``: fed fks_tpu's population (its ``jax.random`` draw,
  converted with ``convert.params_from_numpy`` and patched into the
  port's ``parametric.init_population``; the port draws from a
  ``torch.Generator`` otherwise), on 8 shards on both sides (fks_tpu's 8
  virtual CPU devices, the port's ``--devices 8``): scores, node and pod
  counts, the prefilter fields and the ``--code-pop`` fields;
- ``scenarios``, ``traces`` and ``trace-diff`` (its exit codes 0, 1, 2),
  ``loadgen``'s summary keys, the exit codes 2, 3 and 4 of ``evolve``,
  ``bench`` and ``scale``, a bad ``--metrics`` path failing fast, and
  ``_divergence_bound``;
- every subcommand parses the same argv in both packages (the port adds
  ``--device``).

Floats of the float32 evaluator are held within 2e-6 (the bar the port's
engine tests hold against fks_tpu in float32); on these inputs they are
equal. ``mem`` is in tests/test_torch_memory.py.
"""
import contextlib
import hashlib
import io
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import fks_tpu.cli as fk_cli
import fks_tpu_torch.cli as pt_cli
from fks_tpu.models import parametric as jax_parametric
from fks_tpu_torch import convert
from fks_tpu_torch.models import parametric
from fks_tpu_torch.testing import port_workload

TOL = 2e-6
#: fields that hold a wall time, a rate or a timestamp
TIMED = {"ts", "wall_s", "evals_per_sec", "code_wall_s",
         "code_evals_per_sec", "eval_seconds", "llm_seconds",
         "budget_device_seconds", "device_seconds", "seconds"}


@pytest.fixture
def both(monkeypatch, micro_workload):
    """Both CLIs read the micro workload."""
    monkeypatch.setattr(fk_cli, "_parse_workload",
                        lambda args: ("micro", micro_workload))
    monkeypatch.setattr(pt_cli, "_parse_workload",
                        lambda args: port_workload(micro_workload))


def run(cli, argv):
    """(exit code, stdout, stderr) of ``cli.main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def untimed(row):
    return {k: v for k, v in row.items() if k not in TIMED}


def close(got, want, where=""):
    """Equal, floats within TOL, through dicts and lists."""
    if isinstance(want, float) and isinstance(got, float):
        assert abs(got - want) <= TOL, (where, got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            close(a, b, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def table(stdout):
    """The bench table's rows without the wall_s column."""
    lines = stdout.strip().splitlines()
    cols = lines[0].split()
    keep = [i for i, c in enumerate(cols) if c != "wall_s"]
    return [[r.split()[i] for i in keep] for r in [lines[0]] + lines[2:]]


# ------------------------------------------------------------- parsing

ARGVS = [
    ["bench", "--policies", "best_fit", "--f64", "--validate", "--engine",
     "flat", "--metrics", "m.jsonl", "--run-dir", "r", "--cpu"],
    ["simulate", "--policy", "first_fit", "--trace", "t.csv", "--nodes",
     "n.csv", "--f64"],
    ["evolve", "--config", "c.json", "--fake-llm", "--checkpoint", "ck",
     "--wal", "w", "--out", "o", "--generations", "3",
     "--parametric-rounds", "1", "--watchdog", "--parity-sample", "2",
     "--parity-tol", "0.1", "--suite", "default8", "--robust-agg", "cvar",
     "--budget", "halving", "--budget-eta", "3", "--probe-suite", "smoke3",
     "--probe-steps", "64", "--profile", "--engine", "flat"],
    ["scale", "--nodes", "16", "--pods", "300", "--pop", "4", "--seed",
     "2", "--prefilter-k", "8", "--state-pack", "--openb-nodes",
     "--code-pop", "2", "--devices", "2", "--engine", "fused"],
    ["serve", "--metrics", "m.jsonl", "--cpu", "--champion", "c.json",
     "--serve-engine", "vm", "--max-pods", "16", "--selftest", "4",
     "--follow-ledger", "--drain-state", "s.json", "--accounting"],
    ["loadgen", "--tenants", "a:closed:1", "--duration", "1", "--http",
     "--max-pods", "8", "--slo-p99-ms", "0", "--metrics", "m.jsonl"],
    ["portfolio", "--metrics", "m.jsonl", "--cpu", "--devices", "2",
     "--pin", "vip=1", "--ab", "0=0.5", "--selftest", "4"],
    ["pipeline", "--metrics", "m.jsonl", "--drill", "--only", "wal",
     "--engine", "flat"],
    ["trace-diff", "--engines", "exact,exact", "--policy", "first_fit",
     "--suite", "smoke3", "--scenario", "1", "--max-steps", "9", "--tol",
     "0.1", "--cpu", "--run-dir", "r"],
    ["scenarios", "--suite", "default8", "--scenario", "5", "--metrics",
     "m.jsonl"],
    ["mem", "--drill", "vm_swap_leak", "--swaps", "3", "--batches", "6",
     "--devices", "8", "--cpu"],
    ["mem", "--sample", "--run-dir", "r"],
    ["traces"],
    ["report", "d"],
    ["export-metrics", "d", "--out", "o.prom"],
    ["watch", "d", "--interval", "2", "--once"],
    ["spans", "d", "--trace", "t", "--slowest", "3", "--check-complete",
     "--critical-path", "--min-fraction", "0.9"],
    ["compare", "auto", "c", "--threshold", "best_score=abs:0.1",
     "--history-root", "h"],
    ["trends", "h", "--metric", "serve_qps", "--window", "3", "--z", "2.5",
     "--fail-on-alert", "--write-index", "--run-dir", "r"],
    ["lint", "a.py", "b", "--pins", "p.json", "--write-pins", "--no-pins",
     "--cpu", "--run-dir", "r"],
    ["layout", "--explore", "--cpu", "--devices", "8", "--pop", "8",
     "--suite", "smoke3", "--mesh-shape", "4x2", "--seed", "1",
     "--history-root", "h", "--engine", "flat", "--metrics", "m.jsonl"],
    ["layout", "--run-dir", "r"],
]


def test_the_port_registers_every_subcommand():
    def names(cli):
        ap = cli.build_parser() if hasattr(cli, "build_parser") else None
        if ap is None:  # fks_tpu builds its parser inside main
            grabbed = {}

            class Stop(Exception):
                pass

            real = fk_cli.argparse.ArgumentParser.parse_args

            def grab(self, argv=None, namespace=None):
                grabbed["ap"] = self
                raise Stop

            fk_cli.argparse.ArgumentParser.parse_args = grab
            try:
                cli.main([])
            except Stop:
                pass
            finally:
                fk_cli.argparse.ArgumentParser.parse_args = real
            ap = grabbed["ap"]
        (sub,) = [a for a in ap._actions
                  if a.__class__.__name__ == "_SubParsersAction"]
        return set(sub.choices)

    want = names(fk_cli)
    assert len(want) == 20
    assert names(pt_cli) == want


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "-".join(a[:2]))
def test_subcommands_parse_fks_tpu_argv(argv, monkeypatch):
    """The same argv parses to the same namespace in both packages (each
    command function swapped for one that returns its arguments); the
    port adds ``--device`` and nothing else."""
    def grab(args):
        return {k: v for k, v in vars(args).items() if k != "fn"}

    for cli in (fk_cli, pt_cli):
        for name in dir(cli):
            if name.startswith("cmd_"):
                monkeypatch.setattr(cli, name, grab)
    want = fk_cli.main(argv)
    got = pt_cli.main(argv)
    assert got.pop("device", "cuda") == "cuda"
    assert got == want


def test_fused_engine_only_on_scale(capsys):
    for cli in (fk_cli, pt_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(["bench", "--engine", "fused"])
        assert e.value.code == 2
    assert "applies to the 'scale' command" in capsys.readouterr().err


def test_commands_run_on_the_card_unless_asked(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_cli.main(["simulate"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_cli.main(["scale", "--nodes-count", "8", "--pods-count", "16"])


# ------------------------------------------------------ bench, simulate

@pytest.mark.parametrize("extra", [[], ["--f64"], ["--engine", "flat"]],
                         ids=["f32", "f64", "flat"])
def test_bench_table_and_metrics_equal(both, tmp_path, extra):
    rows = {}
    for tag, cli in (("fk", fk_cli), ("pt", pt_cli)):
        m = tmp_path / f"{tag}.jsonl"
        rc, out, _ = run(cli, ["bench", "--cpu", "--policies",
                               "best_fit,first_fit,funsearch_4901",
                               "--metrics", str(m)] + extra)
        assert rc == 0
        rows[tag] = (table(out), [untimed(r) for r in jsonl(m)])
    assert rows["pt"][0] == rows["fk"][0]
    close(rows["pt"][1], rows["fk"][1])
    assert [r["policy"] for r in rows["pt"][1]] == [
        "best_fit", "first_fit", "funsearch_4901"]


@pytest.mark.parametrize("extra", [[], ["--f64", "--validate"],
                                   ["--engine", "flat", "--policy",
                                    "first_fit"]],
                         ids=["f32", "f64", "flat"])
def test_simulate_json_and_metrics_equal(both, tmp_path, extra):
    got = {}
    for tag, cli in (("fk", fk_cli), ("pt", pt_cli)):
        m = tmp_path / f"{tag}.jsonl"
        rc, out, _ = run(cli, ["simulate", "--cpu", "--metrics", str(m)]
                         + extra)
        assert rc == 0
        got[tag] = (untimed(json.loads(out)), [untimed(r)
                                               for r in jsonl(m)])
    close(got["pt"], got["fk"])
    assert got["pt"][1][0]["kind"] == "simulate"


def test_bench_unknown_policy_exits_2(both):
    for cli in (fk_cli, pt_cli):
        assert run(cli, ["bench", "--cpu", "--policies", "nope"])[0] == 2


def test_metrics_bad_path_fails_fast(both, tmp_path):
    # a directory cannot be opened for appending: it fails before any work
    for cli in (fk_cli, pt_cli):
        with pytest.raises(OSError):
            cli.main(["simulate", "--cpu", "--metrics", str(tmp_path)])


# --------------------------------------------------------------- evolve

def no_timestamps(doc):
    """A champion file (one entry, or the top-K list) without its
    timestamps."""
    if isinstance(doc, list):
        return [no_timestamps(e) for e in doc]
    return {k: v for k, v in doc.items() if k != "timestamp"}


def _evolve(cli, tmp_path, tag, extra=()):
    d = tmp_path / tag
    argv = ["evolve", "--cpu", "--fake-llm", "--generations", "2",
            "--engine", "exact", "--checkpoint", str(d / "ck.json"),
            "--wal", str(d / "wal.jsonl"), "--out", str(d / "out"),
            "--metrics", str(d / "m.jsonl"), *extra]
    rc, out, _ = run(cli, argv)
    best = [ln for ln in out.splitlines() if ln.startswith("best fitness")]
    ck = json.loads((d / "ck.json").read_text())
    champs = sorted((no_timestamps(json.loads(p.read_text()))
                     for p in (d / "out").glob("*.json")), key=json.dumps)
    return rc, {"best": best,
                "generations": [untimed(r) for r in jsonl(d / "m.jsonl")],
                "population": ck["population"], "ck_best": ck["best"],
                "generation": ck["generation"], "champions": champs,
                "wal_records": len((d / "wal.jsonl").read_text()
                                   .splitlines())}


def test_evolve_fake_llm_equal(both, tmp_path):
    rc_f, want = _evolve(fk_cli, tmp_path, "fk")
    rc_p, got = _evolve(pt_cli, tmp_path, "pt")
    assert rc_f == rc_p == 0
    close(got, want)
    assert [g["generation"] for g in got["generations"]] == [1, 2]
    assert got["best"] and got["champions"]
    # resume: the same checkpoint, a deeper horizon continues at 3
    argv = ["evolve", "--cpu", "--fake-llm", "--generations", "3",
            "--checkpoint", str(tmp_path / "pt" / "ck.json"), "--metrics",
            str(tmp_path / "m2.jsonl")]
    assert run(pt_cli, argv)[0] == 0
    assert [r["generation"] for r in jsonl(tmp_path / "m2.jsonl")] == [3]


def test_evolve_exit_codes_2_3_4(both, tmp_path, monkeypatch):
    # 2: no API key and no --fake-llm
    for cli in (fk_cli, pt_cli):
        assert run(cli, ["evolve", "--cpu"])[0] == 2
    # 3: a parity alert (a negative tolerance alerts on every sample)
    for tag, cli in (("fk", fk_cli), ("pt", pt_cli)):
        rc, _, err = run(cli, ["evolve", "--cpu", "--fake-llm",
                               "--generations", "1", "--parity-sample", "2",
                               "--parity-tol", "-1", "--out",
                               str(tmp_path / tag)])
        assert rc == 3 and "PARITY ALERT" in err

    # 4: the LLM-outage circuit breaker (every completion raises)
    class Dead:
        def __init__(self, seed=0):
            pass

        def complete(self, prompt):
            raise RuntimeError("endpoint down")

    import fks_tpu.funsearch as jax_funsearch
    import fks_tpu_torch.funsearch as pt_funsearch
    monkeypatch.setattr(jax_funsearch, "FakeLLM", Dead)
    monkeypatch.setattr(pt_funsearch, "FakeLLM", Dead)
    for cli in (fk_cli, pt_cli):
        rc, _, err = run(cli, ["evolve", "--cpu", "--fake-llm",
                               "--generations", "6"])
        assert rc == 4 and "LLM OUTAGE: halted at generation 3" in err


def test_evolve_flat_prints_the_divergence_note(both):
    for cli in (fk_cli, pt_cli):
        rc, _, err = run(cli, ["evolve", "--cpu", "--fake-llm",
                               "--generations", "1", "--engine", "flat"])
        assert rc == 0 and "flat-vs-exact drift on " \
            "openb_pod_list_default.csv" in err


def test_divergence_bound_reads_latest_row(tmp_path):
    p = tmp_path / "audit.jsonl"
    rows = [{"trace": "t.csv", "max_abs_d": 0.01},
            {"trace": "casc.csv", "max_abs_d": 0.43, "max_drift": 0.008,
             "flat_cascades": 1},
            {"trace": "t.csv", "max_abs_d": 0.02},  # latest t.csv row wins
            {"trace": "t.csv", "error": "boom"}]  # error rows are skipped
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    for trace in ("t.csv", "casc.csv", "missing.csv"):
        assert pt_cli._divergence_bound(trace, str(p)) == \
            fk_cli._divergence_bound(trace, str(p))
    assert pt_cli._divergence_bound("t.csv", str(p)) == (0.02, 0)
    assert pt_cli._divergence_bound("casc.csv", str(p)) == (0.008, 1)
    assert pt_cli._divergence_bound("t.csv", str(tmp_path / "no")) is None
    # the default path is the repository's audit file in both packages
    assert pt_cli._divergence_bound("openb_pod_list_default.csv") == \
        fk_cli._divergence_bound("openb_pod_list_default.csv")


# ---------------------------------------------------------------- scale

@pytest.fixture
def same_population(monkeypatch):
    """The port's ``init_population`` returns fks_tpu's draw for the
    generator's seed."""
    def draw(gen, pop, noise=0.1):
        w = jax_parametric.init_population(
            jax.random.PRNGKey(gen.initial_seed()), pop, noise=noise)
        return convert.params_from_numpy(np.asarray(w),
                                         device=gen.device)

    monkeypatch.setattr(parametric, "init_population", draw)


@pytest.mark.parametrize("extra", [
    ["--nodes-count", "8", "--pods-count", "80", "--pop", "5"],
    ["--nodes-count", "16", "--pods-count", "60", "--pop", "3",
     "--engine", "flat", "--prefilter-k", "4", "--state-pack"],
    ["--nodes-count", "8", "--pods-count", "16", "--pop", "2",
     "--engine", "flat", "--code-pop", "2"],
    ["--nodes-count", "8", "--pods-count", "40", "--pop", "4",
     "--engine", "fused"],
], ids=["exact", "flat-prefilter", "code-pop", "fused"])
def test_scale_equal_on_the_same_population(same_population, tmp_path,
                                            extra):
    got = {}
    for tag, cli, mesh in (("fk", fk_cli, []),
                           ("pt", pt_cli, ["--devices", "8"])):
        m = tmp_path / f"{tag}.jsonl"
        rc, out, _ = run(cli, ["scale", "--cpu", "--seed", "1",
                               "--metrics", str(m)] + extra + mesh)
        assert rc == 0
        got[tag] = (untimed(json.loads(out)), untimed(jsonl(m)[-1]))
    close(got["pt"], got["fk"])
    assert got["pt"][0]["mode"] == "sharded over 8 devices"


def test_scale_on_one_device_and_the_run_dir(same_population, tmp_path):
    run_dir = tmp_path / "run"
    rc, out, _ = run(pt_cli, ["scale", "--cpu", "--nodes-count", "8",
                              "--pods-count", "80", "--pop", "5", "--seed",
                              "1", "--run-dir", str(run_dir)])
    assert rc == 0
    one = json.loads(out)
    assert one["mode"] == "vmap on 1 device" and one["evals_per_sec"] > 0
    # fks_tpu's mesh run and the port's single-device run score alike
    rc, out, _ = run(fk_cli, ["scale", "--cpu", "--nodes-count", "8",
                              "--pods-count", "80", "--pop", "5", "--seed",
                              "1"])
    want = json.loads(out)
    for k in ("score_min", "score_max", "nodes", "pods", "population"):
        assert one[k] == want[k], k
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["kind"] == "scale"
    # a mesh run records its pad lanes: pop 5 on 8 shards pads 3
    run_dir = tmp_path / "mesh"
    assert run(pt_cli, ["scale", "--cpu", "--devices", "8",
                        "--nodes-count", "8", "--pods-count", "80", "--pop",
                        "5", "--seed", "1", "--run-dir",
                        str(run_dir)])[0] == 0
    mesh = [json.loads(line) for line in
            (run_dir / "events.jsonl").read_text().splitlines()
            if json.loads(line)["kind"] == "mesh"]
    assert mesh[0]["shards"] == 8 and mesh[0]["pad_lanes"] == 3


def test_scale_fused_guard_exits_2_with_guidance():
    for cli, mesh in ((fk_cli, []), (pt_cli, ["--devices", "8"])):
        rc, _, err = run(cli, ["scale", "--cpu", "--nodes-count", "8",
                               "--pods-count", "16", "--pop", "2",
                               "--engine", "fused", "--prefilter-k", "4"]
                         + mesh)
        assert rc == 2
        assert "node_prefilter_k" in err and "--engine flat" in err


def test_scale_draws_from_a_torch_generator():
    """Without the patch the port's population is its own seeded draw:
    the same seed gives the same scores, another seed other weights."""
    a = parametric.init_population(torch.Generator().manual_seed(1), 32)
    b = parametric.init_population(torch.Generator().manual_seed(1), 32)
    c = parametric.init_population(torch.Generator().manual_seed(2), 32)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------------- scenarios and traces

@pytest.mark.parametrize("argv", [
    ["scenarios"],
    ["scenarios", "--suite", "smoke3"],
    ["scenarios", "--suite", "default8", "--scenario", "5"],
], ids=["list", "suite", "timeline"])
def test_scenarios_equal(both, argv):
    rc_f, want, _ = run(fk_cli, argv + ["--cpu"])
    rc_p, got, _ = run(pt_cli, argv + ["--cpu"])
    assert rc_f == rc_p == 0
    assert json.loads(got) == json.loads(want)


def test_scenarios_errors_exit_2(both):
    for cli in (fk_cli, pt_cli):
        assert run(cli, ["scenarios", "--cpu", "--suite", "nope"])[0] == 2
        assert run(cli, ["scenarios", "--cpu", "--suite", "smoke3",
                         "--scenario", "9"])[0] == 2


def test_traces_equal():
    assert run(pt_cli, ["traces"]) == run(fk_cli, ["traces"])


# ----------------------------------------------------------- trace-diff

def test_trace_diff_exit_codes(both, tmp_path, monkeypatch):
    # 0: no divergence, the same text
    for tag, cli in (("fk", fk_cli), ("pt", pt_cli)):
        rc, out, _ = run(cli, ["trace-diff", "--cpu", "--engines",
                               "exact,flat", "--policy", "first_fit",
                               "--run-dir", str(tmp_path / tag)])
        assert rc == 0 and "no divergence" in out
    # 2: usage errors
    for cli in (fk_cli, pt_cli):
        for bad in (["--engines", "exact"], ["--engines", "exact,fused"],
                    ["--policy", "nope"], ["--code", "/nonexistent.py"],
                    ["--scenario", "99"]):
            assert run(cli, ["trace-diff", "--cpu"] + bad)[0] == 2, bad
    # 1: a divergence (the record as trace_diff would return it)
    row = dict(step=1, kind="CREATE", pod=0, node=1, pending=0,
               free_cpu=10, free_mem=10, free_gpu=0, free_gpu_milli=0,
               score=1.0, margin=0.5)
    fake = {"engines": ["exact", "flat"], "label": "first_fit",
            "steps": {"exact": 2, "flat": 2},
            "scores": {"exact": 0.5, "flat": 0.4}, "score_tol": 1e-5,
            "divergent": True,
            "first_divergence": {"step": 1, "field": "node",
                                 "a": dict(row, node=1),
                                 "b": dict(row, node=0)}}
    from fks_tpu.obs import tracing as jax_tracing
    from fks_tpu_torch.obs import tracing
    monkeypatch.setattr(jax_tracing, "trace_diff", lambda *a, **k: fake)
    monkeypatch.setattr(tracing, "trace_diff", lambda *a, **k: fake)
    outs = []
    for cli in (fk_cli, pt_cli):
        rc, out, _ = run(cli, ["trace-diff", "--cpu"])
        assert rc == 1 and "FIRST DIVERGENCE" in out
        outs.append(out)
    assert outs[0] == outs[1]


def test_trace_diff_on_a_fault_scenario_equal(both):
    outs = [run(cli, ["trace-diff", "--cpu", "--suite", "default8",
                      "--scenario", "5"]) for cli in (fk_cli, pt_cli)]
    assert outs[0][0] == outs[1][0] == 0
    assert outs[0][1] == outs[1][1]


# -------------------------------------------------------------- loadgen

def test_loadgen_summary_keys_equal():
    argv = ["loadgen", "--cpu", "--duration", "0.5", "--tenants",
            "a:closed:1,b:open:20"]
    rc_f, want, _ = run(fk_cli, argv)
    rc_p, got, _ = run(pt_cli, argv)
    assert rc_f == rc_p == 0
    want, got = json.loads(want), json.loads(got)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    assert keys(got) == keys(want)
    for k in ("loadgen_qps", "loadgen_p99_ms", "loadgen_shed_rate",
              "loadgen_fairness_index"):
        assert k in got
    assert run(pt_cli, ["loadgen", "--cpu", "--tenants", "a:nope"])[0] == 2


# -------------------------------------- the evolve pins of chip_smoke.py

CLI_PINS = (pathlib.Path(__file__).resolve().parent / "fixtures"
            / "evolve_cli_prefix256_pins.json")
#: ``evolve --config``'s file (the reference format): phase 11 (a)'s
#: loop but for the seed, which the format does not carry (0, not 7)
CLI_EVOLVE_CONFIG = {"funsearch": {
    "population_size": 8, "generations": 2, "elite_size": 2,
    "max_workers": 1, "early_stop_threshold": 1.1}}
#: GenerationStats fields that hold times
GEN_TIMES = ("eval_seconds", "llm_seconds", "budget_device_seconds")


def sha(code):
    from fks_tpu_torch.funsearch.transpiler import canonical_key

    return hashlib.sha1(canonical_key(code).encode()).hexdigest()


def cli_evolve_pins(cli, argv_extra, work) -> dict:
    """Run ``cli evolve --fake-llm --config C --checkpoint --metrics`` (the
    workload as the caller patched it) and return its pins: the
    generation rows without ``ts``, ``kind`` and times, the final
    population and best as [sha1 of the canonical key, score]."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "config.json").write_text(json.dumps(CLI_EVOLVE_CONFIG))
    rc, _, _ = run(cli, ["evolve", "--fake-llm", "--config",
                         str(work / "config.json"), "--checkpoint",
                         str(work / "ck.json"), "--metrics",
                         str(work / "m.jsonl")] + argv_extra)
    assert rc == 0
    ck = json.loads((work / "ck.json").read_text())
    return {
        "generations": [
            {k: v for k, v in r.items()
             if k not in GEN_TIMES + ("ts", "kind")}
            for r in jsonl(work / "m.jsonl")],
        "population": [[sha(m["code"]), m["score"]]
                       for m in ck["population"]],
        "best": [sha(ck["best"]["code"]), ck["best"]["score"]],
    }


def fks_tpu_cli_evolve_pins(work, pods: int = 256) -> dict:
    """tests/fixtures/evolve_cli_prefix256_pins.json from fks_tpu's CLI on
    the CPU: ``evolve --fake-llm --config C`` with its workload the
    default cluster and the first ``pods`` pods of
    openb_pod_list_default.csv (``TraceParser().parse_workload(
    max_pods=pods)`` in the port)."""
    from tests.test_torch_scale import jax_make_workload_prefix

    wl = jax_make_workload_prefix(pods)
    keep = fk_cli._parse_workload
    fk_cli._parse_workload = lambda args: ("prefix", wl)
    try:
        pins = cli_evolve_pins(fk_cli, ["--cpu"], work)
    finally:
        fk_cli._parse_workload = keep
    return {
        "about": (
            "fks_tpu's evolve pins for chip_smoke.py phase 15 (e): "
            "fks_tpu.cli evolve --fake-llm --config C (C = config below; "
            "the reference format carries no seed, so FakeLLM(seed=0); "
            "SimConfig() scores in float32) on the CPU, its workload the "
            "default cluster (16 nodes, G=8) with the first `pods` rows "
            "of openb_pod_list_default.csv. The --metrics generation rows "
            "without ts/kind/eval_seconds/llm_seconds/"
            "budget_device_seconds; the checkpoint's population and best "
            "as [sha1 of the canonical key (ast.dump), score]. Made by "
            "tests/test_torch_cli.py::fks_tpu_cli_evolve_pins and checked "
            "there by test_cli_evolve_pins_hold_on_fks_tpu."),
        "pods": pods, "config": CLI_EVOLVE_CONFIG, **pins}


@pytest.mark.slow
def test_cli_evolve_pins_hold_on_fks_tpu(tmp_path):
    """The fixture is what fks_tpu's CLI computes today (about 3
    minutes on the CPU)."""
    close(fks_tpu_cli_evolve_pins(tmp_path),
          json.loads(CLI_PINS.read_text()))


def test_cli_evolve_pins_fixture_is_well_formed():
    pins = json.loads(CLI_PINS.read_text())
    assert pins["pods"] == 256 and pins["config"] == CLI_EVOLVE_CONFIG
    assert [g["generation"] for g in pins["generations"]] == [1, 2]
    assert len(pins["population"]) <= 8
    assert pins["best"][1] == max(s for _, s in pins["population"])
    assert pins["generations"][-1]["best_score"] == pins["best"][1]


def test_evolve_profile_run_dir_like_fks_tpu(both, tmp_path):
    """``evolve --profile --run-dir``: the run dir passes the schema tool,
    the ``__total__`` record attributes the wall, and the profiled stages
    are fks_tpu's."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    try:
        import check_jsonl_schema as cjs
    finally:
        sys.path.pop(0)
    stages = {}
    for tag, cli in (("fk", fk_cli), ("pt", pt_cli)):
        run_dir = tmp_path / tag
        rc, out, _ = run(cli, ["evolve", "--cpu", "--fake-llm",
                               "--generations", "2", "--profile",
                               "--run-dir", str(run_dir)])
        assert rc == 0 and "device-time attribution" in out
        assert cjs.check_run_dir(str(run_dir))["heartbeat"] == 1
        meta = json.loads((run_dir / "meta.json").read_text())
        assert meta["command"] == "evolve" and meta["status"] == "ok"
        prof = [r for r in jsonl(run_dir / "metrics.jsonl")
                if r["kind"] == "device_profile"]
        (total,) = [r for r in prof if r["stage"] == "__total__"]
        assert 0 < total["attributed_fraction"] <= 1
        stages[tag] = sorted(r["stage"] for r in prof)
    assert stages["pt"] == stages["fk"]
    # the CPU prices no graph: the memory view says so, as fks_tpu's
    # does for a run without memory records
    rc, out, _ = run(pt_cli, ["mem", "--run-dir", str(tmp_path / "pt")])
    assert rc == 0 and out.startswith("(no memory records")


def test_trace_diff_default8_fault1_equal_and_pinned():
    """The full default trace's ``default8`` scenario 5: both packages
    print the same text and exit 1 (the flat engine's retry rule), which
    is chip_smoke.py phase 15 (f)'s ``TRACE_DIFF_FAULT1`` (about a minute:
    the port replays 8,152 pods through both engines on the CPU)."""
    import chip_smoke

    argv = ["trace-diff", "--cpu", "--suite", "default8", "--scenario", "5"]
    want = run(fk_cli, argv)
    assert want[0] == 1 and want[1] == chip_smoke.TRACE_DIFF_FAULT1
    assert run(pt_cli, argv)[:2] == want[:2]
