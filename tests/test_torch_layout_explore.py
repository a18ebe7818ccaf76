"""The layout explorer and the layout roll-up: the port's
(fks_tpu_torch.obs.layout, ``cli layout --explore``) against fks_tpu's.

- ``valid_layouts`` equals fks_tpu's for device and scenario counts.
- ``rollup_layouts`` equals fks_tpu's on its own test rows, with and
  without footprints.
- ``explore_layouts`` on fks_tpu's CLI workload (``synthetic_workload(16,
  32, seed=0)``, ``default8``, pop 64, the flat engine) over 8 logical CPU
  shards (fks_tpu: its 8 virtual CPU devices), with fks_tpu's population
  draw patched into the port's ``parametric.init_population`` (as
  tests/test_torch_cli.py does for ``scale``): the probes' layout keys,
  mesh shapes, shard counts, pad waste and ``parity_max_abs`` equal
  fks_tpu's, and each layout's robust scores equal fks_tpu's within 2e-6
  (the flat-vs-fused bar of tests/test_fused.py) with the elite indices
  exact. The timing verdicts (``default_dominated``, ``layout``'s exit
  1) depend on the clock and are held only to their own rule.
- The layout prior lands in the temporary history root only:
  ``benchmarks/results/layouts.json`` is unchanged.
"""
import contextlib
import hashlib
import io
import json
import pathlib

import jax
import numpy as np
import pytest

import fks_tpu.obs.layout as fk_layout
import fks_tpu.scenarios.robust as fk_robust
import fks_tpu_torch.cli as pt_cli
import fks_tpu_torch.obs.layout as pt_layout
import fks_tpu_torch.scenarios.robust as pt_robust
from fks_tpu.data.synthetic import synthetic_workload as fk_synthetic
from fks_tpu.models import parametric as fk_parametric
from fks_tpu.obs.history import RunHistory as FkHistory
from fks_tpu.scenarios import get_suite as fk_get_suite
from fks_tpu_torch import convert
from fks_tpu_torch.data.synthetic import synthetic_workload as pt_synthetic
from fks_tpu_torch.models import parametric as pt_parametric
from fks_tpu_torch.obs.history import RunHistory as PtHistory
from fks_tpu_torch.scenarios import get_suite as pt_get_suite

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 2e-6
PRIORS = ROOT / "benchmarks" / "results" / "layouts.json"


def run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


@pytest.mark.parametrize("ndev,scn", [(8, 8), (8, 3), (4, 8), (1, 8),
                                      (6, 4), (12, 6), (2, 1), (5, 5)])
def test_valid_layouts_equal(ndev, scn):
    def plain(rows):
        return [{**r, "spec": r["spec"].key} for r in rows]

    assert plain(pt_layout.valid_layouts(ndev, scn)) == \
        plain(fk_layout.valid_layouts(ndev, scn))


def test_valid_layouts_refuses_no_devices():
    for mod in (fk_layout, pt_layout):
        with pytest.raises(ValueError, match="num_devices 0 < 1"):
            mod.valid_layouts(0, 8)


ROLLUP_ROWS = [
    {"component": "eval", "layout_key": "shard[candidates]|vmap[candidates]"
     "|seg=0", "mesh_layout": "pop=8", "workload_key": "w",
     "real_count": 6, "padded_count": 8, "pad_waste_fraction": 0.25,
     "real_lane_steps": 6, "launched_lane_steps": 8,
     "steady_seconds": 0.5, "compile_seconds": 2.0},
    {"component": "probe", "layout_key": "shard[candidates]|vmap["
     "candidates]|seg=0", "mesh_layout": "pop=8", "workload_key": "w",
     "real_count": 8, "padded_count": 8, "pad_waste_fraction": 0.0,
     "real_lane_steps": 8, "launched_lane_steps": 8,
     "steady_seconds": 0.25, "compile_seconds": 3.0,
     "cost_bytes_accessed": 1e6},
    {"component": "serve", "layout_key": "shard[candidates]|vmap["
     "candidates]|seg=0", "mesh_layout": "pop=4", "workload_key": "w"},
    {"component": "suite_eval", "layout_key": "shard[candidates,scenarios]"
     "|vmap[candidates,scenarios]|seg=0", "mesh_layout": "pop=2,scn=4",
     "workload_key": "v", "collective_bytes": 512.0},
]
FEET = [{"mesh_layout": "pop=8", "total_bytes": 1000},
        {"mesh_layout": "pop=8", "total_bytes": 4000},
        {"mesh_layout": "pop=2", "total_bytes": 9000}]


@pytest.mark.parametrize("feet", [FEET, [], None], ids=["feet", "none",
                                                        "ledger"])
def test_rollup_layouts_equal(feet):
    if feet is None:  # each package's empty process ledger
        assert pt_layout.rollup_layouts(ROLLUP_ROWS) == \
            fk_layout.rollup_layouts(ROLLUP_ROWS, footprints=[])
        return
    got = pt_layout.rollup_layouts(ROLLUP_ROWS, footprints=feet)
    assert got == fk_layout.rollup_layouts(ROLLUP_ROWS, footprints=feet)
    assert len(got) == 3


@pytest.fixture
def same_population(monkeypatch):
    """The port's ``init_population`` returns fks_tpu's draw for the
    generator's seed."""
    def draw(gen, pop, noise=0.1):
        w = fk_parametric.init_population(
            jax.random.PRNGKey(gen.initial_seed()), pop, noise=noise)
        return convert.params_from_numpy(np.asarray(w), device=gen.device)

    monkeypatch.setattr(pt_parametric, "init_population", draw)


def spy_suite_evals(monkeypatch, mod, calls):
    """Record each sharded suite eval's (robust, elite_idx) per call."""
    real = mod.make_sharded_suite_eval

    def make(*args, **kw):
        ev = real(*args, **kw)

        def run_ev(params, real_count=None):
            out = ev(params, real_count)
            calls.append((np.asarray(out[0])[:real_count].astype(np.float64),
                          np.asarray(out[2]).astype(np.int64)))
            return out
        return run_ev

    monkeypatch.setattr(mod, "make_sharded_suite_eval", make)


@pytest.fixture(scope="module")
def fk_explore(tmp_path_factory):
    """fks_tpu's explorer on its 8 virtual devices, recorded once."""
    root = tmp_path_factory.mktemp("fk_history")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        spy_suite_evals(mp, fk_robust, calls)
        suite = fk_get_suite("default8", fk_synthetic(16, 32, seed=0))
        summary = fk_layout.explore_layouts(
            suite, population=64, engine="flat", reps=1,
            history=FkHistory(str(root)), workload_key="pop64_default8")
    return summary, calls, root


def test_explore_on_8_cpu_shards_equals_fks_tpu(fk_explore, same_population,
                                               monkeypatch, tmp_path):
    want, want_calls, fk_root = fk_explore
    before = digest(PRIORS)
    calls = []
    spy_suite_evals(monkeypatch, pt_robust, calls)
    suite = pt_get_suite("default8", pt_synthetic(16, 32, seed=0))
    got = pt_layout.explore_layouts(
        suite, devices=["cpu"] * 8, population=64, engine="flat", reps=1,
        history=PtHistory(str(tmp_path)), workload_key="pop64_default8")
    assert sorted(got) == sorted(want)
    fixed = ("layout_key", "mesh_shape", "workload_key", "axes",
             "candidates", "scenarios", "candidate_shards",
             "scenario_shards", "pad_waste_fraction", "parity_max_abs")
    assert [sorted(p) for p in got["probes"]] == \
        [sorted(p) for p in want["probes"]]
    assert [{k: p[k] for k in fixed} for p in got["probes"]] == \
        [{k: p[k] for k in fixed} for p in want["probes"]]
    for k in ("workload_key", "devices", "candidates", "scenarios",
              "layouts_probed", "default_layout_key",
              "layout_pad_waste_frac", "parity_max_abs"):
        assert got[k] == want[k], k
    assert got["layouts_probed"] == 4 and got["parity_max_abs"] == 0.0
    # each layout's robust scores (its two calls) and elites
    assert len(calls) == len(want_calls) == 8
    for (r, e), (wr, we) in zip(calls, want_calls):
        np.testing.assert_allclose(r, wr, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(e, we)
    # the priors: one record each, under the temporary roots only
    assert sorted(p.name for p in tmp_path.iterdir()) == ["layouts.json"]
    prior = PtHistory(str(tmp_path)).layout_prior("pop64_default8", "8")
    assert prior["layout_key"] == got["best_layout_key"]
    assert sorted(prior) == sorted(
        FkHistory(str(fk_root)).layout_prior("pop64_default8", "8"))
    assert digest(PRIORS) == before


def test_explore_records_probe_metrics(same_population, tmp_path):
    class Rec:
        enabled = True

        def __init__(self):
            self.metrics = []

        def metric(self, kind, *dicts, **fields):
            row = {"kind": kind}
            for d in dicts:
                row.update(d)
            row.update(fields)
            self.metrics.append(row)

        def event(self, *a, **k):
            pass

    pt_layout.LEDGER.clear()
    rec = Rec()
    suite = pt_get_suite("smoke3", pt_synthetic(4, 12, seed=1))
    summary = pt_layout.explore_layouts(
        suite, devices=["cpu"] * 3, population=5, elite_k=2, engine="exact",
        reps=1, recorder=rec, workload_key="pop5_smoke3")
    kinds = [m["kind"] for m in rec.metrics]
    assert kinds.count("layout_probe") == summary["layouts_probed"] == 2
    assert kinds.count("layout_ledger") >= 2
    assert [p["mesh_shape"] for p in summary["probes"]] == ["3x1", "1x3"]
    assert summary["probes"][0]["pad_waste_fraction"] == pytest.approx(1 / 6)
    assert summary["parity_max_abs"] == 0.0
    assert summary["default_dominated"] == (
        summary["best_layout_key"] != summary["default_layout_key"]
        and summary["layout_best_over_default"] > 1.05)
    assert list(tmp_path.iterdir()) == []  # no history: nothing written
    pt_layout.LEDGER.clear()


@pytest.mark.parametrize("via_env", [False, True], ids=["flag", "env"])
def test_cli_explore_writes_only_the_given_root(via_env, monkeypatch,
                                                tmp_path):
    before = digest(PRIORS)
    root = tmp_path / "hist"
    root.mkdir()
    argv = ["layout", "--explore", "--cpu", "--devices", "3", "--pop", "8",
            "--suite", "smoke3", "--engine", "flat"]
    if via_env:
        monkeypatch.setenv("FKS_BENCH_RESULTS_DIR", str(root))
    else:
        argv += ["--history-root", str(root)]
    rc, out, err = run(pt_cli, argv)
    summary = json.loads(out)
    assert rc == (1 if summary["chosen_dominated"] else 0)
    assert summary["devices"] == 3 and summary["layouts_probed"] == 2
    assert summary["chosen_layout_key"] == summary["default_layout_key"]
    assert summary["parity_max_abs"] == 0.0
    assert sorted(p.name for p in root.iterdir()) == ["layouts.json"]
    assert PtHistory(str(root)).layout_prior("pop8_smoke3", "3") is not None
    assert digest(PRIORS) == before


def test_cli_explore_mesh_shape(tmp_path):
    base = ["layout", "--explore", "--cpu", "--devices", "2", "--pop", "4",
            "--suite", "smoke3", "--history-root", str(tmp_path / "none")]
    rc, out, err = run(pt_cli, base + ["--mesh-shape", "3x3"])
    assert rc == 2 and "not among the valid layouts ['2x1']" in err
    rc, out, _ = run(pt_cli, base + ["--mesh-shape", "2x1"])
    assert rc == 0 and json.loads(out)["chosen_dominated"] is False
    assert not (tmp_path / "none").exists()
