"""The port's champion discovery (fks_tpu_torch.tools.discover) against
fks_tpu's ``tools/discover.py``, on the CPU.

Both read ``synthetic_workload(4, 24, seed=3)`` (each package's
``TraceParser.parse_workload`` is patched to return it), both draw
fks_tpu's population: fks_tpu's ``jax.random`` initial draw and its
per-generation mutation draws (over the 8 virtual devices that
tests/conftest.py gives fks_tpu, key folded per shard) are patched into
the port's ``parametric.init_population`` and ``parametric.mutate``, as
tests/test_torch_cli.py does for ``scale``. fks_tpu's fused engine runs
in its interpret mode, the port's on its plain version. The stdout
records, the ``discover_gen`` rows, the champion file's keys and name
and the exact re-scoring agree on all three engines (floats within
1e-6). Also: ``--init-from``, ``--resume`` of the port's checkpoints and
of one fks_tpu's ``ParametricEvolution`` writes, and the two error exits.
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fks_tpu.data as fk_data
import fks_tpu_torch.data as pt_data
from fks_tpu.data.synthetic import synthetic_workload as jax_synthetic
from fks_tpu.funsearch.device_evolution import (
    ParametricEvolution as JaxParametricEvolution,
)
from fks_tpu.models import parametric as jax_parametric
from fks_tpu_torch.models import parametric
from fks_tpu_torch.testing import one_torch_thread, port_workload
from fks_tpu_torch.tools import discover

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-6
NAME = re.compile(r"^funsearch_\d{8}_\d{6}_score\d\.\d{4}\.json$")
KEYS = {"score", "generation", "code", "timestamp", "search_score",
        "engine", "weights"}
CODE_CHAMPION = (ROOT / "policies" / "discovered"
                 / "funsearch_20260801_121323_score0.4647.json")


def load_fks_tpu_discover():
    spec = importlib.util.spec_from_file_location(
        "fks_tpu_tools_discover", ROOT / "tools" / "discover.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class JaxDraws:
    """fks_tpu's draws for a seed: ``ParametricEvolution`` splits its key
    once for the initial population and once per generation, and each of
    the ``shards`` devices mutates from the generation key folded with its
    index."""

    def __init__(self, shards: int):
        self.shards = shards
        self.key = None

    def init_population(self, gen, pop, noise=0.1):
        self.key, sub = jax.random.split(jax.random.PRNGKey(
            gen.initial_seed()))
        w = jax_parametric.init_population(sub, pop, noise=noise)
        return torch.from_numpy(np.array(w)).to(gen.device)

    def mutate(self, gen, parents, pop, noise=0.05):
        self.key, sub = jax.random.split(self.key)
        elites = jnp.asarray(parents.cpu().numpy())
        local = pop // self.shards
        parts = [jax_parametric.mutate(jax.random.fold_in(sub, i), elites,
                                       local, noise)
                 for i in range(self.shards)]
        return torch.from_numpy(np.array(jnp.concatenate(parts))).to(
            parents.device)


@pytest.fixture(scope="module")
def jax_wl():
    return jax_synthetic(4, 24, seed=3)


@pytest.fixture
def same_search(monkeypatch, jax_wl):
    """Both packages read the small workload; the port draws fks_tpu's
    populations."""
    draws = JaxDraws(len(jax.devices()))
    monkeypatch.setattr(parametric, "init_population", draws.init_population)
    monkeypatch.setattr(parametric, "mutate", draws.mutate)
    pt_wl = port_workload(jax_wl)
    monkeypatch.setattr(fk_data.TraceParser, "parse_workload",
                        lambda self, *a, **k: jax_wl)
    monkeypatch.setattr(pt_data.TraceParser, "parse_workload",
                        lambda self, *a, **k: pt_wl)
    return draws


def run_port(argv):
    out, err = io.StringIO(), io.StringIO()
    with one_torch_thread(), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = discover.main(argv)
    return rc, out.getvalue(), err.getvalue()


def run_fks_tpu(monkeypatch, argv):
    mod = load_fks_tpu_discover()
    monkeypatch.setattr(sys, "argv", ["discover.py", *argv])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main()
    return rc, out.getvalue(), err.getvalue()


def close(got, want, where):
    if isinstance(want, float):
        assert abs(got - want) <= TOL, f"{where}: {got} vs {want}"
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, f"{where}[{i}]")
    else:
        assert got == want, f"{where}: {got!r} vs {want!r}"


def rows(path):
    out = []
    for line in pathlib.Path(path).read_text().splitlines():
        row = json.loads(line)
        assert isinstance(row.pop("ts"), float)
        out.append(row)
    return out


def progress(err):
    """The stderr lines both tools print, without the wall times."""
    keep = []
    for line in err.splitlines():
        if line.startswith(("workload:", "gen ", "champion:")):
            keep.append(re.sub(r" \(\d+s\)$", "", line))
    return keep


@pytest.mark.parametrize("engine", ["exact", "flat", "fused"])
def test_discover_records_equal_fks_tpu(same_search, monkeypatch, tmp_path,
                                        engine):
    argv = ["--cpu", "--engine", engine, "--gens", "3", "--pop", "8",
            "--elite-k", "2", "--seed", "1"]
    got = {}
    for tag in ("fk", "pt"):
        out_dir = tmp_path / tag
        full = argv + ["--out", str(out_dir), "--metrics",
                       str(tmp_path / f"{tag}.jsonl"), "--checkpoint",
                       str(tmp_path / f"{tag}_ck")]
        rc, out, err = (run_fks_tpu(monkeypatch, full) if tag == "fk"
                        else run_port(full))
        assert rc == 0, err
        (saved,) = out_dir.iterdir()
        assert NAME.match(saved.name), saved.name
        got[tag] = (json.loads(out.splitlines()[-1]),
                    json.loads(saved.read_text()),
                    rows(tmp_path / f"{tag}.jsonl"), progress(err), saved,
                    err)
    fk, pt = got["fk"], got["pt"]
    # the last stdout line: the record without its code
    assert set(pt[0]) == set(fk[0]) == KEYS - {"code"}
    for key in sorted(KEYS - {"code", "timestamp"}):
        close(pt[0][key], fk[0][key], key)
    # the champion file: fks_tpu's schema, the same record and name score
    assert set(pt[1]) == set(fk[1]) == KEYS
    assert pt[1]["code"] == fk[1]["code"]
    assert pt[4].name.split("_score")[1] == fk[4].name.split("_score")[1]
    # the discover_gen rows and the progress lines
    assert len(pt[2]) == len(fk[2]) == 3
    for i, (p, f) in enumerate(zip(pt[2], fk[2])):
        assert set(p) == set(f) == {"kind", "engine", "generation", "best",
                                    "mean"}
        for key in sorted(f):
            close(p[key], f[key], f"row {i} {key}")
    assert pt[3] == fk[3]
    assert re.search(r"^timing: 3 generations in [\d.]+ s", pt[5], re.M)
    # the final checkpoint of each is written
    assert (tmp_path / "pt_ck.npz").is_file()
    assert (tmp_path / "fk_ck.npz").is_file()


def test_discover_init_from_seeds_lane_zero(same_search, tmp_path):
    champ = tmp_path / "champ.json"
    w = parametric.seed_weights("best_fit") + 0.01
    champ.write_text(json.dumps({"score": 0.5, "weights": w.tolist()}))
    rc, out, err = run_port(["--cpu", "--engine", "flat", "--gens", "1",
                             "--pop", "8", "--init-from", str(champ)])
    assert rc == 0, err
    assert f"population seeded from {champ} (pop 8, noise 0.08)" in err
    rec = json.loads(out.splitlines()[-1])
    assert rec["generation"] == 1
    # lane 0 holds the champion exactly: the search is never worse
    from fks_tpu_torch.parallel import make_population_eval
    from fks_tpu_torch.sim.engine import SimConfig
    wl = pt_data.TraceParser().parse_workload()
    alone = make_population_eval(wl, cfg=SimConfig(track_ctime=False),
                                 engine="flat", device="cpu")(w[None])
    assert rec["search_score"] >= float(alone.policy_score[0])


def test_discover_resumes_its_own_checkpoint(same_search, tmp_path):
    base = ["--cpu", "--engine", "flat", "--pop", "8", "--elite-k", "2"]
    rc, straight, _ = run_port(base + ["--gens", "3"])
    assert rc == 0
    ck = str(tmp_path / "ck")
    assert run_port(base + ["--gens", "2", "--checkpoint", ck])[0] == 0
    rc, resumed, err = run_port(base + ["--gens", "1", "--checkpoint", ck,
                                        "--resume"])
    assert rc == 0, err
    assert "resumed at generation 2" in err
    a = json.loads(straight.splitlines()[-1])
    b = json.loads(resumed.splitlines()[-1])
    a.pop("timestamp")
    b.pop("timestamp")
    assert a == b


def test_discover_resumes_a_fks_tpu_checkpoint(same_search, jax_wl,
                                               tmp_path):
    jpe = JaxParametricEvolution(jax_wl, pop_size=8, elite_k=2, seed=2,
                                 engine="flat")
    jpe.run(2)
    ck = jpe.save_checkpoint(str(tmp_path / "fk_ck"))
    rc, out, err = run_port(["--cpu", "--engine", "flat", "--pop", "8",
                             "--elite-k", "2", "--seed", "5", "--gens", "1",
                             "--checkpoint", ck, "--resume"])
    assert rc == 0, err
    assert "is an fks_tpu checkpoint" in err and "--seed 5" in err
    assert f"resumed at generation 2 (best {jpe.best_score:.4f})" in err
    rec = json.loads(out.splitlines()[-1])
    assert rec["generation"] == 3
    assert rec["search_score"] >= jpe.best_score - TOL
    # the checkpoint the port wrote over it is the port's own now
    with np.load(ck) as d:
        assert d["key"].dtype == np.uint8 and int(d["generation"]) == 3
    # a population of another size is refused
    with pytest.raises(ValueError, match="population shape"):
        run_port(["--cpu", "--engine", "flat", "--pop", "16", "--gens", "1",
                  "--checkpoint", str(tmp_path / "fk_ck"), "--resume"])


def test_discover_error_exits(same_search, monkeypatch, tmp_path):
    with pytest.raises(SystemExit) as exc, \
            contextlib.redirect_stderr(io.StringIO()):
        discover.main(["--cpu", "--resume", "--init-from", "x.json"])
    assert exc.value.code == 2
    rc, _, err = run_port(["--cpu", "--gens", "1", "--pop", "8",
                           "--init-from", str(CODE_CHAMPION)])
    frk, _, ferr = run_fks_tpu(monkeypatch, [
        "--cpu", "--gens", "1", "--pop", "8", "--init-from",
        str(CODE_CHAMPION)])
    assert rc == frk == 2
    assert err.splitlines()[-1] == ferr.splitlines()[-1]
    assert "code-evolved champion" in err


def test_discover_flags_equal_fks_tpu():
    """Every flag of fks_tpu's parser, with its default."""
    import ast

    tree = ast.parse((ROOT / "tools" / "discover.py").read_text())
    want = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            flag = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            want[flag] = (ast.literal_eval(kw["default"])
                          if "default" in kw else None)
    ap = discover.build_parser()
    got = {a.option_strings[0]: a.default for a in ap._actions
           if a.option_strings and a.dest != "help"}
    assert set(got) == set(want)
    for flag, default in want.items():
        if default is not None:
            assert got[flag] == default, flag
