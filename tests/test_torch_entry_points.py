"""The port's last entry points and public names against fks_tpu's, on
the CPU.

- ``parametric.as_policy`` gives fks_tpu's integer scores on random
  views (the draw of tests/test_torch_policies.py), in float32 and
  float64; ``obs.watchdog.check_result`` gives fks_tpu's mask and
  ``watchdog`` event; ``parallel.lead_axis_size`` and ``make_single_run``
  agree with fks_tpu's on the same trees and the micro workload;
- ``entry.entry()`` scores the tiny workload as fks_tpu's
  ``__graft_entry__.entry()`` does; ``entry.dryrun_multichip`` runs on 8
  and 3 logical CPU shards, every sharded result held against its
  single-device run inside it, and its scores equal fks_tpu's population
  eval of the same weights (fks_tpu's own dryrun re-initialises JAX's
  backends, so it is not called here);
- the probes (``tools.probe_ops``, ``tools.probe_floor``): their names
  equal fks_tpu's (read from its sources with ``ast``) and every body
  runs a few steps;
- ``tools.export_node_yaml``: byte-identical to fks_tpu's tool and to the
  shipped manifest file.
"""
import ast
import contextlib
import importlib.util
import io
import pathlib
import sys
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fks_tpu.models import parametric as jpar
from fks_tpu.obs import watchdog as jwatchdog
from fks_tpu.obs.recorder import NullRecorder as JaxNullRecorder
from fks_tpu.parallel import lead_axis_size as jax_lead_axis_size
from fks_tpu.parallel import make_population_eval as jax_population_eval
from fks_tpu.parallel import make_single_run as jax_single_run
from fks_tpu.sim.engine import SimConfig as JaxConfig
from fks_tpu.sim.engine import initial_state as jax_initial_state
from fks_tpu_torch import entry
from fks_tpu_torch.models import parametric
from fks_tpu_torch.obs import watchdog
from fks_tpu_torch.obs.recorder import NullRecorder
from fks_tpu_torch.parallel import lead_axis_size, make_single_run
from fks_tpu_torch.sim import engine
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.testing import port_workload
from fks_tpu_torch.tools import export_node_yaml, probe_floor, probe_ops
from tests.test_torch_policies import jax_per_lane, port_views, random_views

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"fks_tpu_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------- the public names

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_as_policy_gives_fks_tpu_scores(seed, dtype):
    view, pod, w = random_views(seed, gpu_heavy=bool(seed))
    pv, nodes = port_views(view, pod)
    for row in (0, 7):
        weights = w[row]
        got = parametric.as_policy(weights, getattr(torch, dtype))(pv, nodes)
        # a list of floats keeps its precision until the cast
        again = parametric.as_policy(weights.tolist(),
                                     getattr(torch, dtype))(pv, nodes)
        # the weights reach JAX as a jit argument (run-time values, as
        # the port computes; a closed-over constant lets XLA refold the
        # dot, ROADMAP queue 3 item 4)
        want = jax_per_lane(
            lambda wt, p, n: jpar.as_policy(wt, getattr(jnp, dtype))(p, n),
            view, pod, np.broadcast_to(weights, w.shape))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(again.numpy(), want)


class Capture(NullRecorder):
    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))


class JaxCapture(JaxNullRecorder):
    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))


class Flagged(NamedTuple):
    numeric_flags: object


@pytest.mark.parametrize("flags", [[0, 0, 0], [0, 1, 0], [4, 2, 0], [7],
                                   5, []])
def test_check_result_equals_fks_tpu(flags):
    rec, jrec = Capture(), JaxCapture()
    got = watchdog.check_result(
        Flagged(torch.tensor(flags, dtype=torch.int32)), recorder=rec,
        generation=3, where="test")
    want = jwatchdog.check_result(
        Flagged(np.asarray(flags, np.int32)), recorder=jrec, generation=3,
        where="test")
    assert got == want
    assert rec.events == jrec.events
    assert bool(rec.events) == bool(want)


def test_check_result_without_flags_is_clean():
    rec = Capture()
    assert watchdog.check_result(object(), recorder=rec) == 0
    assert rec.events == []


def test_lead_axis_size_equals_fks_tpu():
    class Prog(NamedTuple):
        a: object
        b: object

    trees = [
        lambda x: x(np.zeros((5, 3))),
        lambda x: {"b": x(np.zeros((2, 4))), "a": [x(np.zeros((7,)))]},
        lambda x: [x(np.zeros((3, 1))), x(np.zeros((9,)))],
        lambda x: Prog(x(np.zeros((6, 2))), x(np.zeros((1,)))),
    ]
    for make in trees:
        assert lead_axis_size(make(torch.from_numpy)) == \
            jax_lead_axis_size(make(jnp.asarray))


def test_make_single_run_equals_fks_tpu(micro_workload):
    assert make_single_run is engine.make_param_run_fn
    w = parametric.seed_weights("best_fit")
    wl = port_workload(micro_workload)
    got = make_single_run(wl, parametric.score, SimConfig())(
        w, engine.initial_state(wl, SimConfig())).lane(0)
    want = jax_single_run(micro_workload, jpar.score, JaxConfig())(
        jnp.asarray(w.numpy()), jax_initial_state(micro_workload,
                                                  JaxConfig()))
    assert abs(float(got.policy_score) - float(want.policy_score)) <= 1e-6
    assert int(got.scheduled_pods) == int(want.scheduled_pods)


# -------------------------------------------------------------- entry

def test_entry_scores_like_fks_tpu():
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as graft

    fn, args = entry.entry(device="cpu")
    got = fn(*args)
    assert torch.equal(fn(*args), got)  # state0 left as it was
    jfn, jargs = graft.entry()
    assert abs(float(got) - float(jfn(*jargs))) <= 1e-6


def test_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_on_logical_cpu_shards(n):
    assert entry.mesh_devices(n, "cpu") == [torch.device("cpu")] * n
    out = entry.dryrun_multichip(n, device="cpu")
    assert out["pop"] == 2 * n and len(out["scores"]) == 2 * n
    assert out.get("hybrid", False) == (n % 2 == 0 and n >= 4)
    assert len(out["code_scores"]) >= 2
    # fks_tpu's population eval of the same weights on its tiny workload
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as graft

    gen = torch.Generator().manual_seed(0)
    pop = parametric.init_population(gen, 2 * n, noise=0.1)
    want = np.asarray(jax_population_eval(graft._tiny_workload())(
        jnp.asarray(pop.numpy())).policy_score)
    np.testing.assert_allclose(out["scores"], want, rtol=0, atol=1e-6)


# -------------------------------------------------------------- probes

def _string_compares(tree, var):
    """Strings ``var`` is compared with (``==`` or ``in (...)``)."""
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Compare) and isinstance(node.left, ast.Name)
                and node.left.id == var):
            for c in node.comparators:
                for k in ast.walk(c):
                    if isinstance(k, ast.Constant) and isinstance(k.value,
                                                                  str):
                        out.add(k.value)
    return out


def test_probe_ops_names_equal_fks_tpu():
    tree = ast.parse((ROOT / "tools" / "probe_ops.py").read_text())
    (loop,) = [n for n in ast.walk(tree) if isinstance(n, ast.For)
               and isinstance(n.iter, ast.List)]
    order = [e.value for e in loop.iter.elts]
    assert list(probe_ops.NAMES) == order
    assert set(order) == _string_compares(tree, "name")


def test_probe_floor_names_equal_fks_tpu():
    tree = ast.parse((ROOT / "tools" / "probe_floor.py").read_text())
    (shapes,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "shapes"]
    assert list(probe_floor.SHAPES) == [k.value for k in shapes.keys]
    unrolls = {e.value for n in ast.walk(tree) if isinstance(n, ast.For)
               and isinstance(n.iter, ast.Tuple)
               for e in n.iter.elts if isinstance(e, ast.Constant)}
    # fks_tpu's unroll factors (1, 8, 16 in A/B; 4, 8 in C) and lanes
    assert {1, 8, 16} <= set(probe_floor.UNROLLS)
    assert {4, 8} <= set(probe_floor.SWEEP_UNROLLS)
    assert set(probe_floor.SWEEP_LANES) <= unrolls


def test_probe_ops_runs_every_body():
    lines = []
    rows = probe_ops.probe([2, 3], 4, torch.device("cpu"), log=lines.append)
    assert [(ln, n) for ln, n, _ in rows] == [
        (ln, n) for ln in (2, 3) for n in probe_ops.NAMES]
    assert all(us > 0 for _, _, us in rows)
    assert lines[0].startswith("lanes=    2 dense16 ")
    assert all(line.endswith(" us/step") for line in lines)
    # the carry moves: each body's work is not dropped
    for name in probe_ops.NAMES:
        body, carry = probe_ops.make_body(name, 2, "cpu")
        for c in carry:
            c.copy_(torch.randint(0, 1000, c.shape))
        before = [c.clone() for c in carry]
        probe_ops.time_steps(body, carry, 3)
        assert any(not torch.equal(a, b) for a, b in zip(before, carry)), \
            name


def test_probe_floor_runs_parts_a_b_c():
    lines = []
    ab = probe_floor.part_a_b(2, torch.device("cpu"), log=lines.append)
    assert list(ab) == list(probe_floor.SHAPES)
    for row in ab.values():
        assert list(row) == ["while"] + [f"scan/u{u}"
                                         for u in probe_floor.UNROLLS]
        assert all(v > 0 for v in row.values())
    c = probe_floor.part_c(1, torch.device("cpu"), log=lines.append)
    assert [(ln, col) for ln, col, _ in c] == [
        (ln, col) for ln in probe_floor.SWEEP_LANES
        for col in ["while"] + [f"scan/u{u}"
                                for u in probe_floor.SWEEP_UNROLLS]]
    assert lines[0] == "== A/B: empty-ish bodies, while vs scan(unroll) =="
    assert "== C: composite sweep-step prototype ==" in lines
    # the sweep body advances its queue: the popped slot is rewritten
    body, init = probe_floor.make_sweep_step(4, 64, "cpu")
    carry = init()
    ev0 = carry[0].clone()
    probe_floor.time_steps(body, carry, 2)
    assert not torch.equal(ev0, carry[0])


def test_probe_mains_run_on_the_cpu():
    for tool, argv in ((probe_ops, ["--cpu", "--steps", "2", "--lanes",
                                    "2"]),
                       (probe_floor, ["--cpu", "--steps", "2", "--parts",
                                      "ab"])):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert tool.main(argv) == 0
        assert err.getvalue().startswith("device: cpu:cpu; steps=2")
        assert out.getvalue().strip()


# ---------------------------------------------------- export_node_yaml

@pytest.mark.parametrize("suffix", [".yaml", ".yaml.gz"])
def test_export_node_yaml_byte_identical(tmp_path, suffix):
    fk = load_tool("export_node_yaml")
    nodes = str(ROOT / "benchmarks" / "traces" / "csv"
                / "openb_node_list_gpu_node.csv.gz")
    # one file name in two directories: gzip records the name
    (tmp_path / "fk").mkdir()
    (tmp_path / "pt").mkdir()
    name = f"openb_node_list_gpu_node{suffix}"
    a, b = tmp_path / "fk" / name, tmp_path / "pt" / name
    assert fk.export(nodes, str(a)) == export_node_yaml.export(nodes, str(b))
    assert a.read_bytes() == b.read_bytes()
    if suffix == ".yaml.gz":
        shipped = (ROOT / "benchmarks" / "traces" / "node_yaml"
                   / "openb_node_list_gpu_node.yaml.gz")
        assert b.read_bytes() == shipped.read_bytes()


def test_export_node_yaml_needs_an_out(tmp_path):
    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stderr(io.StringIO()):
        export_node_yaml.main([])
    assert e.value.code == 2
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert export_node_yaml.main(["--out",
                                      str(tmp_path / "n.yaml")]) == 0
    assert out.getvalue().startswith("wrote 1213 Node manifests to ")
