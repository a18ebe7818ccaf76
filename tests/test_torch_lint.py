"""The capture-invariant lint (fks_tpu_torch.analysis.lint, ``cli lint``).

Each ported rule fires on a small snippet and stays quiet on its
sanctioned pattern: FKS101 (a ``while`` on tensor data) and FKS102 (an
``if`` on tensor data) against metadata reads, ``is None`` tests, scalar
parameters and closure config; FKS103 (``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``synchronize()``) and FKS104 (numpy) inside a
captured body against the same calls at build time, outside any captured
body, or on the host branch; the three ways a body counts as captured
(inside ``build_step``, a ``graph_steps`` mark, a call from a captured
body); FKS107 on ``make_sharded_*`` entry points against a layout record
reached directly, through a helper, or a ``layout-exempt`` waiver. A
syntax error is a finding (FKS100, fks_tpu's text). The port lints clean,
its captured bodies include every step the port captures, and ``cli
lint`` keeps fks_tpu's exit codes and ``lint_report`` row (checked by
tools/check_jsonl_schema.py); the port has no jaxpr pins.
"""
import ast
import contextlib
import io
import json
import pathlib
import sys
import textwrap

import pytest

import fks_tpu.cli as fk_cli
import fks_tpu_torch.cli as pt_cli
from fks_tpu_torch.analysis import lint

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def codes(src):
    return [f.code for f in lint.lint_source("snippet.py",
                                             textwrap.dedent(src))]


def step_body(body, build="", head="s"):
    """A module whose ``build_step`` defines ``step(head)`` running
    ``body``; ``build`` runs at build time, outside the step."""
    lines = textwrap.indent(textwrap.dedent(body), " " * 8)
    pre = textwrap.indent(textwrap.dedent(build), " " * 4)
    return (f"import numpy as np\nimport torch\n\n"
            f"def build_step(workload, cfg, k=3):\n{pre}\n"
            f"    def step({head}):\n{lines}\n        return s\n"
            f"    return step\n")


FIRING = {
    "FKS101-while": ("while s.size > 0:\n    s = s\n", "FKS101"),
    "FKS102-if": ("if s.failed.any():\n    s = s\n", "FKS102"),
    "FKS102-ifexp": ("x = 1 if s.size.max() > 2 else 0\n", "FKS102"),
    "FKS103-item": ("n = s.size.item()\n", "FKS103"),
    "FKS103-tolist": ("n = s.size.tolist()\n", "FKS103"),
    "FKS103-cpu": ("n = s.size.cpu()\n", "FKS103"),
    "FKS103-numpy": ("n = s.size.numpy()\n", "FKS103"),
    "FKS103-synchronize": ("torch.cuda.synchronize()\n", "FKS103"),
    "FKS104-numpy": ("x = np.zeros(3)\n", "FKS104"),
    "FKS103-in-a-lambda": ("f = lambda x: x.item()\n", "FKS103"),
    "FKS103-host-branch-else": (
        "if s.size.device.type != 'cpu':\n    n = s.size.item()\n",
        "FKS103"),
}


@pytest.mark.parametrize("case", sorted(FIRING))
def test_rule_fires_in_a_step(case):
    body, code = FIRING[case]
    assert codes(step_body(body)) == [code]


QUIET = {
    "closure-config": step_body("if cfg.flag and k > 2:\n    s = s\n"),
    "metadata": step_body("if s.size.dim() == 1 and s.data.shape[0] > 2 "
                          "and s.size.dtype == torch.int32:\n    s = s\n"),
    "is-none": step_body("if s.trace is not None:\n    s = s\n"),
    "while-closure": step_body("i = 0\nwhile i < k:\n    i += 1\n"),
    "host-branch": step_body(
        "if s.size.device.type == 'cpu':\n    n = s.size.tolist()\n"),
    "host-branch-and": step_body(
        "if k and s.size.device.type == 'cpu':\n    n = s.size.item()\n"
        "else:\n    n = s.size\n"),
    "build-time-numpy": step_body("", build="tab = np.zeros(3)\n"
                                  "n = workload.size.item()\n"),
    "scalar-param": step_body("if flag:\n    s = s\n",
                              head="s, flag: bool = False"),
    "outside-capture": "import numpy as np\n\ndef helper(x):\n"
                       "    return np.asarray(x.cpu()).tolist()\n",
    "lambda-in-step": step_body("f = lambda x: x\n"),
}


@pytest.mark.parametrize("case", sorted(QUIET))
def test_sanctioned_pattern_is_quiet(case):
    assert codes(QUIET[case]) == []


def test_graph_steps_mark_and_calls_make_a_body_captured():
    src = textwrap.dedent("""
        import numpy as np

        def _helper(x):
            return x.sum().item()

        def _deeper(x):
            return np.ones(2)

        def _middle(x):
            return _deeper(x)

        def score(prog, pod, nodes):
            _middle(pod)
            return _helper(pod)

        def unmarked(prog, pod, nodes):
            return pod.item()

        score.graph_steps = 1
        """)
    found = lint.lint_source("vm.py", src)
    assert [(f.code, f.line) for f in found] == [("FKS103", 5),
                                                 ("FKS104", 8)]
    tree = ast.parse(src)
    assert [f.name for f in lint.captured_bodies(tree)] == [
        "_helper", "_deeper", "_middle", "score"]


def test_named_step_builders_make_their_inner_functions_captured():
    src = step_body("n = s.size.item()\n")
    for builder, want in (("build_kernel_step", ["FKS103"]),
                          ("build_torch_step", ["FKS103"]),
                          ("build_stepper", []), ("rebuild_step", [])):
        assert codes(src.replace("def build_step(",
                                 f"def {builder}(")) == want, builder


HOST_HELPER = """
import torch

def _plain(x):
    return x.sum().item()

def build_foo_step(workload):
    def step(s):
        if s.size.device.type == "cpu":
            _plain(s.size)
{device_call}        return s
    return step
"""


@pytest.mark.parametrize("device_call, want", [
    ("", []),
    ("        _plain(s.data)\n", [("FKS103", 5)]),
], ids=["host-branch-only", "also-on-device"])
def test_a_helper_called_on_the_host_branch_alone_is_not_captured(
        device_call, want):
    src = HOST_HELPER.format(device_call=device_call)
    found = lint.lint_source("helper.py", src)
    assert [(f.code, f.line) for f in found] == want
    names = {f.name for f in lint.captured_bodies(ast.parse(src))}
    assert ("_plain" in names) == bool(want)


def test_nested_defs_report_once():
    src = step_body("def inner(x):\n    return x.item()\ny = inner(s)\n")
    found = lint.lint_source("nested.py", src)
    assert [f.code for f in found] == ["FKS103"]
    assert "'inner'" in found[0].message


@pytest.mark.parametrize("src,want", [
    ("def make_sharded_eval(wl, mesh):\n    return lambda p: p\n",
     ["FKS107"]),
    ("def make_sharded_eval(wl, mesh):\n    run = lambda p: p\n"
     "    record_layout('eval', spec, mesh=mesh)\n    return run\n", []),
    ("def _wrap(fn, spec, mesh):\n    return tag_layout(fn, spec.key)\n\n"
     "def make_sharded_eval(wl, mesh):\n    return _wrap(None, 1, mesh)\n",
     []),
    ("def _a(fn):\n    return _b(fn)\n\ndef _b(fn):\n"
     "    return _layout_eval(fn, 'eval', None, None)\n\n"
     "def make_sharded_x(wl, mesh):\n    return _a(None)\n", []),
    ("def make_sharded_helper(wl, mesh):\n"
     "    \"\"\"Inner builder; layout-exempt: the caller tags it.\"\"\"\n"
     "    return None\n", []),
    ("def make_population_eval(wl):\n    return None\n", []),
], ids=["untagged", "direct", "helper", "transitive", "waiver",
        "not-sharded"])
def test_fks107_sharded_entry_points(src, want):
    assert codes(src) == want


def test_syntax_error_is_a_finding_like_fks_tpu(tmp_path):
    from fks_tpu.analysis import lint as fk_lint

    bad = "def broken(:\n    pass\n"
    got = lint.lint_source("bad.py", bad)
    assert [f.to_json() for f in got] == \
        [f.to_json() for f in fk_lint.lint_source("bad.py", bad)]
    assert got[0].code == "FKS100" and str(got[0]).startswith("bad.py:1: ")


def test_the_port_lints_clean():
    assert lint.lint_paths([str(ROOT / "fks_tpu_torch")]) == []
    rc, out, _ = run(pt_cli, ["lint"])
    assert rc == 0
    assert out == "lint: 0 finding(s), 0 pin message(s) -> clean\n"


def test_every_captured_step_is_covered():
    """The rule's bodies include the exact and flat steps (the serve
    engines bind these), the VM's policies and their interpreter."""
    pkg = ROOT / "fks_tpu_torch"
    want = {"sim/engine.py": {"step", "lane_active", "_node_view"},
            "sim/flat.py": {"step", "lane_active"},
            "sim/flat_step.py": {"step", "flat_pop", "flat_commit"},
            "funsearch/vm.py": {"score", "score_static", "_execute",
                                "_inputs", "_lanes"}}
    for rel, names in want.items():
        tree = ast.parse((pkg / rel).read_text())
        got = {f.name for f in lint.captured_bodies(tree)}
        assert names <= got, (rel, got)
    serve = (pkg / "serve" / "artifact.py").read_text()
    assert "bind_step(mod.build_step" in serve


def test_cli_exit_codes_findings_and_report_row(tmp_path):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_jsonl_schema as cjs
    finally:
        sys.path.pop(0)
    dirty = tmp_path / "dirty.py"
    dirty.write_text(step_body("n = s.size.item()\n"))
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    run_dir = tmp_path / "run"
    rc, out, _ = run(pt_cli, ["lint", str(dirty), str(bad), "--run-dir",
                              str(run_dir)])
    assert rc == 1
    lines = out.splitlines()
    assert lines[0].startswith(f"{bad}:1: FKS100 syntax error")
    assert lines[1].startswith(f"{dirty}:") and " FKS103 " in lines[1]
    assert lines[-1] == "lint: 2 finding(s), 0 pin message(s) -> FAIL"
    assert cjs.main(["--run-dir", str(run_dir)]) == 0
    (row,) = [json.loads(ln) for ln in
              (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert row["kind"] == "lint_report" and row["ok"] is False
    assert [f["code"] for f in row["findings"]] == ["FKS100", "FKS103"]
    # fks_tpu's row for the same paths: the same keys and FKS100 finding
    fk_dir = tmp_path / "fk_run"
    fk_rc, fk_out, _ = run(fk_cli, ["lint", str(bad), "--no-pins",
                                    "--run-dir", str(fk_dir)])
    (fk_row,) = [json.loads(ln) for ln in
                 (fk_dir / "metrics.jsonl").read_text().splitlines()]
    assert sorted(fk_row) == sorted(row)
    assert fk_row["findings"] == row["findings"][:1]
    pt_rc, pt_out, _ = run(pt_cli, ["lint", str(bad), "--no-pins"])
    assert (pt_rc, pt_out) == (fk_rc, fk_out)


@pytest.mark.parametrize("flags", [["--pins", "p.json"], ["--write-pins"]])
def test_pins_are_refused(flags, tmp_path):
    rc, out, err = run(pt_cli, ["lint", *flags])
    assert rc == 2 and out == ""
    assert "no jaxpr pins" in err
    assert not (tmp_path / "p.json").exists()
