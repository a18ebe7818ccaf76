"""Repo linter for the invariants CUDA-graph capture relies on.

Port of fks_tpu.analysis.lint's AST gate (``cli lint``), pure stdlib.
fks_tpu checks the bodies of functions decorated with ``jax.jit``; the
port has no tracing, but its hot loops run as captured CUDA graphs
(``sim.engine.capture``), and a capture has rules of its own: a host
sync inside a captured body fails the capture or records a stream that
stalls, and a host-side value is frozen into the graph at capture time.

**Which bodies count as captured.** The scope is syntactic, so a clean
tree stays clean without per-site waivers. A function is a *captured
body* when

1. it is defined (at any depth) inside a function named ``build_step``
   or ``build_<name>_step``: the exact engine's step
   (``sim/engine.py``) and the flat engine's two (``sim/flat.py``'s
   PyTorch step, ``sim/flat_step.py``'s kernel step). Every runner binds
   one of these through ``sim.engine.bind_step`` before ``GraphedChunk``
   captures it: the population runners, the sharded and suite runners,
   and the serve engines (``serve/artifact.py`` binds
   ``mod.build_step``);
2. or the module marks it as a policy a captured step calls, by
   assigning its ``graph_steps`` attribute (``f.graph_steps = ...``): the
   funsearch VM's ``score`` and ``score_static`` (``funsearch/vm.py``),
   whose op slots run inside every captured VM step;
3. or it is a function of the same module that a captured body calls by
   its bare name outside its host branches (below), transitively (the
   VM's ``_execute`` and its helpers, the engines' row and view helpers).

The host path is sanctioned: a branch under an ``if`` whose test checks
that a tensor lives on the CPU (``<x>.device.type == "cpu"``; the
``else`` branch of ``!= "cpu"``) is skipped, because a capture only ever
runs CUDA tensors, and the port's CPU path reads the host freely.

**Rules** (fks_tpu's codes, each with the meaning it has for a capture):

- FKS100: a syntax error (the gate reports it, never crashes).
- FKS101: a Python ``while`` loop in a captured body whose test reads
  tensor data of one of the body's parameters: every iteration would read
  the device on the host, a sync a capture cannot hold.
- FKS102: an ``if`` (or conditional expression) in a captured body whose
  test reads tensor data of one of the body's parameters — an implicit
  ``bool(tensor)``, the same sync. Reads of a parameter's metadata
  (``.device``, ``.dtype``, ``.shape``, ``.ndim``, ``.is_cuda``,
  ``.dim()``, ``.size()``, ``.numel()``) and ``is None`` tests are host
  values and are not flagged, nor are parameters annotated ``bool``,
  ``int``, ``float`` or ``str`` (fks_tpu's ``static_argnums``); closure
  reads of Python-static config are the sanctioned pattern, as in
  fks_tpu.
- FKS103: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` or a
  ``synchronize()`` (``torch.cuda.synchronize``, a stream's or an event's)
  inside a captured body: a device-to-host sync breaks the capture or
  silently empties it.
- FKS104: a ``numpy`` call (via any imported alias) inside a captured
  body: a host array is frozen into the graph at capture time, or forces
  a copy to the host.
- FKS107: a sharded entry point (a module-level ``make_sharded_*``
  function) that never reaches the layout ledger — directly or through a
  function of its module it calls: ``record_layout``, ``tag_layout``,
  ``_resolve_layout``, ``_layout_eval``, ``_sharded_lanes_fn`` or a
  ``layout_key`` — and carries no ``layout-exempt`` docstring waiver. An
  untagged sharded schedule is invisible to ``cli layout`` and the layout
  explorer.

**Left out.**

- FKS105 (a ``SimConfig`` passed as a traced jit argument): nothing is
  traced in the port. A step reads its ``SimConfig`` on the host when it
  is built, and a capture records kernels, never a Python read, so a
  config argument cannot turn into device data.
- FKS106 (an AOT ``.lower(...).compile()`` without a footprint record):
  the port's capture sites are generic (``GraphedChunk`` and the
  auto-prefilter probe's transient graph, both through
  ``sim.engine.capture``) and do not know which component owns the
  graph; the owners price their graphs around the construction
  (``obs.memory.capture_footprint`` in the serve engines and the evolve
  loop's batched tier). A site-level rule has no site to hold.
- **The jaxpr pins** have no PyTorch counterpart: there is no lowered
  program to hash, and a captured graph is not inspectable. ``cli lint``
  checks no pins; ``--pins`` and ``--write-pins`` exit 2 saying so, and
  ``--no-pins`` is accepted and changes nothing (ROADMAP queue 3).

``Finding``, its JSON, the ``lint_report`` metric and the exit codes
(0 clean, 1 findings, 2 error) are fks_tpu's.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

LINT_CODES = {
    "FKS101": "python while loop on tensor data in a captured step body",
    "FKS102": "data-dependent if on a tensor argument of a captured step "
              "body",
    "FKS103": "host sync (.item()/.tolist()/.cpu()/.numpy()/synchronize) "
              "inside a captured step body",
    "FKS104": "numpy usage inside a captured step body",
    "FKS107": "sharded entry point without a layout ledger record",
}

#: method names that copy device data to the host or wait for the device
_SYNC_CALLS = {"item", "tolist", "cpu", "numpy", "synchronize"}

#: attributes and methods of a tensor that are host metadata, not data
_META_ATTRS = {"device", "dtype", "shape", "ndim", "is_cuda", "layout"}
_META_CALLS = {"dim", "size", "numel", "element_size", "is_floating_point",
               "get_device"}

#: names whose presence waives FKS107 — the sharded entry point files or
#: tags its layout (obs.layout)
_LAYOUT_MARKS = {"record_layout", "tag_layout", "layout_key",
                 "_resolve_layout", "_layout_eval", "_sharded_lanes_fn"}
_LAYOUT_WAIVER = "layout-exempt"

#: annotations of parameters that hold host values
_SCALARS = {"bool", "int", "float", "str"}

_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint hit: machine fields plus the gcc-style rendering."""

    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# --------------------------------------------------------- captured bodies


def _numpy_aliases(tree: ast.Module) -> Set[str]:
    """Names the module binds to the numpy package (``import numpy as
    np`` -> {"np"})."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy" or a.name.startswith("numpy."):
                    out.add(a.asname or a.name.split(".")[0])
    return out


def _graph_step_marks(tree: ast.Module) -> Set[str]:
    """Module-level names whose ``graph_steps`` attribute the module
    assigns (``score.graph_steps = score_static.graph_steps = 1``)."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Attribute) and t.attr == "graph_steps"
                        and isinstance(t.value, ast.Name)):
                    out.add(t.value.id)
    return out


def _called_names(fn: ast.AST) -> Set[str]:
    """The bare names ``fn`` calls where a capture can run it (its host
    branches left out, ``_device_nodes``)."""
    return {n.func.id for n in _device_nodes(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


#: the functions whose inner functions are captured steps
_STEP_BUILDER = re.compile(r"build(_\w+)?_step")


def captured_bodies(tree: ast.Module) -> List[ast.AST]:
    """The module's captured bodies, by the module docstring's rule."""
    module_fns: Dict[str, ast.AST] = {
        n.name: n for n in tree.body if isinstance(n, _FUNC)}
    roots: List[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, _FUNC) and _STEP_BUILDER.fullmatch(node.name):
            roots.extend(n for n in ast.walk(node)
                         if isinstance(n, _FUNC) and n is not node)
    roots.extend(module_fns[n] for n in sorted(_graph_step_marks(tree))
                 if n in module_fns)
    seen: Dict[int, ast.AST] = {}
    todo = list(roots)
    while todo:
        fn = todo.pop()
        if id(fn) in seen:
            continue
        seen[id(fn)] = fn
        todo.extend(module_fns[n] for n in _called_names(fn)
                    if n in module_fns)
    return sorted(seen.values(), key=lambda f: f.lineno)


def _on_host_test(test: ast.expr) -> Optional[bool]:
    """True when ``test`` holds only for CPU tensors (``x.device.type ==
    "cpu"``, possibly and-ed with other terms), False when it holds only
    for non-CPU ones (``!= "cpu"``), else None."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        verdicts = {_on_host_test(v) for v in test.values} - {None}
        return verdicts.pop() if len(verdicts) == 1 else None
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    left, right = test.left, test.comparators[0]
    is_type = (isinstance(left, ast.Attribute) and left.attr == "type"
               and isinstance(left.value, ast.Attribute)
               and left.value.attr == "device")
    if not (is_type and isinstance(right, ast.Constant)
            and right.value == "cpu"):
        return None
    if isinstance(test.ops[0], ast.Eq):
        return True
    if isinstance(test.ops[0], ast.NotEq):
        return False
    return None


def _device_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Every node of ``fn`` a capture can run: the host branches of
    ``_on_host_test`` ifs are left out."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, ast.If):
            host = _on_host_test(node.test)
            stack.append(node.test)
            if host is not True:
                stack.extend(node.body)
            if host is not False:
                stack.extend(node.orelse)
            continue
        stack.extend(ast.iter_child_nodes(node))


def _tensor_params(fn: ast.AST) -> Set[str]:
    """The parameters that may hold tensors: all but those annotated with
    a Python scalar type (``bool``, ``int``, ``float``, ``str``), which
    are host values (fks_tpu's ``static_argnums``)."""
    args = fn.args
    names = set()
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if not (isinstance(ann, ast.Name) and ann.id in _SCALARS):
            names.add(a.arg)
    for extra in (args.vararg, args.kwarg):
        if extra is not None:
            names.add(extra.arg)
    return names


def _data_read(node: ast.AST, names: Set[str]) -> Optional[ast.Name]:
    """The first parameter in ``names`` whose tensor DATA ``node`` reads:
    metadata reads and ``is None`` tests are not data."""
    if isinstance(node, ast.Name):
        return node if node.id in names else None
    if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
        return None
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _META_CALLS):
        return None
    if (isinstance(node, ast.Compare) and len(node.ops) == 1
            and isinstance(node.ops[0], (ast.Is, ast.IsNot))):
        return None
    for child in ast.iter_child_nodes(node):
        hit = _data_read(child, names)
        if hit is not None:
            return hit
    return None


def _lint_captured(path: str, fn: ast.AST, np_aliases: Set[str],
                   findings: List[Finding]) -> None:
    """Rules FKS101-104 over one captured body, its lambdas included
    (not its nested defs: each is a body of its own when captured)."""
    params = _tensor_params(fn)

    def hit(code: str, node: ast.AST, detail: str) -> None:
        findings.append(Finding(path, getattr(node, "lineno", fn.lineno),
                                code, f"{LINT_CODES[code]}: {detail}"))

    nested = {id(n) for f in ast.walk(fn)
              if f is not fn and isinstance(f, _FUNC) for n in ast.walk(f)}
    for node in _device_nodes(fn):
        if id(node) in nested:
            continue
        if isinstance(node, ast.While):
            read = _data_read(node.test, params)
            if read is not None:
                hit("FKS101", node,
                    f"'{read.id}' in '{fn.name}' — keep the trip count on "
                    f"the host or mask the lanes")
        elif isinstance(node, (ast.If, ast.IfExp)):
            read = _data_read(node.test, params)
            if read is not None:
                hit("FKS102", node,
                    f"'{read.id}' in '{fn.name}' — use torch.where")
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_CALLS:
                hit("FKS103", node, f".{f.attr}() in '{fn.name}'")
            elif _reads_name(f, np_aliases):
                hit("FKS104", node,
                    f"in '{fn.name}' — use torch on the step's device")


def _reads_name(node: ast.AST, names: Set[str]) -> bool:
    return any(isinstance(s, ast.Name) and s.id in names
               for s in ast.walk(node))


# ------------------------------------------------------ sharded entry points


def _reaches_layout(fn: ast.AST, module_fns: Dict[str, ast.AST]) -> bool:
    seen: Set[str] = set()
    todo = [fn]
    while todo:
        f = todo.pop()
        for sub in ast.walk(f):
            if isinstance(sub, ast.Name) and sub.id in _LAYOUT_MARKS:
                return True
            if isinstance(sub, ast.Attribute) and sub.attr in _LAYOUT_MARKS:
                return True
        for name in _called_names(f) - seen:
            seen.add(name)
            if name in module_fns:
                todo.append(module_fns[name])
    return False


def _lint_sharded_entry_points(path: str, tree: ast.Module,
                               findings: List[Finding]) -> None:
    """FKS107 over the module's ``make_sharded_*`` functions."""
    module_fns = {n.name: n for n in tree.body if isinstance(n, _FUNC)}
    for name, fn in sorted(module_fns.items()):
        if not name.startswith("make_sharded_"):
            continue
        if _reaches_layout(fn, module_fns):
            continue
        if _LAYOUT_WAIVER in (ast.get_docstring(fn) or ""):
            continue
        findings.append(Finding(
            path, fn.lineno, "FKS107",
            f"{LINT_CODES['FKS107']}: '{name}' — resolve a LayoutSpec "
            f"(obs.layout) and record_layout/tag_layout the runner, or "
            f"mark the function '{_LAYOUT_WAIVER}' when its caller tags "
            f"the returned runner"))


# -------------------------------------------------------------- the gate


def lint_source(path: str, source: str) -> List[Finding]:
    """Lint one module's source. Syntax errors surface as a finding (the
    gate must not crash on a broken tree mid-refactor)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "FKS100",
                        f"syntax error: {e.msg}")]
    np_aliases = _numpy_aliases(tree)
    findings: List[Finding] = []
    for fn in captured_bodies(tree):
        _lint_captured(path, fn, np_aliases, findings)
    _lint_sharded_entry_points(path, tree, findings)
    return findings


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint every ``*.py`` under the given files/directories, sorted by
    location. The default gate target is the package root."""
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        else:
            files.append(path)
    findings: List[Finding] = []
    for f in files:
        findings.extend(lint_source(str(f), f.read_text()))
    findings.sort(key=lambda x: (x.path, x.line, x.code))
    return findings
