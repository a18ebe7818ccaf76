"""Candidate-policy pre-flight: reject statically-doomed LLM candidates
BEFORE the sandbox/transpile/capture pipeline spends device time on them,
and fingerprint the survivors for near-duplicate suppression.

Port of fks_tpu.analysis.candidate, the same rules over the port's own
tables: every table here is DERIVED at import time from the port's
``funsearch.transpiler`` (``_Pod.FIELDS``, ``_Node.FIELDS``,
``_Gpu.attr``, ``_Interp.MAX_UNROLL``, ``_MATH_FNS``, ``_ARITY``) and
``funsearch.sandbox`` (``SAFE_BUILTINS``, ``SAFE_MATH``, the forbidden
substrings and node types), so there is no second hand-kept copy to
drift. tests/test_torch_analysis.py holds the verdicts, taxonomies,
fingerprints and cost estimates equal to fks_tpu's.

Three products per candidate, one AST parse:

- a verdict against the transpiler's lowerable subset;
- a static cost estimate: op/call counts, loop-nest depth, and a
  per-node work bound as a polynomial in the padded GPU axis G (gpu
  loops and generators multiply by G, constant ``range()`` loops by
  their trip count). ``sim.engine.static_work_hint`` feeds it to
  ``resolve_auto_prefilter`` (a provably trivial policy skips the timing
  probe), and it rides along in ``CodeEvaluator.last_eval_stats``;
- a normalized-AST fingerprint: variables alpha-renamed in first-use
  order (entity names and builtins preserved), numeric constants
  bucketed by sign + magnitude decade, docstrings dropped. Candidates
  that differ only in naming or coefficient jitter collide, so the
  evaluator can score one representative and the elite pool can refuse
  echoes without a difflib pass.

SOUNDNESS MODEL. ``transpile`` = ``sandbox.validate`` + an abstract
interpretation that executes EVERY reachable statement symbolically
(both ``if`` arms run under lane masks). Sandbox-level checks therefore
hold everywhere in the tree. Transpiler-level checks hold wherever
execution is *guaranteed*; the checker threads a ``guaranteed`` flag
that turns False inside the only constructs the interpreter can skip —
``range()`` bodies whose trip count isn't provably nonzero, ``IfExp``
branches / later ``BoolOp`` operands whose condition may be a static
Python bool — so "rejected" always implies "transpile would raise".
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import inspect
import math
import textwrap
from typing import Dict, List, Optional, Set, Tuple

from fks_tpu_torch.funsearch import sandbox, transpiler

#: machine-readable rejection vocabulary — the ``taxonomy`` field of
#: ledger ``candidate_rejected`` events (fks_tpu's, entry for entry)
REJECT_TAXONOMY = (
    "syntax",                # ast.parse failed
    "forbidden_construct",   # sandbox substring / node-type / private attr
    "bad_signature",         # wrong entry point shape (name/args/structure)
    "unsupported_syntax",    # parses + sandbox-clean, transpiler can't lower
    "unsupported_call",      # call target outside the lowerable builtins
    "bad_arity",             # known call, wrong argument count
    "unknown_attribute",     # pod/node/gpu field the entities don't expose
    "loop_too_long",         # static range() beyond the unroll bound
    "duplicate_fingerprint", # normalized-AST collision with a batch sibling
)


# ---------------------------------------------------------------------------
# tables derived from the transpiler / sandbox (never re-hardcoded)

def _derive_gpu_fields() -> frozenset:
    """GPU attribute names, read out of ``_Gpu.attr``'s own source: the
    method is a chain of ``name == ...`` / ``name in (...)`` comparisons,
    so the accepted field set is exactly the string constants compared
    against ``name``."""
    src = textwrap.dedent(inspect.getsource(transpiler._Gpu.attr))
    fields: Set[str] = set()
    for node in ast.walk(ast.parse(src)):
        if not (isinstance(node, ast.Compare)
                and isinstance(node.left, ast.Name)
                and node.left.id == "name"):
            continue
        for comp in node.comparators:
            for c in ast.walk(comp):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    fields.add(c.value)
    if not fields:  # the derivation itself drifted — fail loudly
        raise RuntimeError("could not derive GPU fields from transpiler._Gpu")
    return frozenset(fields)


POD_FIELDS = frozenset(transpiler._Pod.FIELDS)
NODE_FIELDS = frozenset(transpiler._Node.FIELDS) | {"gpus"}
GPU_FIELDS = _derive_gpu_fields()
MAX_UNROLL = transpiler._Interp.MAX_UNROLL
ARITY = dict(transpiler._ARITY)
MATH_FNS = frozenset(transpiler._MATH_FNS)
#: builtins the transpiler's call() actually lowers in expression position
#: (range/enumerate are iterator-only; sum/sorted are genexp-only and
#: handled before the arity table in call())
EXPR_CALLS = (frozenset(n for n in ARITY if not n.startswith("math."))
              - {"range", "enumerate"}) | {"sum", "sorted"}
_RESERVED = frozenset({"pod", "node", "math"}) | set(sandbox.SAFE_BUILTINS)


# ---------------------------------------------------------------------------
# cost estimate

@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Static per-node work bound. ``coeffs[d]`` counts operations nested
    under ``d`` GPU-axis loops, so ``work(G) = sum(coeffs[d] * G**d)``
    bounds the op count one node evaluates per policy call. ``range()``
    loops with constant bounds multiply by their trip count at the same
    degree (they don't scale with the cluster); unknown-trip loops are
    bounded by the transpiler's own unroll cap."""

    ops: int
    calls: int
    loop_depth: int
    coeffs: Tuple[int, ...]

    def work(self, g_padded: int = 1) -> int:
        return int(sum(c * g_padded ** d for d, c in enumerate(self.coeffs)))


class _CostVisitor(ast.NodeVisitor):
    def __init__(self):
        self.ops = 0
        self.calls = 0
        self.loop_depth = 0
        self._depth = 0       # current For/genexp nesting (for loop_depth)
        self._degree = 0      # current GPU-axis degree
        self._mult = 1        # current constant-range multiplier
        self.coeffs: Dict[int, int] = {}

    def _count(self, n: int = 1) -> None:
        self.coeffs[self._degree] = (self.coeffs.get(self._degree, 0)
                                     + n * self._mult)

    def visit_BinOp(self, node):
        self.ops += 1
        self._count()
        self.generic_visit(node)

    visit_UnaryOp = visit_BinOp
    visit_BoolOp = visit_BinOp
    visit_Compare = visit_BinOp
    visit_IfExp = visit_BinOp
    visit_Subscript = visit_BinOp
    visit_Attribute = visit_BinOp

    def visit_Call(self, node):
        self.calls += 1
        self.ops += 1
        self._count()
        self.generic_visit(node)

    def _enter_loop(self, *, gpu: bool, trips: int = 1):
        self._depth += 1
        self.loop_depth = max(self.loop_depth, self._depth)
        if gpu:
            self._degree += 1
        else:
            self._mult *= max(1, trips)

    def _exit_loop(self, *, gpu: bool, trips: int = 1):
        self._depth -= 1
        if gpu:
            self._degree -= 1
        else:
            self._mult //= max(1, trips)

    def visit_For(self, node):
        self.visit(node.iter)
        trips, gpu = 1, True
        if isinstance(node.iter, ast.Call) \
                and isinstance(node.iter.func, ast.Name) \
                and node.iter.func.id == "range":
            gpu = False
            trips = _static_range_len(node.iter)
            if trips is None:
                trips = MAX_UNROLL  # bound unknown trips by the unroll cap
        self._enter_loop(gpu=gpu, trips=trips)
        for st in node.body:
            self.visit(st)
        self._exit_loop(gpu=gpu, trips=trips)

    def visit_GeneratorExp(self, node):
        for comp in node.generators:
            self.visit(comp.iter)
        self._enter_loop(gpu=True)
        for comp in node.generators:
            for cond in comp.ifs:
                self.visit(cond)
        self.visit(node.elt)
        self._exit_loop(gpu=True)


def _static_range_len(call: ast.Call) -> Optional[int]:
    """Trip count of ``range(...)`` when every bound is an int literal
    (unary minus allowed); None when any bound is dynamic."""
    vals: List[int] = []
    for a in call.args:
        v = _int_literal(a)
        if v is None:
            return None
        vals.append(v)
    if not 1 <= len(vals) <= 3:
        return None
    try:
        return len(range(*vals))
    except (TypeError, ValueError):
        return None


def _int_literal(node) -> Optional[int]:
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _int_literal(node.operand)
        return None if inner is None else -inner
    return None


def estimate_cost(fn: ast.FunctionDef) -> CostEstimate:
    v = _CostVisitor()
    for st in fn.body:
        v.visit(st)
    hi = max(v.coeffs) if v.coeffs else 0
    return CostEstimate(ops=v.ops, calls=v.calls, loop_depth=v.loop_depth,
                        coeffs=tuple(v.coeffs.get(d, 0)
                                     for d in range(hi + 1)))


# ---------------------------------------------------------------------------
# normalized-AST fingerprint

def _bucket(v) -> str:
    """Sign + magnitude-decade token: 0 -> "0", 0.8 -> "+e0", 7 -> "+e1",
    -3000 -> "-e4". Coefficient jitter inside a decade collides; crossing
    a decade (a real behavioral change at these scales) does not."""
    if v == 0:
        return "0"
    sign = "-" if v < 0 else "+"
    mag = abs(float(v))
    dec = 0 if mag <= 1.0 else int(math.floor(math.log10(mag))) + 1
    return f"{sign}e{dec}"


class _Normalizer(ast.NodeTransformer):
    """Alpha-rename user variables in first-occurrence order; bucket
    numeric constants. Entity names, ``math``, and the sandbox builtins
    keep their identity (renaming those would alias unrelated code)."""

    def __init__(self):
        self.names: Dict[str, str] = {}

    def _rename(self, name: str) -> str:
        if name in _RESERVED:
            return name
        return self.names.setdefault(name, f"v{len(self.names)}")

    def visit_Name(self, node):
        return ast.copy_location(
            ast.Name(id=self._rename(node.id), ctx=node.ctx), node)

    def visit_Constant(self, node):
        if isinstance(node.value, bool) \
                or not isinstance(node.value, (int, float)):
            return node
        return ast.copy_location(ast.Constant(value=_bucket(node.value)),
                                 node)

    def visit_FunctionDef(self, node):
        body = [st for st in node.body
                if not (isinstance(st, ast.Expr)
                        and isinstance(st.value, ast.Constant))]
        node = ast.FunctionDef(
            name=node.name, args=node.args, body=body or [ast.Pass()],
            decorator_list=[], returns=None, type_comment=None)
        return self.generic_visit(node)


def fingerprint(code: str,
                entry_point: str = "priority_function") -> Optional[str]:
    """16-hex-char fingerprint of the normalized candidate AST, or None
    when the code doesn't parse / lacks the entry point."""
    try:
        tree = ast.parse(code)
    except (SyntaxError, ValueError):
        return None
    fn = next((n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == entry_point), None)
    if fn is None:
        return None
    return _fingerprint_fn(fn)


def _fingerprint_fn(fn: ast.FunctionDef) -> str:
    norm = _Normalizer().visit(fn)
    return hashlib.sha256(
        ast.dump(norm, annotate_fields=False).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# pre-flight verdict

@dataclasses.dataclass
class PreflightReport:
    ok: bool
    taxonomy: Optional[str] = None
    reason: str = ""
    cost: Optional[CostEstimate] = None
    fingerprint: Optional[str] = None

    def __bool__(self) -> bool:
        return self.ok


class _Reject(Exception):
    def __init__(self, taxonomy: str, reason: str):
        assert taxonomy in REJECT_TAXONOMY
        self.taxonomy, self.reason = taxonomy, reason
        super().__init__(f"{taxonomy}: {reason}")


def preflight_check(code: str,
                    entry_point: str = "priority_function",
                    ) -> PreflightReport:
    """Static verdict for one candidate. ``ok=False`` guarantees that the
    full pipeline (``sandbox.validate`` -> ``transpile``) would also fail
    — the evaluator can skip it outright; ``ok=True`` carries the cost
    estimate and fingerprint and promises nothing more (the transpiler's
    dynamic checks still run)."""
    try:
        fn = _structure(code, entry_point)
        _sandbox_walk(fn)
        _Checker(fn).run()
    except _Reject as r:
        return PreflightReport(False, r.taxonomy, r.reason)
    return PreflightReport(True, cost=estimate_cost(fn),
                           fingerprint=_fingerprint_fn(fn))


def _structure(code: str, entry_point: str) -> ast.FunctionDef:
    """Substring blacklist + parse + entry-point shape (mirrors
    ``sandbox.validate_source_text`` / the structural half of
    ``sandbox.validate_structure``)."""
    low = code.lower()
    for frag in sandbox.FORBIDDEN_SUBSTRINGS:
        if frag in low:
            raise _Reject("forbidden_construct",
                          f"forbidden substring {frag!r}")
    try:
        tree = ast.parse(code)
    except (SyntaxError, ValueError) as e:
        raise _Reject("syntax", str(e)) from None
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    if len(fns) != 1 or fns[0].name != entry_point:
        raise _Reject("bad_signature",
                      f"need exactly one function {entry_point!r}")
    fn = fns[0]
    if [x.arg for x in fn.args.args] != ["pod", "node"]:
        raise _Reject("bad_signature", "signature must be (pod, node)")
    for n in tree.body:
        if n is fn:
            continue
        if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant):
            continue
        raise _Reject("bad_signature",
                      "only the entry function + docstrings at top level")
    return fn


def _sandbox_walk(fn: ast.FunctionDef) -> None:
    """The sandbox's everywhere-sound checks: node-type allowlist, call
    whitelist, private attribute ban."""
    for node in ast.walk(fn):
        if not isinstance(node, sandbox._ALLOWED_NODES):
            raise _Reject("forbidden_construct",
                          f"disallowed syntax {type(node).__name__}")
        if isinstance(node, ast.Attribute) and node.attr.startswith("_"):
            raise _Reject("forbidden_construct",
                          f"private attribute {node.attr!r}")
        if isinstance(node, ast.FunctionDef) and node is not fn:
            raise _Reject("forbidden_construct", "nested function")
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                if f.id not in sandbox.SAFE_BUILTINS:
                    raise _Reject("unsupported_call",
                                  f"call to {f.id!r} not allowed")
            elif isinstance(f, ast.Attribute):
                if not (isinstance(f.value, ast.Name)
                        and f.value.id == "math"
                        and f.attr in sandbox.SAFE_MATH):
                    raise _Reject("unsupported_call",
                                  "only math.<whitelisted> attribute calls")
            else:
                raise _Reject("unsupported_call", "computed call target")


def _is_node_gpus(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "gpus"
            and isinstance(node.value, ast.Name)
            and node.value.id == "node")


class _Checker:
    """Transpiler-subset checks under the guaranteed-execution model (see
    module docstring). One instance per candidate; ``run`` raises
    ``_Reject`` on the first guaranteed transpile failure."""

    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        self.assigned: Set[str] = set()
        self.gpu_names: Set[str] = set()
        self.int_targets: Set[str] = set()  # range index / enumerate index
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.assigned.add(t.id)
            elif isinstance(node, ast.For) and _is_node_gpus(node.iter) \
                    and isinstance(node.target, ast.Name):
                self.gpu_names.add(node.target.id)
            elif isinstance(node, ast.For) \
                    and isinstance(node.iter, ast.Call) \
                    and isinstance(node.iter.func, ast.Name):
                fname = node.iter.func.id
                if fname == "enumerate" \
                        and isinstance(node.target, ast.Tuple) \
                        and len(node.target.elts) == 2:
                    if isinstance(node.target.elts[0], ast.Name):
                        self.int_targets.add(node.target.elts[0].id)
                    if isinstance(node.target.elts[1], ast.Name):
                        self.gpu_names.add(node.target.elts[1].id)
                elif fname == "range" and isinstance(node.target, ast.Name):
                    self.int_targets.add(node.target.id)
            elif isinstance(node, ast.comprehension) \
                    and isinstance(node.target, ast.Name):
                self.gpu_names.add(node.target.id)
        # a name that is BOTH a gpu-loop target and a plain assignment
        # target is ambiguous at any given use site — exempt from both
        # the gpu-field check and the non-entity check
        self.gpu_checked = self.gpu_names - self.assigned

    def run(self) -> None:
        self.block(self.fn.body, True)

    # ----- statements

    def block(self, stmts, guaranteed: bool) -> None:
        for st in stmts:
            self.stmt(st, guaranteed)

    def stmt(self, st, g: bool) -> None:
        if isinstance(st, ast.Assign):
            if g and (len(st.targets) != 1
                      or not isinstance(st.targets[0], ast.Name)):
                raise _Reject("unsupported_syntax",
                              "only simple `name = expr` assignment")
            self._assign_target(st.targets[0] if st.targets else None,
                                st.value, g)
            self.expr(st.value, g)
        elif isinstance(st, ast.AugAssign):
            if g and not isinstance(st.target, ast.Name):
                raise _Reject("unsupported_syntax",
                              "only simple augmented assignment")
            self._assign_target(st.target, st.value, g)
            self.expr(st.value, g)
        elif isinstance(st, ast.If):
            # the interpreter runs BOTH arms under lane masks — bodies
            # inherit guaranteedness from the enclosing block
            self.expr(st.test, g)
            self.block(st.body, g)
            self.block(st.orelse, g)
        elif isinstance(st, ast.Return):
            if st.value is None:
                if g:
                    raise _Reject("unsupported_syntax",
                                  "bare return not allowed")
                return
            self.expr(st.value, g)
        elif isinstance(st, ast.For):
            self._for(st, g)
        elif isinstance(st, ast.Expr):
            if isinstance(st.value, ast.Constant):
                return  # docstring position: any constant is dropped
            if g:
                raise _Reject("unsupported_syntax",
                              "expression statements have no effect")
            self.expr(st.value, g)
        elif isinstance(st, ast.Pass):
            return
        elif g:
            raise _Reject("unsupported_syntax",
                          f"unsupported statement {type(st).__name__}")

    def _assign_target(self, target, value, g: bool) -> None:
        if not g:
            return
        if isinstance(target, ast.Name) and target.id in ("pod", "node",
                                                          "math"):
            raise _Reject("unsupported_syntax",
                          f"cannot rebind {target.id!r}")
        if (isinstance(value, ast.Name) and value.id in ("pod", "node")) \
                or _is_node_gpus(value):
            raise _Reject("unsupported_syntax",
                          "cannot store entity objects in variables")

    def _for(self, st: ast.For, g: bool) -> None:
        if g and st.orelse:
            raise _Reject("unsupported_syntax", "for/else not supported")
        it = st.iter
        if _is_node_gpus(it):
            if g and not isinstance(st.target, ast.Name):
                raise _Reject("unsupported_syntax",
                              "gpu loop target must be a name")
            self.block(st.body, g)  # padded G >= 1: body always runs
            return
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "enumerate":
            if g:
                if it.keywords:
                    raise _Reject("unsupported_syntax",
                                  "keyword arguments not supported")
                self._arity("enumerate", len(it.args))
                if not (it.args and _is_node_gpus(it.args[0])):
                    raise _Reject("unsupported_syntax",
                                  "enumerate() only over node.gpus")
                tgt = st.target
                if not (isinstance(tgt, ast.Tuple) and len(tgt.elts) == 2
                        and all(isinstance(e, ast.Name) for e in tgt.elts)):
                    raise _Reject("unsupported_syntax",
                                  "enumerate target must be `i, gpu`")
            self.block(st.body, g)
            return
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "range":
            if g:
                if it.keywords:
                    raise _Reject("unsupported_syntax",
                                  "keyword arguments not supported")
                self._arity("range", len(it.args))
                if not isinstance(st.target, ast.Name):
                    raise _Reject("unsupported_syntax",
                                  "range loop target must be a name")
                for a in it.args:
                    self.expr(a, True)
                    for sub in ast.walk(a):
                        # the interpreter stores every plain assignment as
                        # a traced array (lane-masked blend), so only loop
                        # indices and literal arithmetic stay Python ints
                        bad = (isinstance(sub, ast.Constant)
                               and type(sub.value) is not int) \
                            or isinstance(sub, ast.Attribute) \
                            or (isinstance(sub, ast.Name)
                                and not (sub.id in self.int_targets
                                         and sub.id not in self.assigned))
                        if bad:
                            raise _Reject(
                                "unsupported_syntax",
                                "range() bounds must be static ints")
            trips = _static_range_len(it)
            if g and trips is not None and trips > MAX_UNROLL:
                raise _Reject("loop_too_long",
                              f"range loop longer than {MAX_UNROLL}")
            # empty or unknown trip count: the body may never execute, so
            # transpiler-level findings inside it are not guaranteed
            self.block(st.body, g and trips is not None and trips > 0)
            return
        if g:
            raise _Reject("unsupported_syntax",
                          "only `for gpu in node.gpus`, enumerate(node.gpus)"
                          ", or constant range() loops are supported")
        self.block(st.body, False)

    # ----- expressions

    def expr(self, node, g: bool) -> None:
        if isinstance(node, ast.Constant):
            if g and not isinstance(node.value, (bool, int, float)):
                raise _Reject("unsupported_syntax",
                              f"unsupported constant {node.value!r}")
        elif isinstance(node, ast.Name):
            if g and node.id in ("pod", "node", "math"):
                # bare entity reference outside an attribute base: every
                # consuming position fails (store -> TranspileError,
                # arithmetic/len/int -> trace-time TypeError)
                raise _Reject("unsupported_syntax",
                              f"{node.id!r} used as a plain value")
        elif isinstance(node, ast.Attribute):
            self._attribute(node, g)
        elif isinstance(node, ast.BinOp):
            self.expr(node.left, g)
            self.expr(node.right, g)
        elif isinstance(node, ast.UnaryOp):
            self.expr(node.operand, g)
        elif isinstance(node, ast.BoolOp):
            # later operands are skipped when everything before them is
            # statically boolable — only a definitely-traced prefix makes
            # their evaluation guaranteed
            self.expr(node.values[0], g)
            dyn = self._dynamic(node.values[0])
            for v in node.values[1:]:
                self.expr(v, g and dyn)
                dyn = dyn or self._dynamic(v)
        elif isinstance(node, ast.Compare):
            self.expr(node.left, g)
            for c in node.comparators:
                self.expr(c, g)
        elif isinstance(node, ast.IfExp):
            self.expr(node.test, g)
            both = g and self._dynamic(node.test)
            self.expr(node.body, both)
            self.expr(node.orelse, both)
        elif isinstance(node, ast.Call):
            self._call(node, g)
        elif isinstance(node, ast.Subscript):
            self._subscript(node, g)
        elif isinstance(node, ast.GeneratorExp):
            if g:
                raise _Reject("unsupported_syntax",
                              "generator outside sum/min/max/sorted")
            self._genexp_inner(node, False)
        elif g and isinstance(node, (ast.Tuple, ast.List)):
            raise _Reject("unsupported_syntax",
                          f"unsupported expression {type(node).__name__}")
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.expr, ast.GeneratorExp)):
                    self.expr(child, False)

    def _attribute(self, node: ast.Attribute, g: bool) -> None:
        base = node.value
        if isinstance(base, ast.Name):
            bid = base.id
            if bid == "pod":
                if g and node.attr not in POD_FIELDS:
                    raise _Reject("unknown_attribute",
                                  f"unknown pod attribute {node.attr!r}")
                return
            if bid == "node":
                if g and node.attr not in NODE_FIELDS:
                    raise _Reject("unknown_attribute",
                                  f"unknown node attribute {node.attr!r}")
                return
            if bid == "math":
                if g:  # non-call math attribute: base evals to a plain str
                    raise _Reject("unsupported_syntax",
                                  "attribute access on non-entity value")
                return
            if bid in self.gpu_checked:
                if g and node.attr not in GPU_FIELDS:
                    raise _Reject("unknown_attribute",
                                  f"unknown gpu attribute {node.attr!r}")
                return
            if bid in self.gpu_names:
                return  # ambiguous (also assigned) — skip
            if g:  # plain variable / undefined name: never an entity
                raise _Reject("unsupported_syntax",
                              "attribute access on non-entity value")
            return
        if isinstance(base, ast.Subscript) and _is_node_gpus(base.value):
            self._subscript(base, g)
            if g and node.attr not in GPU_FIELDS:
                raise _Reject("unknown_attribute",
                              f"unknown gpu attribute {node.attr!r}")
            return
        # any other base (chained attribute, call result, arithmetic)
        # evaluates to a non-entity
        self.expr(base, g)
        if g:
            raise _Reject("unsupported_syntax",
                          "attribute access on non-entity value")

    def _call(self, node: ast.Call, g: bool) -> None:
        if g and node.keywords:
            raise _Reject("unsupported_syntax",
                          "keyword arguments not supported")
        for kw in node.keywords:
            self.expr(kw.value, False)
        f = node.func
        if isinstance(f, ast.Attribute):
            # sandbox stage already pinned this to math.<SAFE_MATH>
            if g:
                self._arity(f"math.{f.attr}", len(node.args))
            for a in node.args:
                self.expr(a, g)
            return
        if not isinstance(f, ast.Name):
            return  # sandbox stage rejected computed targets already
        name = f.id
        genexp_arg = (len(node.args) == 1
                      and isinstance(node.args[0], ast.GeneratorExp))
        if name in ("sum", "min", "max") and genexp_arg:
            self._genexp_inner(node.args[0], g)
            return
        if name == "sorted":
            if genexp_arg:
                self._genexp_inner(node.args[0], g)
                return
            if g:
                raise _Reject("unsupported_call",
                              "sorted() only over a generator")
            for a in node.args:
                self.expr(a, False)
            return
        if name == "len":
            if g:
                self._arity("len", len(node.args))
                a = node.args[0] if node.args else None
                ok = _is_node_gpus(a) or (
                    isinstance(a, ast.Call) and isinstance(a.func, ast.Name)
                    and a.func.id == "sorted")
                if not ok:
                    raise _Reject("unsupported_call",
                                  "len() only of node.gpus or sorted(...)")
            for a in node.args:
                if not _is_node_gpus(a):
                    self.expr(a, g)
            return
        if name == "sum":
            if g:
                raise _Reject("unsupported_call",
                              "sum() only over a generator")
            for a in node.args:
                self.expr(a, False)
            return
        if name in ("range", "enumerate"):
            if g:  # iterator builtins in expression position
                raise _Reject("unsupported_call",
                              f"call to unsupported function {name!r}")
            for a in node.args:
                self.expr(a, False)
            return
        if name in EXPR_CALLS:
            if g:
                self._arity(name, len(node.args))
            for a in node.args:
                self.expr(a, g)
            return
        if g:  # inside SAFE_BUILTINS (sandbox-clean) but not lowerable: str
            raise _Reject("unsupported_call",
                          f"call to unsupported function {name!r}")
        for a in node.args:
            self.expr(a, False)

    def _subscript(self, node: ast.Subscript, g: bool) -> None:
        idx = node.slice
        k = _int_literal(idx)
        if g and k is None:
            raise _Reject("unsupported_syntax",
                          "subscripts must use a static integer index")
        if g and k is not None and k < 0 and _is_node_gpus(node.value):
            raise _Reject("unsupported_syntax",
                          "negative gpu index not supported")
        if not _is_node_gpus(node.value):
            self.expr(node.value, g)
        if k is None and isinstance(idx, ast.expr):
            self.expr(idx, False)

    def _genexp_inner(self, gen: ast.GeneratorExp, g: bool) -> None:
        if g:
            if len(gen.generators) != 1:
                raise _Reject("unsupported_syntax",
                              "single-clause generators only")
            comp = gen.generators[0]
            if comp.is_async:
                raise _Reject("unsupported_syntax",
                              "async generators not allowed")
            if not _is_node_gpus(comp.iter):
                raise _Reject("unsupported_syntax",
                              "generators only over node.gpus")
            if not isinstance(comp.target, ast.Name):
                raise _Reject("unsupported_syntax",
                              "generator target must be a name")
        for comp in gen.generators:
            if not _is_node_gpus(comp.iter):
                self.expr(comp.iter, g)
            for cond in comp.ifs:
                self.expr(cond, g)
        self.expr(gen.elt, g)

    def _arity(self, name: str, n: int) -> None:
        lo, hi = ARITY.get(name, (0, None))
        if n < lo or (hi is not None and n > hi):
            raise _Reject("bad_arity", f"{name}() called with {n} "
                          "argument(s)")

    def _dynamic(self, node) -> bool:
        """True when ``node`` DEFINITELY evaluates to a traced array (an
        entity field read on an unconditionally-evaluated path). False is
        always safe — it only widens the maybe-skipped region."""
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name) and (
                    (base.id == "pod" and node.attr in POD_FIELDS)
                    or (base.id == "node" and node.attr in NODE_FIELDS
                        and node.attr != "gpus")
                    or (base.id in self.gpu_names
                        and node.attr in GPU_FIELDS)):
                return True
            if isinstance(base, ast.Subscript) \
                    and _is_node_gpus(base.value):
                return node.attr in GPU_FIELDS
            return False
        if isinstance(node, (ast.BinOp,)):
            return self._dynamic(node.left) or self._dynamic(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._dynamic(node.operand)
        if isinstance(node, ast.Compare):
            return (self._dynamic(node.left)
                    or any(self._dynamic(c) for c in node.comparators))
        if isinstance(node, ast.BoolOp):
            return self._dynamic(node.values[0])
        if isinstance(node, ast.IfExp):
            return self._dynamic(node.test)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id == "len":
                return True  # len() of node.gpus/sorted is an i32[N] array
            return any(self._dynamic(a) for a in node.args
                       if not isinstance(a, ast.GeneratorExp)) \
                or any(isinstance(a, ast.GeneratorExp)
                       and self._dynamic(a.elt) for a in node.args)
        if isinstance(node, ast.Subscript):
            return self._dynamic(node.value)
        return False
