"""Restricted Python -> vectorized PyTorch policy compiler.

Port of fks_tpu.funsearch.transpiler: the same lowering rules, poison and
returned masks, and ``TranspileError`` set. The reference ``exec``s
candidate source and calls the scalar ``priority_function(pod, node)``
once per node per event (reference: funsearch/funsearch_integration.py:
67-101, funsearch/safe_execution.py:126-168); here the same source is
compiled once into a ``PolicyFn`` that scores every node of every lane in
one tensor program, so a candidate runs inside the engines' step.

Lowering rules:

- every value is (broadcastable to) a tensor over the lanes and the node
  axis, ``[L, N]``; pod fields are ``[L, 1]`` columns;
- ``if``/``elif``/``else`` -> both branches run, assignments blend under
  the branch predicate (``torch.where``);
- ``return`` -> a per-lane ``returned`` mask + first-return-wins blend;
- ``for gpu in node.gpus`` -> a static loop over the padded GPU axis G,
  the body masked by ``gpu_mask[..., g]``;
- ``a and b`` / ``a or b`` keep Python value semantics;
- ``int(x)`` truncates toward zero; ``//`` and ``%`` follow Python's
  signs (floor division, a remainder with the divisor's sign);
- the result is truncated to int32, the engines' score contract.

Numeric model. Floats are one explicit dtype, ``transpile(code,
dtype=torch.float64)`` by default: float64 is CPython's binary64, the
reference's arithmetic, and what fks_tpu computes under x64 (how its
tests run); float32 on request, what fks_tpu computes without x64. Every
value is a Python scalar (folded in Python, as fks_tpu folds them) or a
tensor of dtype bool, int32 or the float dtype; a binary operation
converts both operands to the higher of the two kinds (bool < int <
float), a Python operand never widening a tensor of its own kind — JAX's
weak-type promotion with one float dtype. Divisions run on tensors (a
Python scalar divisor is made a 0-dim tensor first: PyTorch's CUDA ``x /
scalar`` multiplies by the reciprocal), and scalar constants are made
with ``torch.full`` on the views' device, never copied from the host, so
a policy captures in a CUDA graph. Integer division and remainder by
zero return what XLA's CPU backend returns (``//``: -1 for 0 // 0, else
-2; ``%``: 0) instead of raising.

Divergence from the reference, by design (as in fks_tpu): arithmetic
faults do not raise — lanes whose score comes out non-finite score 0
(refuse), and lanes where Python would have raised (``int()`` of a
non-finite, ``min()``/``max()`` of an empty generator, a read of a name
the taken path never assigned, an index past a short list) are poisoned
and refuse.
"""
from __future__ import annotations

import ast
import math
from typing import Any, Dict, Optional

import torch

from fks_tpu_torch.funsearch import sandbox
from fks_tpu_torch.sim.types import NodeView, PodView, PolicyFn

I32 = torch.int32


class TranspileError(ValueError):
    """Candidate uses syntax outside the lowerable subset."""


# ------------------------------------------------------------ value model

def _is_py(*vals) -> bool:
    return all(isinstance(v, (int, float, bool)) for v in vals)


def _kind(v) -> int:
    """0 bool, 1 int, 2 float."""
    if isinstance(v, bool):
        return 0
    if isinstance(v, int):
        return 1
    if isinstance(v, float):
        return 2
    if v.dtype == torch.bool:
        return 0
    return 2 if v.is_floating_point() else 1


class _Ctx:
    """The float dtype and the device of one policy call."""

    def __init__(self, dtype, device):
        self.f = dtype
        self.dev = device

    def dtype_of(self, kind: int):
        return (torch.bool, I32, self.f)[kind]

    def const(self, v, kind: Optional[int] = None) -> torch.Tensor:
        """A 0-dim tensor made on the device (no host copy)."""
        k = _kind(v) if kind is None else kind
        return torch.full((), v, dtype=self.dtype_of(k), device=self.dev)

    def cast(self, v, kind: int) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            want = self.dtype_of(kind)
            return v if v.dtype == want else v.to(want)
        return self.const(v, kind)

    def pair(self, a, b):
        """Both operands as tensors of their common kind (module
        docstring); a Python operand takes the tensor's kind unless its
        own kind is higher."""
        ka, kb = _kind(a), _kind(b)
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if ta and tb:
            k = max(ka, kb)
        elif ta:
            k = max(ka, kb) if kb > ka else ka
        elif tb:
            k = max(ka, kb) if ka > kb else kb
        else:
            k = max(ka, kb)
        return self.cast(a, k), self.cast(b, k), k

    def inexact(self, v):
        """Float coercion: ``/`` and ``math.*`` compute in the float dtype
        whatever the operands' types, as CPython computes them in
        binary64."""
        if isinstance(v, torch.Tensor):
            return v if v.is_floating_point() else v.to(self.f)
        return self.const(float(v), 2)


def _truthy(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    return v if v.dtype == torch.bool else v != 0


def _and(a, b):
    if isinstance(a, bool) and isinstance(b, bool):
        return a and b
    if isinstance(a, bool):
        return b if a else False
    if isinstance(b, bool):
        return a if b else False
    return a & b


def _or(a, b):
    if isinstance(a, bool) and isinstance(b, bool):
        return a or b
    if isinstance(a, bool):
        return True if a else b
    if isinstance(b, bool):
        return True if b else a
    return a | b


def _not(a):
    return (not a) if isinstance(a, bool) else ~a


def _statically_true(mask) -> bool:
    """True iff ``mask`` is the Python constant True. Masks are Python
    bools until a data-dependent condition enters them, so the decision is
    syntactic, never a read of the data (fks_tpu's tracers under jit
    behave alike)."""
    return mask is True


# ------------------------------------------------------------ object model

class _Pod:
    """Pod fields, ``[L, 1]`` columns."""

    FIELDS = ("cpu_milli", "memory_mib", "num_gpu", "gpu_milli",
              "creation_time", "duration_time")

    def __init__(self, pod: PodView):
        self._pod = pod

    def attr(self, name: str):
        if name not in self.FIELDS:
            raise TranspileError(f"unknown pod attribute {name!r}")
        return getattr(self._pod, name)


class _GpuList:
    """``node.gpus`` — iteration yields one padded-GPU column at a time."""

    def __init__(self, nodes: NodeView):
        self.nodes = nodes

    @property
    def count(self):
        return self.nodes.num_gpus  # == len(node.gpus) per node

    @property
    def padded(self) -> int:
        return int(self.nodes.gpu_mask.shape[-1])


class _Gpu:
    """One column g of the per-GPU arrays. ``memory_mib_left`` maps to the
    static total: the reference never allocates GPU memory."""

    def __init__(self, nodes: NodeView, g: int):
        self.nodes, self.g = nodes, g

    def attr(self, name: str):
        n, g = self.nodes, self.g
        if name == "gpu_milli_left":
            return n.gpu_milli_left[..., g]
        if name == "gpu_milli_total":
            return n.gpu_milli_total[..., g]
        if name in ("memory_mib_left", "memory_mib_total"):
            return n.gpu_mem_total[..., g]
        raise TranspileError(f"unknown gpu attribute {name!r}")


class _SortedVals:
    """``sorted(expr for gpu in node.gpus [if cond])`` — per-node ascending
    values over the padded GPU axis. Masked-out slots sort to the tail via
    a dtype-max sentinel; ``count`` is the per-node live length, so an
    index past it poisons the lane (Python's IndexError)."""

    def __init__(self, vals, sel):
        if vals.is_floating_point():
            big = math.inf
        elif vals.dtype == torch.bool:
            big = True
        else:
            big = torch.iinfo(vals.dtype).max
        self.vals = torch.sort(torch.where(sel, vals, big), dim=-1).values
        self.count = sel.sum(dim=-1, dtype=I32)

    def index(self, k: int, mask, interp):
        gp = int(self.vals.shape[-1])
        if k >= 0:
            interp.poison = _or(interp.poison, _and(mask, self.count <= k))
            return self.vals[..., min(k, gp - 1)]
        interp.poison = _or(interp.poison, _and(mask, self.count < -k))
        idx = (self.count + k).clamp(0, gp - 1).long()
        return self.vals.gather(-1, idx[..., None])[..., 0]


class _Node:
    FIELDS = ("cpu_milli_left", "cpu_milli_total", "memory_mib_left",
              "memory_mib_total", "gpu_left")

    def __init__(self, nodes: NodeView):
        self._nodes = nodes
        self.gpus = _GpuList(nodes)

    def attr(self, name: str):
        if name == "gpus":
            return self.gpus
        if name not in self.FIELDS:
            raise TranspileError(f"unknown node attribute {name!r}")
        return getattr(self._nodes, name)


class _EnumGpus:
    def __init__(self, gpus: _GpuList):
        self.gpus = gpus


def _int_trunc(ctx: _Ctx, v):
    """Python int(): truncate toward zero. Non-finite inputs become 0 (the
    caller poisons the lane)."""
    if v.dtype == torch.bool:
        return v.to(I32)
    if not v.is_floating_point():
        return v
    return torch.where(torch.isfinite(v), torch.trunc(v),
                       ctx.const(0.0, 2)).to(I32)


def _ipow(x, y: int):
    """``x ** y`` for a Python int y, as XLA's integer_pow computes it:
    binary exponentiation with exact multiplies, a reciprocal at the end
    for y < 0."""
    if y == 0:
        return torch.ones_like(x)
    neg, y = y < 0, abs(y)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    if neg:
        one = torch.ones_like(acc)
        return torch.div(one, acc, rounding_mode="trunc") \
            if not acc.is_floating_point() else one / acc
    return acc


class _Interp:
    """Vectorized symbolic executor over the function AST.

    ``mask`` threading: each block executes under an "active lanes" mask
    (the Python constant True, or a bool tensor); assignments and returns
    only take effect on active lanes. ``returned`` is global (a return
    deactivates the lane for the rest of the function, including
    subsequent loop iterations).
    """

    MAX_UNROLL = 64  # static range() loops larger than this are rejected

    def __init__(self, ctx: _Ctx, pod: PodView, nodes: NodeView):
        self.ctx = ctx
        self.shape = torch.broadcast_shapes(nodes.cpu_milli_left.shape,
                                            nodes.node_mask.shape)
        self.env: Dict[str, Any] = {
            "pod": _Pod(pod), "node": _Node(nodes), "math": "math",
        }
        self.nodes = nodes
        self.returned = False
        self.retval = torch.zeros(self.shape, dtype=I32, device=ctx.dev)
        # lanes where Python would have raised; they refuse at the end
        self.poison = False
        # per-variable "assigned on this lane" masks; absent = all lanes
        self.defined: Dict[str, Any] = {}
        # syntactic conditional-nesting depth: 0 = function top level
        self.cond_depth = 0

    def where(self, mask, new, old):
        if mask is True:
            return new
        if mask is False:
            return old
        a, b, _ = self.ctx.pair(new, old)
        return torch.where(mask, a, b)

    # ----- statements

    def run_block(self, stmts, mask):
        for st in stmts:
            self.run_stmt(st, _and(mask, _not(self.returned)))

    def run_stmt(self, st, mask):
        if isinstance(st, ast.Assign):
            if len(st.targets) != 1 or not isinstance(st.targets[0], ast.Name):
                raise TranspileError("only simple `name = expr` assignment")
            self.assign(st.targets[0].id, self.eval(st.value, mask), mask)
        elif isinstance(st, ast.AugAssign):
            if not isinstance(st.target, ast.Name):
                raise TranspileError("only simple augmented assignment")
            cur = self.load(st.target.id, mask)
            val = self.binop(st.op, cur, self.eval(st.value, mask))
            self.assign(st.target.id, val, mask)
        elif isinstance(st, ast.If):
            cond = _truthy(self.eval(st.test, mask))
            self.cond_depth += 1
            try:
                self.run_block(st.body, _and(mask, cond))
                if st.orelse:
                    self.run_block(st.orelse, _and(mask, _not(cond)))
            finally:
                self.cond_depth -= 1
        elif isinstance(st, ast.Return):
            if st.value is None:
                raise TranspileError("bare return not allowed")
            val = self.eval(st.value, mask)
            active = _and(mask, _not(self.returned))
            self.retval = self.where(active, val, self.retval)
            self.returned = _or(self.returned, active)
        elif isinstance(st, ast.For):
            self.run_for(st, mask)
        elif isinstance(st, ast.Expr):
            if isinstance(st.value, ast.Constant):  # docstring
                return
            raise TranspileError("expression statements have no effect")
        elif isinstance(st, ast.Pass):
            return
        else:
            raise TranspileError(f"unsupported statement {type(st).__name__}")

    def run_for(self, st, mask):
        if st.orelse:
            raise TranspileError("for/else not supported")
        it = self.eval_iter(st.iter, mask)
        gm = self.nodes.gpu_mask
        if isinstance(it, _GpuList):
            if not isinstance(st.target, ast.Name):
                raise TranspileError("gpu loop target must be a name")
            self.cond_depth += 1  # bodies run under a per-lane gpu mask
            try:
                for g in range(it.padded):
                    gmask = _and(_and(mask, gm[..., g]), _not(self.returned))
                    self.env[st.target.id] = _Gpu(self.nodes, g)
                    self.run_block(st.body, gmask)
            finally:
                self.cond_depth -= 1
            self.env.pop(st.target.id, None)
        elif isinstance(it, _EnumGpus):
            if not (isinstance(st.target, ast.Tuple)
                    and len(st.target.elts) == 2
                    and all(isinstance(e, ast.Name) for e in st.target.elts)):
                raise TranspileError("enumerate target must be `i, gpu`")
            iname, gname = (e.id for e in st.target.elts)
            self.cond_depth += 1
            try:
                for g in range(it.gpus.padded):
                    gmask = _and(_and(mask, gm[..., g]), _not(self.returned))
                    self.env[iname] = g
                    self.env[gname] = _Gpu(self.nodes, g)
                    self.run_block(st.body, gmask)
            finally:
                self.cond_depth -= 1
            self.env.pop(iname, None)
            self.env.pop(gname, None)
        elif isinstance(it, range):
            if not isinstance(st.target, ast.Name):
                raise TranspileError("range loop target must be a name")
            if len(it) > self.MAX_UNROLL:
                raise TranspileError(f"range loop longer than {self.MAX_UNROLL}")
            for i in it:
                self.env[st.target.id] = i
                self.run_block(st.body, _and(mask, _not(self.returned)))
            self.env.pop(st.target.id, None)
        else:
            raise TranspileError(
                "only `for gpu in node.gpus`, enumerate(node.gpus), or "
                "constant range() loops are supported")

    def eval_iter(self, node, mask):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "range":
                args = [self.eval(a, mask) for a in node.args]
                _check_arity("range", len(args))
                if not all(isinstance(a, int) for a in args):
                    raise TranspileError("range() bounds must be static ints")
                return range(*args)
            if node.func.id == "enumerate":
                _check_arity("enumerate", len(node.args))
                inner = self.eval(node.args[0], mask)
                if isinstance(inner, _GpuList):
                    return _EnumGpus(inner)
                raise TranspileError("enumerate() only over node.gpus")
        return self.eval(node, mask)

    # ----- environment

    def assign(self, name: str, val, mask):
        if name in ("pod", "node", "math"):
            raise TranspileError(f"cannot rebind {name!r}")
        if isinstance(val, (_Pod, _Node, _Gpu, _GpuList, _EnumGpus)):
            raise TranspileError("cannot store entity objects in variables")
        active = _and(mask, _not(self.returned))
        all_active = _statically_true(active)
        if isinstance(self.env.get(name), _SortedVals) \
                and not isinstance(val, _SortedVals):
            # overwriting a list with a scalar: plain rebinding on every
            # lane that has not returned; a branch-local overwrite would
            # blend a list with a scalar, which has no meaning
            if self.cond_depth != 0:
                raise TranspileError(
                    "cannot conditionally overwrite a sorted() list")
            self.env[name] = val
            self.defined.pop(name, None)
            return
        if isinstance(val, _SortedVals):
            if name in self.env and not all_active:
                raise TranspileError(
                    "cannot conditionally reassign a sorted() list")
            self.env[name] = val
            if name in self.defined:
                self.defined[name] = _or(self.defined[name], active)
            elif not all_active:
                self.defined[name] = active
            return
        if name in self.env:
            old = self.env[name]
            if _is_py(old, val) and all_active:
                self.env[name] = val  # stay scalar on unconditional paths
            else:
                self.env[name] = self.where(active, val, old)
            if name in self.defined:
                self.defined[name] = _or(self.defined[name], active)
        else:
            if _is_py(val) and all_active:
                self.env[name] = val
            else:
                # first assignment under a condition: untaken lanes hold a
                # placeholder 0 and are poisoned if they ever READ it
                # (Python raises UnboundLocalError there)
                self.env[name] = self.where(active, val, 0)
                if not all_active:
                    self.defined[name] = active

    def load(self, name: str, mask=None):
        if name not in self.env:
            raise TranspileError(f"undefined variable {name!r}")
        if mask is not None and name in self.defined:
            self.poison = _or(self.poison,
                              _and(mask, _not(self.defined[name])))
        return self.env[name]

    # ----- expressions

    def eval(self, node, mask):
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (bool, int, float)):
                return node.value
            raise TranspileError(f"unsupported constant {node.value!r}")
        if isinstance(node, ast.Name):
            return self.load(node.id, mask)
        if isinstance(node, ast.Attribute):
            base = self.eval(node.value, mask)
            if isinstance(base, (_Pod, _Node, _Gpu)):
                return base.attr(node.attr)
            raise TranspileError(
                f"attribute access on non-entity value: .{node.attr}")
        if isinstance(node, ast.BinOp):
            return self.binop(node.op, self.eval(node.left, mask),
                              self.eval(node.right, mask))
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand, mask)
            if isinstance(node.op, ast.USub):
                return -v if _is_py(v) else torch.neg(v)
            if isinstance(node.op, ast.UAdd):
                return v
            if isinstance(node.op, ast.Not):
                return _not(_truthy(v))
            raise TranspileError("unsupported unary operator")
        if isinstance(node, ast.BoolOp):
            # later operands evaluate under the lanes where Python would
            # reach them (short-circuit narrowing), so poison in an
            # unreached operand cannot leak
            out = self.eval(node.values[0], mask)
            reach = mask
            for v in node.values[1:]:
                t = _truthy(out)
                if isinstance(t, bool):
                    if isinstance(node.op, ast.And):
                        out = self.eval(v, reach) if t else out
                    else:
                        out = out if t else self.eval(v, reach)
                elif isinstance(node.op, ast.And):
                    reach = _and(reach, t)
                    out = self.where(t, self.eval(v, reach), out)
                else:
                    reach = _and(reach, _not(t))
                    out = self.where(t, out, self.eval(v, reach))
            return out
        if isinstance(node, ast.Compare):
            left = self.eval(node.left, mask)
            result = None
            reach = mask
            for op, rhs_node in zip(node.ops, node.comparators):
                rhs = self.eval(rhs_node, reach)
                c = self.compare(op, left, rhs)
                result = c if result is None else _and(result, c)
                if not isinstance(result, bool):
                    reach = _and(reach, result)  # chains short-circuit
                left = rhs
            return result
        if isinstance(node, ast.IfExp):
            cond = _truthy(self.eval(node.test, mask))
            if isinstance(cond, bool):
                return self.eval(node.body if cond else node.orelse, mask)
            a = self.eval(node.body, _and(mask, cond))
            b = self.eval(node.orelse, _and(mask, _not(cond)))
            return self.where(cond, a, b)
        if isinstance(node, ast.Call):
            return self.call(node, mask)
        if isinstance(node, ast.Subscript):
            return self.subscript(node, mask)
        raise TranspileError(f"unsupported expression {type(node).__name__}")

    def subscript(self, node, mask):
        base = self.eval(node.value, mask)
        idx = node.slice
        k: Optional[int] = None
        if isinstance(idx, ast.Constant) and isinstance(idx.value, int) \
                and not isinstance(idx.value, bool):
            k = idx.value
        elif isinstance(idx, ast.UnaryOp) and isinstance(idx.op, ast.USub) \
                and isinstance(idx.operand, ast.Constant) \
                and isinstance(idx.operand.value, int):
            k = -idx.operand.value
        if k is None:
            raise TranspileError("subscripts must use a static integer index")
        if isinstance(base, _SortedVals):
            return base.index(k, mask, self)
        if isinstance(base, _GpuList):
            # node.gpus[k]: out-of-range lanes poison (Python IndexError)
            if k < 0:
                raise TranspileError("negative gpu index not supported")
            if k >= base.padded:
                self.poison = _or(self.poison, mask)
                return _Gpu(self.nodes, 0)
            self.poison = _or(self.poison, _and(
                mask, _not(self.nodes.gpu_mask[..., k])))
            return _Gpu(self.nodes, k)
        raise TranspileError("subscript of unsupported value")

    def binop(self, op, a, b):
        ctx = self.ctx
        if _is_py(a, b):
            return _py_binop(op, a, b)
        if isinstance(op, (ast.Add, ast.Sub, ast.Mult)):
            x, y, _ = ctx.pair(a, b)
            fn = {ast.Add: torch.add, ast.Sub: torch.sub,
                  ast.Mult: torch.mul}[type(op)]
            return fn(x, y)
        if isinstance(op, ast.Div):
            return ctx.inexact(a) / ctx.inexact(b)
        if isinstance(op, ast.FloorDiv):
            x, y, k = ctx.pair(a, b)
            return _floordiv(ctx, x, y, k)
        if isinstance(op, ast.Mod):
            x, y, k = ctx.pair(a, b)
            return _mod(ctx, x, y, k)
        if isinstance(op, ast.Pow):
            if isinstance(b, int) and not isinstance(b, bool):
                x = ctx.cast(a, max(_kind(a), 1))
                return _ipow(x, b)
            x, y, _ = ctx.pair(a, b)
            return torch.pow(x, y)
        raise TranspileError("unsupported binary operator")

    def compare(self, op, a, b):
        fns = {ast.Eq: torch.eq, ast.NotEq: torch.ne, ast.Lt: torch.lt,
               ast.LtE: torch.le, ast.Gt: torch.gt, ast.GtE: torch.ge}
        fn = fns.get(type(op))
        if fn is None:
            raise TranspileError("unsupported comparison")
        if _is_py(a, b):
            return _PY_CMP[type(op)](a, b)
        x, y, _ = self.ctx.pair(a, b)
        return fn(x, y)

    def call(self, node, mask):
        ctx = self.ctx
        if node.keywords:
            raise TranspileError("keyword arguments not supported")
        f = node.func
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "math" \
                    and f.attr in _MATH_FNS:
                args = [self.eval(a, mask) for a in node.args]
                _check_arity(f"math.{f.attr}", len(args))
                return _MATH_FNS[f.attr](*(ctx.inexact(a) for a in args))
            raise TranspileError("only math.<fn> attribute calls allowed")
        if not isinstance(f, ast.Name):
            raise TranspileError("computed call targets not allowed")
        name = f.id

        # reductions over a generator comprehension
        if name in ("sum", "min", "max") and len(node.args) == 1 \
                and isinstance(node.args[0], ast.GeneratorExp):
            return self.reduce_genexp(name, node.args[0], mask)
        if name == "sorted":
            if len(node.args) == 1 \
                    and isinstance(node.args[0], ast.GeneratorExp):
                return _SortedVals(*self.genexp_grid(node.args[0], mask))
            raise TranspileError("sorted() only over a generator")

        args = [self.eval(a, mask) for a in node.args]
        _check_arity(name, len(args))
        if name == "abs":
            (a,) = args
            return abs(a) if _is_py(a) else torch.abs(a)
        if name in ("min", "max"):
            if len(args) < 2:
                raise TranspileError(f"{name}() needs 2+ args or a generator")
            fn = torch.minimum if name == "min" else torch.maximum
            py = min if name == "min" else max
            out = args[0]
            for a in args[1:]:
                if _is_py(out, a):
                    out = py(out, a)
                else:
                    x, y, _ = ctx.pair(out, a)
                    out = fn(x, y)
            return out
        if name == "len":
            (a,) = args
            if isinstance(a, (_GpuList, _SortedVals)):
                return a.count
            raise TranspileError("len() only of node.gpus or sorted(...)")
        if name == "int":
            (a,) = args
            if _is_py(a):
                if not math.isfinite(a):
                    self.poison = _or(self.poison, mask)
                    return 0
                return int(a)
            if a.is_floating_point():
                self.poison = _or(self.poison,
                                  _and(mask, ~torch.isfinite(a)))
            return _int_trunc(ctx, a)
        if name == "float":
            (a,) = args
            return float(a) if _is_py(a) else ctx.cast(a, 2)
        if name == "bool":
            (a,) = args
            return _truthy(a)
        if name == "round":
            args2 = args if len(args) == 2 else (args[0],)
            if _is_py(*args2):
                return round(*args2)
            if len(args2) == 2:
                if not isinstance(args2[1], int):
                    raise TranspileError("round() digits must be static")
                s = 10 ** args2[1]
                x = ctx.cast(args2[0], max(_kind(args2[0]), 1))
                return torch.round(x * s) / ctx.inexact(s)
            return torch.round(args2[0])
        if name == "sum":
            raise TranspileError("sum() only over a generator")
        raise TranspileError(f"call to unsupported function {name!r}")

    def genexp_grid(self, gen, mask):
        """Evaluate ``(expr for gpu in node.gpus [if cond])`` into
        ``(vals[..., N, Gp], sel[..., N, Gp])`` over the padded GPU axis."""
        if len(gen.generators) != 1:
            raise TranspileError("single-clause generators only")
        comp = gen.generators[0]
        if comp.is_async:
            raise TranspileError("async generators not allowed")
        it = self.eval_iter(comp.iter, mask)
        if not isinstance(it, _GpuList):
            raise TranspileError("generators only over node.gpus")
        if not isinstance(comp.target, ast.Name):
            raise TranspileError("generator target must be a name")
        tname = comp.target.id
        saved = self.env.get(tname)
        cols, conds = [], []
        for g in range(it.padded):
            self.env[tname] = _Gpu(self.nodes, g)
            sel = self.nodes.gpu_mask[..., g]
            for if_ in comp.ifs:
                sel = _and(sel, _truthy(self.eval(if_, mask)))
            cols.append(self.eval(gen.elt, mask))
            conds.append(torch.broadcast_to(torch.as_tensor(sel), self.shape))
        if saved is None:
            self.env.pop(tname, None)
        else:
            self.env[tname] = saved
        kind = max(_kind(c) for c in cols)
        # a column that is a Python constant takes a tensor column's dtype
        # (it is weak); with no tensor column, the constants' own kind
        vals = torch.stack([torch.broadcast_to(self.ctx.cast(c, kind),
                                               self.shape) for c in cols],
                           dim=-1)
        return vals, torch.stack(conds, dim=-1)

    def reduce_genexp(self, name, gen, mask):
        """``sum/min/max(expr for gpu in node.gpus [if cond])`` -> masked
        reduction over the padded GPU axis."""
        vals, sel = self.genexp_grid(gen, mask)
        if name == "sum":
            if vals.dtype == torch.bool:
                vals = vals.to(I32)
            zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
            return torch.where(sel, vals, zero).sum(dim=-1, dtype=vals.dtype)
        # Python min()/max() of an empty iterable raises: lanes whose
        # generator selects nothing are poisoned
        self.poison = _or(self.poison, _and(mask, ~sel.any(dim=-1)))
        if vals.is_floating_point():
            big = math.inf if name == "min" else -math.inf
        elif vals.dtype == torch.bool:
            big = name == "min"
        else:
            info = torch.iinfo(vals.dtype)
            big = info.max if name == "min" else info.min
        out = torch.where(sel, vals, torch.full((), big, dtype=vals.dtype,
                                                device=vals.device))
        return out.amin(dim=-1) if name == "min" else out.amax(dim=-1)


def _py_binop(op, a, b):
    """Both operands Python scalars: fold in Python, a zero divisor
    lowered to inf (the lane refuses later)."""
    if isinstance(op, ast.Add):
        return a + b
    if isinstance(op, ast.Sub):
        return a - b
    if isinstance(op, ast.Mult):
        return a * b
    if isinstance(op, ast.Div):
        return a / b if b != 0 else math.inf
    if isinstance(op, ast.FloorDiv):
        return a // b if b != 0 else math.inf
    if isinstance(op, ast.Mod):
        return a % b if b != 0 else math.inf
    if isinstance(op, ast.Pow):
        try:
            return a ** b
        except (OverflowError, ZeroDivisionError):
            return math.inf
    raise TranspileError("unsupported binary operator")


_PY_CMP = {
    ast.Eq: lambda a, b: a == b, ast.NotEq: lambda a, b: a != b,
    ast.Lt: lambda a, b: a < b, ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b, ast.GtE: lambda a, b: a >= b,
}


def _floordiv(ctx: _Ctx, x, y, kind: int):
    """Python ``//`` on same-kind tensors. Floats: fmod-based, as numpy
    and XLA compute it (NaN for a zero divisor); ints: exact, with XLA's
    CPU results for a zero divisor."""
    if kind == 2:
        mod = torch.fmod(x, y)
        div = (x - mod) / y
        fix = (mod != 0) & ((y < 0) != (mod < 0))
        div = torch.round(torch.where(fix, div - 1, div))
        return torch.where(y == 0, ctx.const(math.nan, 2), div)
    if kind == 0:
        x, y = x.to(I32), y.to(I32)
    zero = y == 0
    q = torch.div(x, torch.where(zero, 1, y), rounding_mode="floor")
    return torch.where(zero, torch.where(x == 0, -1, -2).to(q.dtype), q)


def _mod(ctx: _Ctx, x, y, kind: int):
    """Python ``%``: the remainder takes the divisor's sign. Floats: the
    fmod-based remainder (NaN for a zero divisor); ints: exact, 0 for a
    zero divisor (XLA's CPU result)."""
    if kind == 2:
        return torch.remainder(x, y)
    if kind == 0:
        x, y = x.to(I32), y.to(I32)
    zero = y == 0
    r = torch.remainder(x, torch.where(zero, 1, y))
    return torch.where(zero, torch.zeros_like(r), r)


_MATH_FNS = {
    "sqrt": torch.sqrt, "log": torch.log, "exp": torch.exp,
    "pow": torch.pow, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
}

#: name -> (min_args, max_args) for whitelisted calls; malformed arity must
#: reject the candidate (TranspileError), not crash the caller
_ARITY = {
    "abs": (1, 1), "len": (1, 1), "int": (1, 1), "float": (1, 1),
    "bool": (1, 1), "round": (1, 2), "min": (2, None), "max": (2, None),
    "range": (1, 3), "enumerate": (1, 1),
    "math.sqrt": (1, 1), "math.log": (1, 1), "math.exp": (1, 1),
    "math.pow": (2, 2), "math.sin": (1, 1), "math.cos": (1, 1),
    "math.tan": (1, 1),
}


def _check_arity(name: str, n: int) -> None:
    lo, hi = _ARITY.get(name, (0, None))
    if n < lo or (hi is not None and n > hi):
        raise TranspileError(f"{name}() called with {n} argument(s)")


# --------------------------------------------------------------- public API

def canonical_key(code: str) -> str:
    """Compile-cache key: the AST dump, insensitive to comments and
    whitespace."""
    return ast.dump(ast.parse(code))


def transpile(code: str, entry_point: str = "priority_function",
              dtype=torch.float64) -> PolicyFn:
    """Validate and compile candidate source into a vectorized PolicyFn
    ``(PodView, NodeView) -> i32[L, N]`` computing floats in ``dtype``.

    Raises ``TranspileError`` for code outside the lowerable subset (the
    third validation stage, after ``sandbox.validate``).
    """
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype must be torch.float64 or torch.float32, "
                         f"got {dtype}")
    r = sandbox.validate(code, entry_point)
    if not r:
        raise TranspileError(f"validation failed: {r.reason}")
    tree = ast.parse(code)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef))
    body = fn.body

    def policy(pod: PodView, nodes: NodeView):
        ctx = _Ctx(dtype, nodes.cpu_milli_left.device)
        interp = _Interp(ctx, pod, nodes)
        interp.run_block(body, True)
        val = interp.retval
        # lanes that never returned, or whose arithmetic went non-finite,
        # refuse (module docstring)
        if _is_py(val):
            val = ctx.cast(val, max(_kind(val), 1))
        if val.is_floating_point():
            val = torch.where(torch.isfinite(val), val, ctx.const(0.0, 2))
        out = _int_trunc(ctx, val).to(I32)
        keep = _and(interp.returned, _not(interp.poison))
        zero = torch.zeros((), dtype=I32, device=ctx.dev)
        if keep is True:
            out = torch.broadcast_to(out, interp.shape)
        elif keep is False:
            out = torch.zeros(interp.shape, dtype=I32, device=ctx.dev)
        else:
            out = torch.where(keep, out, zero).expand(interp.shape)
        return out.contiguous()

    policy.dtype = dtype
    policy.source = code
    _dry_trace(policy)
    return policy


def _dry_trace(policy: PolicyFn) -> None:
    """Run the lowered policy once on tiny CPU views so subset violations
    (unsupported calls, oversized unrolls, unknown attributes) surface at
    transpile time, not at the first simulation."""
    pod, nodes = tiny_views(2, 2)
    policy(pod, nodes)


def tiny_views(n: int, g: int, lanes: int = 1, device="cpu"):
    """All-zero ``(PodView, NodeView)`` of ``lanes`` lanes, ``n`` nodes and
    ``g`` GPUs, every GPU and node real: pod ``[L, 1]``, node ``[L, N]``,
    grids ``[L, N, G]``."""
    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=device)

    pod = PodView(*(z(lanes, 1) for _ in range(6)))
    nodes = NodeView(z(lanes, n), z(lanes, n), z(lanes, n), z(lanes, n),
                     z(lanes, n), z(lanes, n), z(lanes, n, g),
                     z(lanes, n, g), z(lanes, n, g),
                     torch.ones((lanes, n, g), dtype=torch.bool,
                                device=device),
                     torch.ones((lanes, n), dtype=torch.bool, device=device))
    return pod, nodes
