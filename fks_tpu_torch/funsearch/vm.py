"""Candidate policies as data: an aten-graph -> bytecode compiler and a
register VM on tensors.

Port of fks_tpu.funsearch.vm. A candidate becomes a ``VMProgram``, a
NamedTuple of small tensors (opcodes, operand registers, immediates, a
pool of constants), so a new candidate is a table copied into an existing
step, not a new program: one captured CUDA graph of the engines' step
serves every population of the same size and capacity bucket, as
fks_tpu's one compiled engine does.

Pipeline:
  candidate source
    -> ``transpiler.transpile`` (validation + vectorization)
    -> one run of the transpiled policy at the padded ``(n, g)`` view
       shapes under a ``TorchDispatchMode`` that records every aten op
       with its concrete inputs and output (what ``make_fx`` records, at
       a fiftieth of its cost): this port's counterpart of fks_tpu's
       jaxpr
    -> ``_Lowerer`` maps the live ops to fks_tpu's 33 opcodes, with fks_tpu's
       canonicalizations (AND->MUL, OR->MAX, NOT->1-x, NEG->x*(-1),
       literals loaded from the constant pool) plus common-subexpression
       elimination and dead-code removal
    -> ``VMProgram``, padded to a capacity bucket.

The opcode numbering, ``N_INPUTS``, ``CONST_POOL`` and the register
layout are fks_tpu's, so a program fks_tpu lowered runs unchanged on this
interpreter (``convert.vm_program_from_numpy``). The bytecode of this
front end need not equal fks_tpu's; its scores must.

Execution (``_execute``): every value lives in a register ``[L, N, G]``
of one float dtype (scalars and node values broadcast across G). The
executor walks the op slots in order; at each slot it gathers the three
operand registers of every lane, computes all 33 opcode branches and
selects each lane's — the plain PyTorch counterpart of fks_tpu's
``lax.switch`` under ``vmap`` — so the programs stay data and the slot
loop has a static length. Numeric model: the float dtype of the program
(``compile_policy(..., dtype=torch.float64)`` by default), the
transpiled tier's dtype; bools are 0/1, integer values are exact below
the mantissa, int casts truncate toward zero. A non-finite result scores
0 (refuse), then the cast to int32.

Candidates outside the vocabulary raise ``VMUnsupported``; the caller
decides what to do with them (fks_tpu's evaluator falls back to its
per-candidate tier).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fks_tpu_torch.funsearch import transpiler
from fks_tpu_torch.sim.types import NodeView, PodView

# --------------------------------------------------------------- input plan

# register ids 0..N_INPUTS-1 hold the broadcast policy inputs, in this order
_POD_FIELDS = ("cpu_milli", "memory_mib", "num_gpu", "gpu_milli",
               "creation_time", "duration_time")
_NODE_SCALARS = ("cpu_milli_left", "cpu_milli_total", "memory_mib_left",
                 "memory_mib_total", "gpu_left", "num_gpus")
_NODE_GRIDS = ("gpu_milli_left", "gpu_milli_total", "gpu_mem_total")
N_INPUTS = len(_POD_FIELDS) + len(_NODE_SCALARS) + len(_NODE_GRIDS) + 2

# Constant pool: scalar literals live in a fixed block of registers right
# after the inputs, filled from ``VMProgram.consts`` — not in op slots.
# The pool size is fixed so register numbering is identical across
# programs (stacked programs share the layout); overflow -> VMUnsupported.
CONST_POOL = 32

# opcodes (fks_tpu's numbering; the order of the executor's branch table)
(OP_NOP, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MAX, OP_MIN,
 OP_GE, OP_GT, OP_LT, OP_LE, OP_EQ, OP_NE,
 OP_SEL, OP_TRUNC, OP_FLOOR, OP_CEIL, OP_ABS, OP_SIGN,
 OP_ISFIN, OP_REM, OP_POW, OP_EXP, OP_LOG, OP_SQRT,
 OP_SIN, OP_COS, OP_TAN, OP_COL, OP_RSUM_G, OP_RMAX_G, OP_RMIN_G,
 OP_SETCOL) = range(33)
N_OPCODES = 33


class VMUnsupported(Exception):
    """Candidate uses a construct outside the VM vocabulary."""


class VMProgram(NamedTuple):
    """One lowered candidate, or a stack of them (every field with a
    leading lane axis). Pure data: the engines' population runners take
    it as their params (through ``sim.types.map_tensors``)."""

    opcode: torch.Tensor  # i32[O] (or [L, O])
    a: torch.Tensor  # i32[O] operand register
    b: torch.Tensor  # i32[O]
    c: torch.Tensor  # i32[O]
    imm: torch.Tensor  # f[O] immediate (COL/SETCOL column index)
    consts: torch.Tensor  # f[CONST_POOL] pooled scalar literals
    n_ops: torch.Tensor  # i32[] live op count
    out_reg: torch.Tensor  # i32[]

    @property
    def capacity(self) -> int:
        return int(self.opcode.shape[-1])

    @property
    def dtype(self):
        return self.consts.dtype


# ---------------------------------------------------------------- compiler

_CONST_CTORS = {"full", "scalar_tensor", "zeros", "ones", "zeros_like",
                "ones_like", "full_like"}
_ALIASES = {"expand", "clone", "alias", "detach", "contiguous", "view",
            "_unsafe_view", "reshape", "unsqueeze", "squeeze",
            "broadcast_to", "lift_fresh_copy", "lift_fresh"}
_BINARY = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV,
           "maximum": OP_MAX, "minimum": OP_MIN, "ge": OP_GE, "gt": OP_GT,
           "lt": OP_LT, "le": OP_LE, "eq": OP_EQ, "ne": OP_NE,
           "fmod": OP_REM, "pow": OP_POW}
_BOOL_BINARY = {"bitwise_and": OP_MUL, "logical_and": OP_MUL,
                "bitwise_or": OP_MAX, "logical_or": OP_MAX,
                "bitwise_xor": OP_NE, "logical_xor": OP_NE}
_UNARY = {"abs": OP_ABS, "sign": OP_SIGN, "trunc": OP_TRUNC,
          "floor": OP_FLOOR, "ceil": OP_CEIL, "exp": OP_EXP, "log": OP_LOG,
          "sqrt": OP_SQRT, "sin": OP_SIN, "cos": OP_COS, "tan": OP_TAN,
          "isfinite": OP_ISFIN}
_REDUCE = {"sum": OP_RSUM_G, "amax": OP_RMAX_G, "amin": OP_RMIN_G,
           "any": OP_RMAX_G, "all": OP_RMIN_G}


class _Const(NamedTuple):
    """A scalar literal not yet given a pool register."""

    value: float


class _Recorder(TorchDispatchMode):
    """Records every aten op a policy call dispatches, with its real
    arguments and output; the list keeps every tensor alive, so tensor
    ids name values."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[Any, tuple, dict, Any]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.calls.append((func, args, kwargs, out))
        return out


def _tensors(x):
    """The tensors in an op argument (a tensor, or a list of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


class _Lowerer:
    def __init__(self, g: int):
        self.g = g
        self.ops: List[Tuple[int, int, int, int, float]] = []
        self.consts: List[float] = []  # pool values, register N_INPUTS + i
        self.const_reg: Dict[Tuple[float, float], int] = {}
        self.cse: Dict[Tuple, int] = {}  # value numbering (all ops pure)
        self.val: Dict[int, Any] = {}  # id(tensor) -> register or _Const

    # -- emission

    def emit(self, op: int, a: int = 0, b: int = 0, c: int = 0,
             imm: float = 0.0) -> int:
        key = (op, a, b, c, float(imm))
        r = self.cse.get(key)
        if r is not None:
            return r
        self.ops.append((op, a, b, c, float(imm)))
        r = N_INPUTS + CONST_POOL + len(self.ops) - 1
        self.cse[key] = r
        return r

    def const(self, v: float) -> int:
        v = float(v)
        # the key keeps the sign bit: -0.0 == 0.0 in Python, but 1/-0 !=
        # 1/+0, so collapsing them would break sign-exactness
        key = (v, math.copysign(1.0, v))
        r = self.const_reg.get(key)
        if r is None:
            if len(self.consts) >= CONST_POOL:
                raise VMUnsupported(
                    f"more than {CONST_POOL} distinct constants")
            self.consts.append(v)
            r = N_INPUTS + len(self.consts) - 1
            self.const_reg[key] = r
        return r

    def reg(self, x) -> int:
        """The register of an op argument: a recorded value, or a
        literal."""
        if isinstance(x, (bool, int, float)):
            return self.const(float(x))
        v = self.val.get(id(x))
        if v is None:
            raise VMUnsupported(f"unbound value of shape {tuple(x.shape)}")
        if isinstance(v, _Const):
            return self.const(v.value)
        return v

    # -- lowering

    def lower(self, inputs, calls, out) -> int:
        """Lower the recorded ``calls`` the output ``out`` depends on;
        ``inputs`` are the policy's tensors in register-plan order."""
        if len(inputs) != N_INPUTS:
            raise VMUnsupported("arity mismatch")
        for i, t in enumerate(inputs):
            self.val[id(t)] = i
        live = {id(out)}
        keep = []
        for call in reversed(calls):  # dead-code removal before lowering
            if any(id(t) in live for t in _tensors(call[3])):
                keep.append(call)
                for a in list(call[1]) + list(call[2].values()):
                    live.update(id(t) for t in _tensors(a))
        for func, args, kw, res in reversed(keep):
            if not isinstance(res, torch.Tensor):
                raise VMUnsupported(f"aten op {func} with several outputs")
            self.val[id(res)] = self.call(func, args, kw, res)
        return self.reg(out)

    def _last_axis(self, dims, ndim: int) -> bool:
        dims = [dims] if isinstance(dims, int) else list(dims)
        return len(dims) == 1 and dims[0] in (-1, ndim - 1)

    def call(self, func, args, kw, res):
        name = func.__name__.split(".")[0]
        if name in _CONST_CTORS:
            if name in ("zeros", "zeros_like"):
                return _Const(0.0)
            if name in ("ones", "ones_like"):
                return _Const(1.0)
            return _Const(float(args[-1] if name != "scalar_tensor"
                                else args[0]))
        if name in _ALIASES:
            return self.val[id(args[0])]
        if name == "_to_copy":
            src = args[0].dtype
            dst = kw.get("dtype", src)
            v = self.val[id(args[0])]
            if isinstance(v, _Const):
                return _Const(_cast_const(v.value, dst))
            if dst == torch.bool and src != torch.bool:
                return self.emit(OP_NE, self.reg(args[0]), self.const(0.0))
            if src.is_floating_point and not dst.is_floating_point:
                return self.emit(OP_TRUNC, self.reg(args[0]))
            return self.reg(args[0])
        if name == "div" and kw.get("rounding_mode") is not None:
            q = self.emit(OP_DIV, self.reg(args[0]), self.reg(args[1]))
            mode = kw["rounding_mode"]
            return self.emit(OP_TRUNC if mode == "trunc" else OP_FLOOR, q)
        if name in _BINARY:
            if kw.get("alpha", 1) != 1:
                raise VMUnsupported(f"{name} with alpha")
            return self.emit(_BINARY[name], self.reg(args[0]),
                             self.reg(args[1]))
        if name == "rsub":
            return self.emit(OP_SUB, self.reg(args[1]), self.reg(args[0]))
        if name in _BOOL_BINARY:
            if any(not isinstance(x, bool) and x.dtype != torch.bool
                   for x in args[:2]):
                raise VMUnsupported(f"{name} on integers")
            return self.emit(_BOOL_BINARY[name], self.reg(args[0]),
                             self.reg(args[1]))
        if name in ("bitwise_not", "logical_not"):
            if args[0].dtype != torch.bool:
                raise VMUnsupported(f"{name} on integers")
            return self.emit(OP_SUB, self.const(1.0), self.reg(args[0]))
        if name == "neg":
            # x * -1, not 0 - x: sub flips the sign of +0.0
            return self.emit(OP_MUL, self.reg(args[0]), self.const(-1.0))
        if name == "isnan":
            r = self.reg(args[0])
            return self.emit(OP_NE, r, r)
        if name in _UNARY:
            return self.emit(_UNARY[name], self.reg(args[0]))
        if name == "where":
            cond, x, y = args
            # SEL picks operand c where the predicate holds, else b
            return self.emit(OP_SEL, self.reg(cond), self.reg(y),
                             self.reg(x))
        if name == "remainder":
            # Python's sign rule from the truncated remainder: r + y where
            # r != 0 and sign(r) != sign(y)
            x, y = self.reg(args[0]), self.reg(args[1])
            r = self.emit(OP_REM, x, y)
            zero = self.const(0.0)
            fix = self.emit(OP_MUL, self.emit(OP_NE, r, zero),
                            self.emit(OP_NE, self.emit(OP_LT, r, zero),
                                      self.emit(OP_LT, y, zero)))
            return self.emit(OP_SEL, fix, r, self.emit(OP_ADD, r, y))
        if name == "select":
            x, dim, idx = args
            shape = tuple(x.shape)
            if len(shape) == 3 and shape[-1] == self.g and \
                    dim in (-1, 2) and 0 <= idx < self.g:
                return self.emit(OP_COL, self.reg(x), imm=idx)
            raise VMUnsupported(f"select {shape} dim {dim}")
        if name == "stack":
            pieces, dim = args[0], args[1] if len(args) > 1 else 0
            shape = tuple(res.shape)
            if len(shape) == 3 and shape[-1] == self.g and dim in (-1, 2) \
                    and len(pieces) == self.g:
                # the transpiler's per-GPU generators stack G column values
                # into a grid: build a real grid register
                acc = self.const(0.0)
                for col, p in enumerate(pieces):
                    acc = self.emit(OP_SETCOL, acc, self.reg(p), imm=col)
                return acc
            raise VMUnsupported(f"stack -> {shape} along {dim}")
        if name in _REDUCE:
            x = args[0]
            dims = args[1] if len(args) > 1 else kw.get("dim")
            shape = tuple(x.shape)
            if len(shape) == 3 and shape[-1] == self.g and \
                    dims is not None and self._last_axis(dims, 3):
                return self.emit(_REDUCE[name], self.reg(x))
            raise VMUnsupported(f"reduce {name} over {dims} of {shape}")
        if name == "round":
            raise VMUnsupported("round")  # rounding-mode sensitive
        if name == "sort":
            raise VMUnsupported("sort")
        raise VMUnsupported(f"aten op {func}")


def _cast_const(v: float, dtype) -> float:
    if dtype == torch.bool:
        return 1.0 if v != 0 else 0.0
    if not dtype.is_floating_point:
        return float(math.trunc(v)) if math.isfinite(v) else v
    return v


def _dead_code(ops, out_reg: int):
    """Keep the ops the output depends on, renumbered in order: returns
    (ops, out_reg)."""
    base = N_INPUTS + CONST_POOL
    live = [False] * len(ops)
    need = {out_reg}
    for k in range(len(ops) - 1, -1, -1):
        if base + k in need:
            live[k] = True
            op, a, b, c, _ = ops[k]
            need.update((a, b, c))
    remap, kept = {}, []
    for k, op in enumerate(ops):
        if live[k]:
            remap[base + k] = base + len(kept)
            kept.append(op)

    def m(r):
        return remap.get(r, r) if r >= base else r

    return ([(op, m(a), m(b), m(c), imm) for op, a, b, c, imm in kept],
            m(out_reg))


def _record(policy, n: int, g: int):
    """``(inputs, calls, out)``: the transpiled policy run once at one
    lane, ``n`` nodes and ``g`` GPUs, every aten op recorded."""
    pod, nodes = transpiler.tiny_views(n, g)
    rec = _Recorder()
    with rec:
        out = policy(pod, nodes)
    return list(pod) + list(nodes), rec.calls, out


def compile_policy(code: str, n: int, g: int,
                   capacity: Optional[int] = None,
                   dtype=torch.float64) -> VMProgram:
    """Lower candidate source to a VMProgram for padded shapes (n, g),
    computing in ``dtype`` (CPU tensors).

    Raises TranspileError (invalid candidate) or VMUnsupported (valid but
    outside the VM vocabulary)."""
    policy = transpiler.transpile(code, dtype=dtype)
    lo = _Lowerer(g)
    out_reg = lo.lower(*_record(policy, n, g))
    if out_reg < N_INPUTS + CONST_POOL:
        # the output is an input or a literal: one op names it
        out_reg = lo.emit(OP_NOP, out_reg)
    ops, out_reg = _dead_code(lo.ops, out_reg)
    n_ops = len(ops)
    cap = capacity or capacity_bucket(n_ops)
    if n_ops > cap:
        raise VMUnsupported(f"program too long: {n_ops} ops > {cap}")
    table = torch.zeros((5, cap), dtype=torch.float64)
    if ops:
        table[:, :n_ops] = torch.tensor(ops, dtype=torch.float64).T
    pool = torch.zeros(CONST_POOL, dtype=torch.float64)
    pool[: len(lo.consts)] = torch.tensor(lo.consts, dtype=torch.float64)
    i32 = torch.int32
    return VMProgram(
        opcode=table[0].to(i32), a=table[1].to(i32), b=table[2].to(i32),
        c=table[3].to(i32), imm=table[4].to(dtype), consts=pool.to(dtype),
        n_ops=torch.tensor(n_ops, dtype=i32),
        out_reg=torch.tensor(out_reg, dtype=i32))


def compile_for_workload(code: str, workload, capacity: int = 512,
                         dtype=torch.float64) -> VMProgram:
    """``compile_policy`` with (n, g) from a workload's padded cluster
    shape — the replay / trace-diff entry point (``obs.tracing``)."""
    c = workload.cluster
    return compile_policy(code, c.n_padded, c.g_padded, capacity=capacity,
                          dtype=dtype)


# ---------------------------------------------------------------- executor

def _inputs(pod: PodView, nodes: NodeView, dtype) -> torch.Tensor:
    """[N_INPUTS, L, N, G] broadcast input registers, in ``dtype``."""
    lanes = pod.cpu_milli.shape[0]
    n, g = nodes.gpu_mask.shape[-2:]
    shape = (lanes, n, g)

    def node(x):  # [N] or [L, N]
        return x.to(dtype)[..., None].expand(shape)

    rows = [getattr(pod, f).to(dtype)[..., None].expand(shape)
            for f in _POD_FIELDS]
    rows += [node(getattr(nodes, f)) for f in _NODE_SCALARS]
    rows += [getattr(nodes, f).to(dtype).expand(shape) for f in _NODE_GRIDS]
    rows += [nodes.gpu_mask.to(dtype).expand(shape), node(nodes.node_mask)]
    return torch.stack(rows)


def _lanes(x: torch.Tensor, lanes: int, per_op: bool) -> torch.Tensor:
    """A program field per lane: ``[L, O]`` (per_op) or ``[L]``."""
    if x.dim() == (2 if per_op else 1):
        return x
    return x.expand((lanes,) + tuple(x.shape))


def _col(va, vb, vc, ck, g_iota, out):
    lanes, n, g = out.shape
    out.copy_(va.gather(2, ck.expand(lanes, n, 1)).expand(out.shape))


# The 33 opcode branches in opcode order: ``branch(va, vb, vc, ck, g_iota,
# out)`` writes the op's value into ``out`` [L, N, G] (a comparison writes
# its 0/1 straight into the float register); ``ck`` [L, 1, 1] is the
# COL / SETCOL column.
_BRANCHES = (
    lambda va, vb, vc, ck, gi, out: out.copy_(va),  # NOP: operand a
    lambda va, vb, vc, ck, gi, out: torch.add(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.sub(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.mul(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.div(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.maximum(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.minimum(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.ge(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.gt(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.lt(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.le(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.eq(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.ne(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.where(va > 0.5, vc, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.trunc(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.floor(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.ceil(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.abs(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.sign(va, out=out),
    # isfinite: x - x is +0 exactly for finite x, NaN for inf and NaN
    lambda va, vb, vc, ck, gi, out: torch.eq(va - va, 0, out=out),
    lambda va, vb, vc, ck, gi, out: torch.fmod(va, vb, out=out),  # trunc rem
    lambda va, vb, vc, ck, gi, out: torch.pow(va, vb, out=out),
    lambda va, vb, vc, ck, gi, out: torch.exp(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.log(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.sqrt(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.sin(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.cos(va, out=out),
    lambda va, vb, vc, ck, gi, out: torch.tan(va, out=out),
    _col,
    lambda va, vb, vc, ck, gi, out: out.copy_(
        va.sum(dim=2, keepdim=True).expand(out.shape)),
    lambda va, vb, vc, ck, gi, out: out.copy_(
        va.amax(dim=2, keepdim=True).expand(out.shape)),
    lambda va, vb, vc, ck, gi, out: out.copy_(
        va.amin(dim=2, keepdim=True).expand(out.shape)),
    # SETCOL: column ck := vb
    lambda va, vb, vc, ck, gi, out: torch.where(gi == ck, vb, va, out=out),
)
assert len(_BRANCHES) == N_OPCODES


def _execute(prog: VMProgram, pod: PodView, nodes: NodeView,
             bound: int) -> torch.Tensor:
    """Run ``bound`` op slots of ``prog`` (one program shared by every
    lane, or one per lane) over each lane's views: i32[L, N].

    Per-lane programs compute every branch at each slot and gather each
    lane's (no host read, so the loop captures in a CUDA graph). One
    program (unstacked, or a stack of one) whose op table sits on the host
    (the CPU path) runs only its own op at each slot: the same branch
    code, so the same values."""
    f = prog.dtype
    inp = _inputs(pod, nodes, f)
    lanes, n, g = inp.shape[1:]
    dev = inp.device
    consts = _lanes(prog.consts, lanes, True)  # [L, CONST_POOL]
    pool = consts.T[:, :, None, None].expand(-1, -1, n, g)
    op_base = N_INPUTS + consts.shape[1]
    regs = torch.empty((op_base + prog.capacity, lanes, n, g), dtype=f,
                       device=dev)
    regs[:N_INPUTS] = inp
    regs[N_INPUTS:op_base] = pool
    g_iota = torch.arange(g, device=dev)
    shared = prog.opcode.dim() == 1 or prog.opcode.shape[0] == 1
    if shared and prog.opcode.device.type == "cpu":
        cap = prog.capacity
        ops = torch.stack([
            x.reshape(-1, cap)[0].to(torch.int64) for x in (
                prog.opcode, prog.a, prog.b, prog.c,
                prog.imm.to(torch.int64).clamp(0, g - 1))
        ]).T[:bound].tolist()
        for k, (op, a, b, c, col) in enumerate(ops):
            ck = torch.full((1, 1, 1), col, dtype=torch.int64, device=dev)
            _BRANCHES[op](regs[a], regs[b], regs[c], ck.expand(lanes, 1, 1),
                          g_iota, regs[op_base + k])
    else:
        ar = torch.arange(lanes, device=dev)
        opcode = _lanes(prog.opcode, lanes, True).long()
        abc = torch.stack([_lanes(prog.a, lanes, True),
                           _lanes(prog.b, lanes, True),
                           _lanes(prog.c, lanes, True)], dim=1).long()
        imm = _lanes(prog.imm, lanes, True)
        col = imm.to(torch.int64).clamp(0, g - 1)  # COL / SETCOL column
        # every branch writes its slice of one table (no stack copy)
        table = torch.empty((N_OPCODES, lanes, n, g), dtype=f, device=dev)
        t = table.unbind(0)
        for k in range(bound):
            opnd = regs[abc[:, :, k], ar[:, None]]  # [L, 3, N, G]
            va, vb, vc = opnd[:, 0], opnd[:, 1], opnd[:, 2]
            ck = col[:, k, None, None]  # [L, 1, 1]
            for branch, out in zip(_BRANCHES, t):
                branch(va, vb, vc, ck, g_iota, out)
            pick = opcode[:, k].view(1, lanes, 1, 1).expand(1, lanes, n, g)
            torch.gather(table, 0, pick, out=regs[op_base + k][None])
    out_reg = _lanes(prog.out_reg, lanes, False).long()
    out = regs[out_reg, torch.arange(lanes, device=dev)][..., 0]
    # a non-finite value (a division by zero, the log of a negative) would
    # hit the int cast with implementation-defined results: refuse instead
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.to(torch.int32)


def score(prog: VMProgram, pod: PodView, nodes: NodeView) -> torch.Tensor:
    """Execute a lowered candidate -> i32[L, N] scores.

    The signature matches ``ParamPolicyFn`` with the program as the
    params, so every engine runner accepts VM candidates unchanged. The
    loop runs the live op count when the program's ``n_ops`` sits on the
    host (reading it costs nothing), else the padded capacity, which is
    what ``score_static`` runs — padding slots are NOPs that no output
    reads, so the scores are the same."""
    if prog.n_ops.device.type == "cpu":
        return _execute(prog, pod, nodes, int(prog.n_ops.max()))
    return _execute(prog, pod, nodes, prog.capacity)


def score_static(prog: VMProgram, pod: PodView, nodes: NodeView) -> torch.Tensor:
    """``score`` with a static trip count, the padded capacity — the
    population variant: no lane's op count is read, so a step that runs
    it makes no host sync and captures in a CUDA graph. Stack candidates
    with ``stack_programs`` and pass this as the ``param_policy`` of a
    population runner."""
    return _execute(prog, pod, nodes, prog.capacity)


# One call launches some 40 kernels per op slot, tens of thousands per
# step: a captured CUDA graph holds one step of it (capturing 16 would
# take half a minute for no gain). ``engine.bind_step`` hands this to
# every runner's graph.
score.graph_steps = score_static.graph_steps = 1


def capacity_bucket(n_ops: int) -> int:
    """Program-capacity bucket for ``n_ops`` live ops: the smallest power
    of two covering it, floored at 64."""
    return max(64, 1 << max(0, int(n_ops) - 1).bit_length())


def pad_capacity(prog: VMProgram, capacity: int) -> VMProgram:
    """Re-pad a program's op arrays to ``capacity`` (NOP fill)."""
    n_live = int(prog.n_ops.max())
    if n_live > capacity:
        raise VMUnsupported(f"program too long: {n_live} ops > {capacity}")
    cur = prog.capacity
    if cur == capacity:
        return prog
    if cur < capacity:
        pad = capacity - cur

        def ext(x, fill):
            tail = torch.full(tuple(x.shape[:-1]) + (pad,), fill,
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=-1)

        return prog._replace(
            opcode=ext(prog.opcode, OP_NOP), a=ext(prog.a, 0),
            b=ext(prog.b, 0), c=ext(prog.c, 0), imm=ext(prog.imm, 0.0))
    return prog._replace(
        opcode=prog.opcode[..., :capacity], a=prog.a[..., :capacity],
        b=prog.b[..., :capacity], c=prog.c[..., :capacity],
        imm=prog.imm[..., :capacity])


def stack_programs(progs: Sequence[VMProgram],
                   capacity: Optional[int] = None) -> VMProgram:
    """Stack lowered candidates into one batched ``VMProgram`` (a leading
    lane axis on every field). The shared capacity defaults to the
    smallest power of two covering the longest member (min 32)."""
    if not progs:
        raise ValueError("stack_programs needs at least one program")
    longest = max(int(p.n_ops) for p in progs)
    cap = capacity or max(32, 1 << max(0, (longest - 1)).bit_length())
    padded = [pad_capacity(p, cap) for p in progs]
    return VMProgram(*(torch.stack(xs) for xs in zip(*padded)))


def select_slot(stacked: VMProgram, slot) -> VMProgram:
    """One member of a ``stack_programs`` stack by slot index (an int, or
    a tensor of per-lane slots, which gathers one program per lane)."""
    return VMProgram(*(x[slot] for x in stacked))


def bucket_lanes(n: int, multiple: int = 1) -> int:
    """Lane count for a batch of ``n`` programs: the next power of two
    (so a captured population graph is reused per bucket, never per
    generation), rounded up to a multiple of ``multiple``."""
    pop = max(1, 1 << (max(1, n) - 1).bit_length())
    return -(-pop // multiple) * multiple


def lower_fake_candidates(n: int, g: int, need: int, *, capacity: int = 256,
                          seed: int = 7, max_tries_factor: int = 12):
    """Generate and lower ``need`` FakeLLM candidates to VM programs —
    fks_tpu's shared candidate source for code-candidate throughput: the
    same seed gives the same candidates there and here. Deterministic
    FakeLLM completions (no junk), template-filled, lowered with
    ``compile_policy``; candidates outside the vocabulary or longer than
    ``capacity`` are skipped. Returns ``(progs, lower_seconds)``, the
    host lowering time of each kept candidate. At most
    ``max_tries_factor * need`` attempts, so callers check
    ``len(progs)`` against ``need``."""
    import time as _time

    from fks_tpu_torch.funsearch import llm, template

    fake = llm.FakeLLM(seed=seed, junk_rate=0.0)
    progs: List[VMProgram] = []
    lower_s: List[float] = []
    for _ in range(max_tries_factor * need):
        if len(progs) >= need:
            break
        code = template.fill_template(fake.complete("x"))
        t0 = _time.perf_counter()
        try:
            prog = compile_policy(code, n, g, capacity=capacity)
        except Exception:  # noqa: BLE001 — outside the VM vocabulary
            continue
        lower_s.append(_time.perf_counter() - t0)
        progs.append(prog)
    return progs, lower_s
