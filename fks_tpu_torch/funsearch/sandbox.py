"""Candidate-code validation and the host-side scalar sandbox.

Port of fks_tpu.funsearch.sandbox (a copy: the same whitelists, verdicts
and reasons). Validation runs in two static stages, as in the reference
sandbox (reference: funsearch/safe_execution.py:15-168 ``SafeExecutor``):
a lowercased-substring blacklist, then an AST walk with a call whitelist.
Accepted code must also transpile to a vectorized PyTorch policy
(``funsearch.transpiler``), which lowers data-dependent Python control
flow (if/else -> masked blends) or rejects it.

The scalar executor serves two roles:
- a smoke test that candidate code runs at all on one (pod, node) pair
  (reference: safe_execution.py:126-168, 319-328);
- the oracle for transpiler differential tests: the transpiled policy
  must agree with this per-node scalar execution on every node.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import math
import operator
import signal
import threading
from typing import Optional, Sequence

# ---------------------------------------------------------------- whitelists

#: Builtins visible to candidate code (reference: safe_execution.py:19-22).
SAFE_BUILTINS = (
    "abs", "min", "max", "sum", "len", "range", "enumerate", "int", "float",
    "bool", "str", "round", "sorted",
)
#: math functions (reference: safe_execution.py:24).
SAFE_MATH = ("sqrt", "log", "exp", "pow", "sin", "cos", "tan")
#: operator-module functions (reference: safe_execution.py:26-27).
SAFE_OPERATOR = ("add", "sub", "mul", "truediv", "mod")

#: Lowercased substrings that reject a candidate outright (reference:
#: safe_execution.py:29-33,73-79 — the reference checks 'import', '__', and
#: exec/eval-style escapes anywhere in the lowercased source).
FORBIDDEN_SUBSTRINGS = (
    "import", "__", "exec", "eval", "compile", "open(", "globals", "locals",
    "getattr", "setattr", "delattr", "vars(", "dir(", "input(", "breakpoint",
    "lambda", "yield", "while", "class ", "global ", "nonlocal ",
)

#: AST statement/expression node types candidate code may contain.
_ALLOWED_NODES = (
    ast.Module, ast.FunctionDef, ast.arguments, ast.arg,
    ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr, ast.Pass,
    ast.Return, ast.If, ast.IfExp, ast.For, ast.Compare, ast.BoolOp,
    ast.BinOp, ast.UnaryOp, ast.Call, ast.Attribute, ast.Name, ast.Constant,
    # NB: ast.Index is never produced on py3.9+ and ast.Slice (a[1:2])
    # was dead weight — the transpiler rejects any non-static-int
    # subscript, so slice syntax is denied here, one stage earlier
    ast.Tuple, ast.List, ast.Subscript,
    ast.GeneratorExp, ast.comprehension, ast.keyword,
    ast.Load, ast.Store,
    ast.And, ast.Or, ast.Not,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
)


@dataclasses.dataclass
class ValidationResult:
    ok: bool
    reason: str = ""

    def __bool__(self) -> bool:
        return self.ok


def validate_source_text(code: str) -> ValidationResult:
    """Stage 1: substring blacklist over the lowercased source
    (reference: safe_execution.py:73-79)."""
    low = code.lower()
    for bad in FORBIDDEN_SUBSTRINGS:
        if bad in low:
            return ValidationResult(False, f"forbidden construct: {bad!r}")
    return ValidationResult(True)


def validate_structure(code: str,
                       entry_point: str = "priority_function") -> ValidationResult:
    """Stage 2: AST walk (reference: safe_execution.py:38-64) — exactly one
    top-level function with the canonical (pod, node) signature, only
    whitelisted node types, only whitelisted calls, no dunder attributes."""
    try:
        tree = ast.parse(code)
    except SyntaxError as e:
        return ValidationResult(False, f"syntax error: {e}")

    funcs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    if len(funcs) != 1 or funcs[0].name != entry_point:
        return ValidationResult(
            False, f"must define exactly one function {entry_point!r}")
    if [a.arg for a in funcs[0].args.args] != ["pod", "node"]:
        return ValidationResult(False, "signature must be (pod, node)")
    others = [n for n in tree.body if not isinstance(n, (ast.FunctionDef,))]
    if any(not (isinstance(n, ast.Expr)
                and isinstance(n.value, ast.Constant)) for n in others):
        return ValidationResult(False, "top level must be the function only")

    allowed_calls = set(SAFE_BUILTINS)
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            return ValidationResult(
                False, f"disallowed syntax: {type(node).__name__}")
        if isinstance(node, ast.FunctionDef) and node is not funcs[0]:
            return ValidationResult(False, "nested functions are not allowed")
        if isinstance(node, ast.Attribute):
            if node.attr.startswith("_"):
                return ValidationResult(
                    False, f"private attribute: {node.attr!r}")
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                if f.id not in allowed_calls:
                    return ValidationResult(
                        False, f"call to non-whitelisted {f.id!r}")
            elif isinstance(f, ast.Attribute):
                if not (isinstance(f.value, ast.Name) and f.value.id == "math"
                        and f.attr in SAFE_MATH):
                    return ValidationResult(
                        False, "only math.<whitelisted> attribute calls allowed")
            else:
                return ValidationResult(False, "computed call targets not allowed")
    return ValidationResult(True)


def validate(code: str, entry_point: str = "priority_function") -> ValidationResult:
    """Both static stages. The third stage is ``transpiler.transpile``
    itself (raises TranspileError)."""
    r = validate_source_text(code)
    if not r:
        return r
    return validate_structure(code, entry_point)


# ------------------------------------------------- scalar entities + executor

@dataclasses.dataclass
class ScalarGPU:
    """One GPU as candidate code sees it (reference: simulator/entities.py:4-10)."""
    gpu_milli_left: int
    gpu_milli_total: int
    memory_mib_left: int = 0
    memory_mib_total: int = 0


@dataclasses.dataclass
class ScalarNode:
    """One node as candidate code sees it (reference: simulator/entities.py:12-21)."""
    cpu_milli_left: int
    cpu_milli_total: int
    memory_mib_left: int
    memory_mib_total: int
    gpu_left: int
    gpus: Sequence[ScalarGPU] = ()


@dataclasses.dataclass
class ScalarPod:
    """The pod as candidate code sees it (reference: simulator/entities.py:29-43)."""
    cpu_milli: int
    memory_mib: int
    num_gpu: int
    gpu_milli: int
    creation_time: int = 0
    duration_time: int = 0


def safe_environment() -> dict:
    """Restricted globals for candidate execution (reference:
    safe_execution.py:98-124): whitelisted builtins + ``math`` facade +
    operator functions, nothing else."""
    env = {"__builtins__": {}}
    import builtins
    for name in SAFE_BUILTINS:
        env[name] = getattr(builtins, name)

    class _Math:
        pass

    m = _Math()
    for name in SAFE_MATH:
        setattr(m, name, getattr(math, name))
    env["math"] = m
    for name in SAFE_OPERATOR:
        env[name] = getattr(operator, name)
    return env


class PolicyRuntimeError(RuntimeError):
    """Candidate code raised during scalar execution."""


class PolicyTimeoutError(PolicyRuntimeError):
    """Candidate code exceeded the scalar-execution deadline."""


#: Wall-clock budget for one scalar candidate call. The whitelist admits
#: ``range`` loops the transpiler has not yet bounded, so a validated
#: candidate can still be a `for i in range(10**9)` bomb; the reference
#: arms SIGALRM for the same reason (safe_execution.py:81-96).
EXEC_TIMEOUT_S = 5.0


@contextlib.contextmanager
def _deadline(seconds: Optional[float]):
    """SIGALRM-backed wall-clock guard around candidate execution.

    Signals only arm in the main thread; elsewhere (e.g. a generation
    thread pool) this is a no-op — safe there as long as the caller
    transpiles BEFORE smoke-testing, as fks_tpu's candidate generator
    does: the transpiler's MAX_UNROLL bound rejects unbounded loops
    first."""
    if (not seconds
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def _onalarm(signum, frame):
        raise PolicyTimeoutError(
            f"candidate exceeded the {seconds:g}s scalar deadline")

    import time
    old = signal.signal(signal.SIGALRM, _onalarm)
    t0 = time.monotonic()
    prev_delay, prev_interval = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        # Alarm-safe cleanup: a fire in the instants after the candidate
        # finishes must neither skip the handler restore nor surface as a
        # timeout for a call that completed in time. Block the signal for
        # the whole cleanup, consume any pending fire, then restore the
        # previous handler/timer (re-arming an outer watchdog minus our
        # elapsed time).
        try:
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            masked = True
        except (AttributeError, OSError, ValueError):
            masked = False
        try:
            if prev_delay:
                signal.setitimer(
                    signal.ITIMER_REAL,
                    max(0.001, prev_delay - (time.monotonic() - t0)),
                    prev_interval)
            else:
                signal.setitimer(signal.ITIMER_REAL, 0.0)
            if masked and hasattr(signal, "sigtimedwait"):
                signal.sigtimedwait([signal.SIGALRM], 0)
        finally:
            if masked and not hasattr(signal, "sigtimedwait"):
                # no sigtimedwait (macOS): drain a pending fire into
                # SIG_IGN before the old disposition returns — otherwise
                # unblocking delivers it to SIG_DFL and kills the process
                signal.signal(signal.SIGALRM, signal.SIG_IGN)
                signal.pthread_sigmask(
                    signal.SIG_UNBLOCK, {signal.SIGALRM})
                signal.pthread_sigmask(
                    signal.SIG_BLOCK, {signal.SIGALRM})
            signal.signal(signal.SIGALRM, old)
            if masked:
                signal.pthread_sigmask(
                    signal.SIG_UNBLOCK, {signal.SIGALRM})


def compile_policy(code: str, entry_point: str = "priority_function"):
    """Validate then compile candidate source once in the restricted
    environment; returns the scalar ``(pod, node) -> number`` callable
    (reference: funsearch_integration.py:77-89 compile-once path)."""
    r = validate(code, entry_point)
    if not r:
        raise PolicyRuntimeError(f"validation failed: {r.reason}")
    env = safe_environment()
    try:
        exec(code, env)  # noqa: S102 — restricted env, validated source
    except Exception as e:
        raise PolicyRuntimeError(f"compile failed: {e}") from e
    fn = env.get(entry_point)
    if not callable(fn):
        raise PolicyRuntimeError(f"{entry_point} not defined by candidate")
    return fn


def execute_scalar(code: str, pod: ScalarPod, node: ScalarNode,
                   entry_point: str = "priority_function",
                   timeout_s: Optional[float] = EXEC_TIMEOUT_S) -> float:
    """One-shot validated scalar run returning a finite float (reference:
    safe_execution.py:126-168). Used for smoke tests and as the transpiler
    differential-test oracle. A SIGALRM deadline (main thread only, see
    ``_deadline``) fails a looping candidate fast instead of hanging the
    host; ``timeout_s=None`` disables it."""
    fn = compile_policy(code, entry_point)
    try:
        with _deadline(timeout_s):
            out = fn(pod, node)
    except PolicyTimeoutError:
        raise
    except Exception as e:
        raise PolicyRuntimeError(f"execution failed: {e}") from e
    if isinstance(out, bool) or not isinstance(out, (int, float)):
        raise PolicyRuntimeError(f"non-numeric result: {out!r}")
    if math.isnan(out) or math.isinf(out):
        raise PolicyRuntimeError("non-finite result")
    return float(out)


def smoke_test(code: str) -> Optional[str]:
    """Run the candidate on one tiny (pod, node) pair; None if healthy, else
    the failure reason (reference: safe_execution.py:319-328
    ``test_policy_safely``)."""
    pod = ScalarPod(cpu_milli=500, memory_mib=1024, num_gpu=1, gpu_milli=250)
    node = ScalarNode(
        cpu_milli_left=4000, cpu_milli_total=8000,
        memory_mib_left=8192, memory_mib_total=16384, gpu_left=2,
        gpus=(ScalarGPU(1000, 1000, 8000, 8000), ScalarGPU(500, 1000, 8000, 8000)))
    try:
        execute_scalar(code, pod, node)
    except PolicyRuntimeError as e:
        return str(e)
    return None
