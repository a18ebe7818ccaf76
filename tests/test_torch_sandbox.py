"""fks_tpu_torch.funsearch.sandbox and template vs fks_tpu's: the same
verdicts and reasons on the cases of tests/test_funsearch_sandbox.py, the
same scalar results, and byte-identical templates, prompts and seeds."""
import signal

import pytest

from fks_tpu.funsearch import sandbox as jsandbox
from fks_tpu.funsearch import template as jtemplate
from fks_tpu_torch.funsearch import sandbox, template

GOOD = template.fill_template(
    "score = 100 + pod.cpu_milli / max(1, node.cpu_milli_left)")

CASES = [
    GOOD,
    template.fill_template("import os"),
    template.fill_template("score = __builtins__"),
    template.fill_template("score = eval('1')"),
    template.fill_template("score = exec('x = 1')"),
    template.fill_template("score = open('/etc/passwd')"),
    template.fill_template("score = getattr(pod, 'cpu_milli')"),
    template.fill_template("score = (lambda: 1)()"),
    template.fill_template("while True:\n        score = 1"),
    template.fill_template("score = max(*node.gpus)"),
    template.fill_template("score = print(1)"),
    "def priority_function(pod, node):\n    f = lambda: 1\n    return 1",
    "def priority_function(pod, node):\n    x = node.gpus[0:1]\n    return 1",
    "def priority_function(a, b):\n    return 1",
    "def other(pod, node):\n    return 1",
    "def priority_function(pod, node):\n    return 1\nx = 2",
    "def priority_function(pod, node:\n    return 1",
    "def priority_function(pod, node):\n    def g():\n        return 1\n"
    "    return 1",
    "def priority_function(pod, node):\n    return node._secret",
    "def priority_function(pod, node):\n    return math.floor(1.5)",
] + list(template.seed_policies().values())


@pytest.mark.parametrize("i", range(len(CASES)))
def test_verdicts_and_reasons_match(i):
    code = CASES[i]
    got, want = sandbox.validate(code), jsandbox.validate(code)
    assert (bool(got), got.reason) == (bool(want), want.reason)
    got = sandbox.validate_structure(code)
    want = jsandbox.validate_structure(code)
    assert (bool(got), got.reason) == (bool(want), want.reason)
    assert sandbox.validate_source_text(code).reason == \
        jsandbox.validate_source_text(code).reason


def test_templates_prompts_and_seeds_are_identical():
    assert template.TEMPLATE == jtemplate.TEMPLATE
    assert template.seed_policies() == jtemplate.seed_policies()
    parents = [(GOOD, 0.5), (template.seed_policies()["best_fit"], 0.44)]
    assert template.build_prompt(parents, "more packing") == \
        jtemplate.build_prompt(parents, "more packing")
    assert template.build_prompt([]) == jtemplate.build_prompt([])
    # a block emitted at column 0 is re-indented the same way
    logic = "a = 1\nif pod.num_gpu > 0:\n    a = 2\nscore = a"
    assert template.fill_template(logic) == jtemplate.fill_template(logic)
    for code in (GOOD, "not a template"):
        assert template.logic_of(code) == jtemplate.logic_of(code)


def test_seed_policies_validate_and_run():
    for name, code in template.seed_policies().items():
        assert sandbox.validate(code), name
        assert sandbox.smoke_test(code) is None, name


def _pair():
    pod = sandbox.ScalarPod(cpu_milli=1000, memory_mib=2048, num_gpu=1,
                            gpu_milli=300)
    node = sandbox.ScalarNode(
        cpu_milli_left=5000, cpu_milli_total=8000,
        memory_mib_left=9000, memory_mib_total=16000, gpu_left=2,
        gpus=(sandbox.ScalarGPU(700, 1000), sandbox.ScalarGPU(200, 1000)))
    return pod, node


@pytest.mark.parametrize("logic", [
    "score = node.cpu_milli_left - pod.cpu_milli",
    "score = 10000 * (node.memory_mib_left - pod.memory_mib)"
    " / max(1, node.memory_mib_total)",
    "score = sum(g.gpu_milli_left for g in node.gpus) % 7 + math.sqrt(9)",
])
def test_scalar_execution_matches(logic):
    code = template.fill_template(logic)
    pod, node = _pair()
    jpod = jsandbox.ScalarPod(**pod.__dict__)
    jnode = jsandbox.ScalarNode(**{**node.__dict__, "gpus": tuple(
        jsandbox.ScalarGPU(**g.__dict__) for g in node.gpus)})
    assert sandbox.execute_scalar(code, pod, node) == \
        jsandbox.execute_scalar(code, jpod, jnode)
    assert sandbox.execute_scalar(template.fill_template(
        "score = node.cpu_milli_left - pod.cpu_milli"), pod, node) == 4000.0


@pytest.mark.parametrize("logic,reason", [
    ("score = 1 / (pod.num_gpu - pod.num_gpu)", "execution failed"),
    ("score = float('nan')", "execution failed"),
])
def test_runtime_errors_raise_policy_error(logic, reason):
    code = template.fill_template(logic)
    pod = sandbox.ScalarPod(1, 1, 0, 0)
    node = sandbox.ScalarNode(1000, 1000, 1000, 1000, 0, ())
    with pytest.raises(sandbox.PolicyRuntimeError) as err:
        sandbox.execute_scalar(code, pod, node)
    with pytest.raises(jsandbox.PolicyRuntimeError) as jerr:
        jsandbox.execute_scalar(code, jsandbox.ScalarPod(1, 1, 0, 0),
                                jsandbox.ScalarNode(1000, 1000, 1000, 1000,
                                                    0, ()))
    assert str(err.value) == str(jerr.value) and reason in str(err.value)


def test_non_numeric_and_infeasible_results():
    pod = sandbox.ScalarPod(cpu_milli=99999, memory_mib=1, num_gpu=0,
                            gpu_milli=0)
    node = sandbox.ScalarNode(1000, 1000, 1000, 1000, 0, ())
    assert sandbox.execute_scalar(GOOD, pod, node) == 0.0
    bad = "def priority_function(pod, node):\n    return True"
    with pytest.raises(sandbox.PolicyRuntimeError, match="non-numeric"):
        sandbox.execute_scalar(bad, pod, node)
    with pytest.raises(sandbox.PolicyRuntimeError, match="validation"):
        sandbox.compile_policy("import os")


BOMB = template.fill_template(
    "score = 0\n"
    "    for i in range(1000000000):\n"
    "        score = score + 1")


def test_range_bomb_times_out_and_restores_signals():
    assert sandbox.validate(BOMB)
    pod = sandbox.ScalarPod(1, 1, 0, 0)
    node = sandbox.ScalarNode(1000, 1000, 1000, 1000, 0, ())
    import time
    old = signal.getsignal(signal.SIGALRM)
    t0 = time.monotonic()
    with pytest.raises(sandbox.PolicyTimeoutError):
        sandbox.execute_scalar(BOMB, pod, node, timeout_s=0.2)
    assert time.monotonic() - t0 < 2.0
    assert signal.getsignal(signal.SIGALRM) == old
    sandbox.execute_scalar(GOOD, pod, node, timeout_s=0.5)
    assert signal.getsignal(signal.SIGALRM) == old


def test_environment_is_the_whitelist():
    env, jenv = sandbox.safe_environment(), jsandbox.safe_environment()
    assert sorted(env) == sorted(jenv)
    assert env["__builtins__"] == {}
    assert sorted(vars(env["math"])) == sorted(vars(jenv["math"]))
    assert (sandbox.SAFE_BUILTINS, sandbox.SAFE_MATH, sandbox.SAFE_OPERATOR,
            sandbox.FORBIDDEN_SUBSTRINGS, sandbox.EXEC_TIMEOUT_S) == (
        jsandbox.SAFE_BUILTINS, jsandbox.SAFE_MATH, jsandbox.SAFE_OPERATOR,
        jsandbox.FORBIDDEN_SUBSTRINGS, jsandbox.EXEC_TIMEOUT_S)
