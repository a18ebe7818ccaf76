"""The port's LLM layer against fks_tpu's, on the CPU.

``FakeLLM`` draws from Python's ``random.Random`` as fks_tpu's does, so a
seed gives the same completions, the same validated candidates through
``CandidateGenerator`` and ``generate_many``, and the same state
round trip. ``OpenAIBackend`` runs against fks_tpu's local stub server
(tests/test_llm_stub.py; a socket on 127.0.0.1, no network).
``vm.lower_fake_candidates`` lowers the same candidates as fks_tpu's for
a seed, and their programs score the same.
"""
import numpy as np
import pytest

from fks_tpu.funsearch import llm as jllm
from fks_tpu.funsearch import vm as jvm
from fks_tpu_torch.funsearch import llm, template, vm
from tests.test_llm_stub import GOOD_LOGIC, stub_server  # noqa: F401
from tests.test_torch_vm import G, N, draw, jax_vm_scores


@pytest.mark.parametrize("seed,junk", [(0, 0.1), (7, 0.1), (11, 0.5),
                                       (3, 0.0)])
def test_fake_llm_draws_equal_fks_tpu(seed, junk):
    a, b = llm.FakeLLM(seed, junk), jllm.FakeLLM(seed, junk)
    assert [a.complete("p") for _ in range(30)] == \
        [b.complete("p") for _ in range(30)]
    state = a.getstate()
    assert state == b.getstate()
    nxt = a.complete("p")
    a.setstate(state)
    assert a.complete("p") == nxt


def test_generator_and_generate_many_equal_fks_tpu():
    parents = [(template.seed_policies()["best_fit"], 0.4)]
    gen = llm.CandidateGenerator(llm.FakeLLM(seed=5, junk_rate=0.3))
    jgen = jllm.CandidateGenerator(jllm.FakeLLM(seed=5, junk_rate=0.3))
    got = [gen.generate(parents, "fb") for _ in range(12)]
    assert got == [jgen.generate(parents, "fb") for _ in range(12)]
    assert None in got and any(c is not None for c in got)
    many = llm.generate_many(gen, 8, lambda: parents, "fb", max_workers=1)
    assert many == jllm.generate_many(jgen, 8, lambda: parents, "fb",
                                      max_workers=1)
    assert llm._strip_fences("```python\nx = 1\n```") == "x = 1"


def _backend(server, **kw):
    kw.setdefault("timeout", 2.0)
    kw.setdefault("max_retries", 0)
    return llm.OpenAIBackend(
        api_key="stub-key",
        base_url=f"http://127.0.0.1:{server.server_address[1]}/v1",
        model="stub-model", **kw)


def test_openai_backend_round_trip(stub_server):  # noqa: F811
    backend = _backend(stub_server, max_tokens=123, temperature=0.4)
    assert backend.complete(template.build_prompt([], "")) == GOOD_LOGIC
    path, body = stub_server.requests[0]
    assert path.endswith("/chat/completions")
    assert (body["model"], body["max_tokens"], body["temperature"]) == \
        ("stub-model", 123, 0.4)
    code = llm.CandidateGenerator(_backend(stub_server)).generate([], "")
    assert code is not None and "priority_function" in code


@pytest.mark.parametrize("mode,retries,ok", [
    ("fenced", 0, True), ("flaky", 1, True), ("malformed", 0, False),
    ("http500", 0, False)])
def test_openai_backend_failure_paths(stub_server, mode, retries,  # noqa: F811
                                      ok):
    stub_server.mode = mode
    code = llm.CandidateGenerator(
        _backend(stub_server, max_retries=retries)).generate([], "")
    assert (code is not None) is ok
    if ok:
        assert "```" not in code


def test_openai_backend_deadline_bounds_a_hang(stub_server):  # noqa: F811
    import time

    stub_server.mode = "hang"
    backend = _backend(stub_server, timeout=0.5, max_retries=0)
    t0 = time.monotonic()
    with pytest.raises(Exception):
        backend.complete("p")
    assert time.monotonic() - t0 < 5


def test_retry_after_parsing_equals_fks_tpu():
    from email.utils import formatdate

    for headers in ({"Retry-After": "2"}, {"Retry-After": "garbage"}, {},
                    None, {"Retry-After": formatdate(0, usegmt=True)}):
        assert llm._retry_after_seconds(headers) == \
            jllm._retry_after_seconds(headers)


def test_lower_fake_candidates_equal_fks_tpu():
    """The same FakeLLM candidates are lowered (same count), and each
    program scores on random views what fks_tpu's program for it scores."""
    progs, secs = vm.lower_fake_candidates(N, G, 6, capacity=256, seed=7)
    jprogs, jsecs = jvm.lower_fake_candidates(N, G, 6, capacity=256, seed=7)
    assert len(progs) == len(jprogs) == 6 and len(secs) == len(jsecs)
    assert all(p.capacity == 256 for p in progs)
    view, pod, (pv, nodes) = draw(1)
    for p, jp in zip(progs, jprogs):
        want = np.asarray(jax_vm_scores(jp, view, pod))
        assert np.array_equal(vm.score(p, pv, nodes).numpy(), want)
