"""The port's candidate pre-flight against fks_tpu's, on the CPU.

``analysis.preflight_check`` (verdict, taxonomy, reason, fingerprint and
the cost estimate with its ``work(G)``) over the two template seeds, the
13 discovered champions, fks_tpu's own corpus of rejected and accepted
forms (tests/test_analysis.py) and a FakeLLM stream with its junk; every
rejection reproduces as a real transpile failure in the port. The
``work_hint`` producer, ``sim.engine.static_work_hint``, prices a
candidate as fks_tpu's serving path does, and a trivial one skips the
auto-prefilter probe in both.
"""
import json
import pathlib

import pytest

from fks_tpu import analysis as janalysis
from fks_tpu.funsearch import llm as jllm
from fks_tpu.serve.artifact import ServeEngine as JaxServeEngine
from fks_tpu.sim import engine as jengine
from fks_tpu_torch import analysis
from fks_tpu_torch.funsearch import llm, template, transpiler
from fks_tpu_torch.sim import engine
from tests.test_analysis import BAD, GOOD

ROOT = pathlib.Path(__file__).resolve().parent.parent


def corpus():
    """The candidates the comparisons run over: (name, source)."""
    out = [(f"seed-{k}", v) for k, v in template.seed_policies().items()]
    for path in sorted((ROOT / "policies" / "discovered").glob(
            "funsearch_*.json")):
        code = json.loads(path.read_text()).get("code")
        if code:
            out.append((path.stem, code))
    for i, (_tax, form) in enumerate(BAD):
        out.append((f"bad-{i}", form if form.startswith("def ")
                    else template.fill_template(form)))
    for i, form in enumerate(GOOD):
        out.append((f"good-{i}", template.fill_template(form)))
    fake = llm.FakeLLM(seed=11, junk_rate=0.5)
    for i in range(40):
        out.append((f"fake-{i}", template.fill_template(fake.complete(""))))
    for i, junk in enumerate(llm.FakeLLM._JUNK):
        out.append((f"junk-{i}", template.fill_template(junk)))
    return out


def report(rep, g=8):
    return {"ok": rep.ok, "taxonomy": rep.taxonomy, "reason": rep.reason,
            "fingerprint": rep.fingerprint,
            "cost": None if rep.cost is None else (
                rep.cost.ops, rep.cost.calls, rep.cost.loop_depth,
                rep.cost.coeffs, rep.cost.work(1), rep.cost.work(g))}


def test_corpus_covers_every_verdict():
    reps = [analysis.preflight_check(code) for _, code in corpus()]
    assert sum(r.ok for r in reps) >= 15 + len(GOOD)
    assert {r.taxonomy for r in reps if not r.ok} == \
        set(analysis.REJECT_TAXONOMY) - {"duplicate_fingerprint"}


@pytest.mark.parametrize("name,code", corpus(), ids=lambda x: x
                         if isinstance(x, str) and len(x) < 40 else None)
def test_preflight_matches_fks_tpu(name, code):
    got = analysis.preflight_check(code)
    assert report(got) == report(janalysis.preflight_check(code)), name
    assert analysis.fingerprint(code) == janalysis.fingerprint(code)
    if not got.ok:  # a rejection is a real failure of the port's pipeline
        with pytest.raises(transpiler.TranspileError):
            transpiler.transpile(code)


def test_taxonomy_and_tables_equal_fks_tpu():
    from fks_tpu.analysis import candidate as jc
    from fks_tpu_torch.analysis import candidate as c

    assert analysis.REJECT_TAXONOMY == janalysis.REJECT_TAXONOMY
    for name in ("POD_FIELDS", "NODE_FIELDS", "GPU_FIELDS", "MAX_UNROLL",
                 "ARITY", "MATH_FNS", "EXPR_CALLS"):
        assert getattr(c, name) == getattr(jc, name), name


def test_fakellm_junk_stream_is_identical():
    """fks_tpu's junk stream: the same drafts, so the same verdicts."""
    a = llm.FakeLLM(seed=11, junk_rate=0.5)
    b = jllm.FakeLLM(seed=11, junk_rate=0.5)
    assert [a.complete("") for _ in range(40)] == \
        [b.complete("") for _ in range(40)]


class Events:
    def __init__(self):
        self.rows = []

    def event(self, kind, **fields):
        self.rows.append((kind, fields))


def test_work_hint_decides_the_probe_as_fks_tpu_does():
    """``static_work_hint`` = ``preflight_check(code).cost.work(g)``, as
    fks_tpu's ServeEngine computes it. A provably trivial candidate skips
    the auto-prefilter probe and keeps the dense sweep, recording the
    same event as fks_tpu; the template seeds are not trivial (the
    template's feasibility prologue alone loops over the GPUs: first_fit
    prices at 16 + 4G), so both packages probe them."""
    n, g = 1024, 8
    for name, code in template.seed_policies().items():
        hint = engine.static_work_hint(code, g)
        assert hint == JaxServeEngine._static_work_hint(code, g), name
        assert hint >= engine.PREFILTER_WORK_HINT_MIN, name
    assert engine.static_work_hint(
        template.seed_policies()["first_fit"], g) == 16 + 4 * g
    trivial = "def priority_function(pod, node):\n    return 1\n"
    hint = engine.static_work_hint(trivial, g)
    assert hint == JaxServeEngine._static_work_hint(trivial, g) == 0

    def no_probe(*_a, **_k):
        raise AssertionError("the probe ran")

    rec, jrec = Events(), Events()
    got = engine.resolve_auto_prefilter(no_probe, None, n, g, recorder=rec,
                                        work_hint=hint, device="cpu")
    want = jengine.resolve_auto_prefilter(no_probe, None, n, g,
                                          recorder=jrec, work_hint=hint)
    assert got == want == 0
    assert rec.rows == jrec.rows == [("prefilter_auto", dict(
        policy_cost_s=None, work_hint=0, chosen_k=0, n_padded=n))]
    assert engine.static_work_hint("def nope(", g) is None
