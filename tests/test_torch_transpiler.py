"""fks_tpu_torch.funsearch.transpiler vs fks_tpu's.

- Integer scores equal fks_tpu's transpiled policy (x64, run op by op —
  IEEE float64 like the port's) on random views of 256 lanes x 16 nodes x
  8 GPUs, for the two template seeds, 30 ``FakeLLM(seed=3)`` candidates
  (fks_tpu's FakeLLM, used only to make source text) and the 13
  discovered champions.
- The differential blocks of tests/test_transpiler.py agree with the
  scalar sandbox oracle and with fks_tpu, node for node.
- The same sources are rejected (``TranspileError``), and the nonfinite
  and poison cases refuse the same lanes.
- ``canonical_key`` is fks_tpu's.
"""
import glob
import json
import pathlib
import zlib

import jax
import numpy as np
import pytest
import torch

from fks_tpu.funsearch import llm
from fks_tpu.funsearch import transpiler as jtranspiler
from fks_tpu.sim.types import NodeView as JNodeView
from fks_tpu.sim.types import PodView as JPodView
from fks_tpu_torch.funsearch import sandbox, template, transpiler
from fks_tpu_torch.sim.types import NodeView, PodView
from fks_tpu_torch.testing import one_torch_thread
from tests.test_torch_policies import port_views, random_views
from tests.test_transpiler import LOGIC_BLOCKS, random_state

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def champions():
    return [json.loads(pathlib.Path(f).read_text())["code"] for f in
            sorted(glob.glob(str(ROOT / "policies" / "discovered"
                                 / "funsearch_*.json")))]


def fake_llm_candidates(n=30, seed=3):
    fake = llm.FakeLLM(seed=seed, junk_rate=0.0)
    return [template.fill_template(fake.complete("x")) for _ in range(n)]


CORPORA = {
    "seeds": lambda: list(template.seed_policies().values()),
    "fake_llm": fake_llm_candidates,
    "champions": champions,
}


def jax_scores(policy, view, pod):
    """fks_tpu's policy over the lanes with ``vmap`` run op by op (not
    jitted: no fused multiply-adds or reciprocal rewrites)."""
    def lane(cl, ml, gl, gml, pc, pm, pg, pmi, pct, pd, ct, mt, ng, gmt, gm,
             nm):
        nodes = JNodeView(cl, ct, ml, mt, gl, ng, gml, gmt, gmt, gm, nm)
        return policy(JPodView(pc, pm, pg, pmi, pct, pd), nodes)

    lanes = (view["cpu_left"], view["mem_left"], view["gpu_left"],
             view["gml"], pod["cpu"], pod["mem"], pod["ngpu"], pod["milli"],
             pod["ctime"], pod["dur"])
    shared = (view["cpu_total"], view["mem_total"], view["num_gpus"],
              view["gmt"], view["gm"], view["nm"])
    return np.asarray(jax.vmap(lane, in_axes=(0,) * 10 + (None,) * 6)(
        *lanes, *shared))


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_corpus_scores_match_fks_tpu(corpus):
    codes = CORPORA[corpus]()
    assert len(codes) == {"seeds": 2, "fake_llm": 30, "champions": 13}[corpus]
    # candidate i scores draw i % 2 (the second draw asks for GPUs)
    draws = [random_views(seed, gpu_heavy=seed == 1) for seed in (0, 1)]
    for i, code in enumerate(codes):
        policy = transpiler.transpile(code)
        jpolicy = jtranspiler.transpile(code)
        view, pod, _ = draws[i % 2]
        pv, nodes = port_views(view, pod)
        got = policy(pv, nodes)
        assert got.dtype == torch.int32 and got.shape == (256, 16)
        np.testing.assert_array_equal(got.numpy(),
                                      jax_scores(jpolicy, view, pod))


def one_lane(pod, nodes):
    """fks_tpu's one-lane views (tests/test_transpiler.random_state) as
    the port's: pod [1, 1], node fields [1, N], grids [1, N, G]."""
    def t(x):
        return torch.from_numpy(np.array(x))[None]

    pv = PodView(*(torch.tensor([[int(x)]], dtype=torch.int32) for x in pod))
    return pv, NodeView(*(t(x).to(torch.bool) if i >= 9 else
                          t(x).to(torch.int32) for i, x in enumerate(nodes)))


@pytest.mark.parametrize("name", sorted(LOGIC_BLOCKS))
def test_logic_blocks_match_oracle_and_fks_tpu(name):
    code = template.fill_template(LOGIC_BLOCKS[name])
    policy = transpiler.transpile(code)
    jpolicy = jtranspiler.transpile(code)
    fn = sandbox.compile_policy(code)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for trial in range(4):
        pod, nodes, spod, snodes = random_state(rng)
        got = policy(*one_lane(pod, nodes))[0].tolist()
        assert got == [int(fn(spod, sn)) for sn in snodes], (name, trial)
        assert got == np.asarray(jpolicy(pod, nodes)).tolist()


BAD_LOGIC = [
    "score = sorted(node.gpus)",
    "for i in range(1000000):\n        score = 1",
    "score = node.gpus[pod.num_gpu].gpu_milli_left",
    "score = pod.nonexistent_field",
    "score = abs()",
    "score = min(5)",
    "score = math.sqrt(1, 2)",
    "for i in range():\n        score = 1",
    "xs = sorted(g.gpu_milli_left for g in node.gpus)\n"
    "    if pod.num_gpu > 0:\n"
    "        xs = 1.0\n"
    "    score = 1",
    "score = 'text'",
    "pod = 3\n    score = 1",
]


@pytest.mark.parametrize("logic", BAD_LOGIC)
def test_rejections_match(logic):
    code = template.fill_template(logic)
    with pytest.raises(jtranspiler.TranspileError) as jerr:
        jtranspiler.transpile(code)
    with pytest.raises(transpiler.TranspileError) as err:
        transpiler.transpile(code)
    assert str(err.value) == str(jerr.value)


POISON_LOGIC = [
    "score = 1.0 / (pod.num_gpu * 0)",
    "gpus = sorted(g.gpu_milli_left for g in node.gpus)\n"
    "    score = gpus[0] + 1",
    "gpus = sorted(g.gpu_milli_left for g in node.gpus)\n"
    "    score = gpus[-1] + 2 * len(gpus)",
    "score = node.gpus[1].gpu_milli_left + 3",
    "xs = sorted(g.gpu_milli_left for g in node.gpus)\n"
    "    xs = 7.0\n"
    "    score = xs",
    "score = min(gpu.gpu_milli_left for gpu in node.gpus)",
    "score = int(100.0 / (node.gpu_left * 0)) if node.gpu_left > 9999 "
    "else 5",
    "if node.gpu_left > 0:\n"
    "        bonus = 5\n"
    "    score = 10 + bonus",
    "score = node.cpu_milli_left // max(1, pod.cpu_milli) "
    "+ node.memory_mib_left % 7 - (pod.cpu_milli - 9000) // 7",
    "score = (node.cpu_milli_left / 3.0) // 1.5 + (-node.gpu_left) % 3",
    "score = 2 ** pod.num_gpu + node.gpu_left ** 2 + abs(-3)",
    "score = round(node.cpu_milli_left / 7) + math.exp(pod.num_gpu) "
    "+ math.log(1 + node.gpu_left)",
]


@pytest.mark.parametrize("logic", POISON_LOGIC)
def test_nonfinite_and_poison_lanes_match(logic):
    """Lanes where Python raises or the value is non-finite refuse, and
    every lane equals fks_tpu's (and, where Python does not raise, the
    scalar oracle's)."""
    code = template.fill_template(logic)
    policy = transpiler.transpile(code)
    jpolicy = jtranspiler.transpile(code)
    fn = sandbox.compile_policy(code)
    rng = np.random.default_rng(11)
    for _ in range(3):
        pod, nodes, spod, snodes = random_state(rng)
        got = policy(*one_lane(pod, nodes))[0].tolist()
        assert got == np.asarray(jpolicy(pod, nodes)).tolist()
        for g, sn in zip(got, snodes):
            try:
                want = int(fn(spod, sn))
            except Exception:
                want = 0  # the reference aborts; the lane refuses
            assert g == want


def test_nonfinite_lanes_refuse():
    code = template.fill_template("score = 1.0 / (pod.num_gpu * 0)")
    policy = transpiler.transpile(code)
    pod, nodes, _, _ = random_state(np.random.default_rng(3))
    assert (policy(*one_lane(pod, nodes)) == 0).all()


def test_float32_dtype_and_validation():
    code = template.seed_policies()["best_fit"]
    p32 = transpiler.transpile(code, dtype=torch.float32)
    pod, nodes, _, _ = random_state(np.random.default_rng(5))
    out = p32(*one_lane(pod, nodes))
    assert out.dtype == torch.int32 and p32.dtype == torch.float32
    with pytest.raises(ValueError, match="dtype"):
        transpiler.transpile(code, dtype=torch.int32)
    with pytest.raises(transpiler.TranspileError, match="validation"):
        transpiler.transpile("import os")


def test_canonical_key_matches():
    a = template.fill_template("score = 1 + 2")
    b = a.replace("score = 1 + 2", "score = 1   +    2")
    assert transpiler.canonical_key(a) == transpiler.canonical_key(b)
    for code in (a, template.seed_policies()["best_fit"]):
        assert transpiler.canonical_key(code) == \
            jtranspiler.canonical_key(code)
