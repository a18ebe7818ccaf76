"""Two processes, one hybrid mesh: the port's counterpart of
tests/test_distributed.py::test_two_process_hybrid_mesh.

Two processes form a ``torch.distributed`` group over gloo on localhost
(``init_distributed`` with explicit arguments), each bringing 2 logical
CPU shards, and evaluate a padded population on the global ``(2, 2)``
``("dcn", "pop")`` mesh: the score vector crosses the process boundary
through ``all_gather``. Both processes must agree on the scores, the
elites and a generation step's new population, and the scores must equal
the one-process eval exactly.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, sys
import torch
torch.set_num_threads(1)
pid, port = int(sys.argv[1]), sys.argv[2]
from fks_tpu_torch.data import make_workload
from fks_tpu_torch.models import parametric
from fks_tpu_torch.parallel import (
    hybrid_population_mesh, init_distributed, make_population_eval,
    make_sharded_eval, make_sharded_generation_step, pad_population)

n = init_distributed(f"localhost:{port}", num_processes=2, process_id=pid,
                     backend="gloo")
assert n == 2, n
nodes = [
    {"node_id": "node1", "cpu_milli": 8000, "memory_mib": 16000,
     "gpus": [1000, 1000], "gpu_memory_mib": 8000},
    {"node_id": "node2", "cpu_milli": 4000, "memory_mib": 8000, "gpus": []},
]
pods = [
    {"pod_id": "pod1", "cpu_milli": 1000, "memory_mib": 2000, "num_gpu": 0,
     "gpu_milli": 0, "creation_time": 0, "duration_time": 10},
    {"pod_id": "pod2", "cpu_milli": 2000, "memory_mib": 4000, "num_gpu": 1,
     "gpu_milli": 500, "creation_time": 5, "duration_time": 15},
    {"pod_id": "pod3", "cpu_milli": 3000, "memory_mib": 6000, "num_gpu": 0,
     "gpu_milli": 0, "creation_time": 10, "duration_time": 8},
    {"pod_id": "pod4", "cpu_milli": 1500, "memory_mib": 3000, "num_gpu": 2,
     "gpu_milli": 400, "creation_time": 15, "duration_time": 12},
]
wl = make_workload(nodes, pods, pad_nodes_to=4, pad_gpus_to=4,
                   pad_pods_to=8)
mesh = hybrid_population_mesh(["cpu"] * 2)
assert mesh.axis_names == ("dcn", "pop") and dict(mesh.shape) == {
    "dcn": 2, "pop": 2}, mesh
assert mesh.ranks == (0, 1) and mesh.spans_processes

gen = torch.Generator().manual_seed(0)
pop = parametric.init_population(gen, 7, noise=0.2)
params, real = pad_population(pop, mesh)
assert params.shape[0] == 8 and real == 7
scores, elite_idx, elite_scores = make_sharded_eval(
    wl, mesh, elite_k=4)(params, real)
ref = make_population_eval(wl, device="cpu")(params).policy_score
assert torch.equal(scores, ref), (scores, ref)
new, _, _ = make_sharded_generation_step(wl, mesh, elite_k=2)(
    params, 5, real)
print("RESULT " + json.dumps({
    "process": pid, "scores": scores.tolist(),
    "elite_idx": elite_idx.tolist(), "elite_scores": elite_scores.tolist(),
    "new": new.tolist()}))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, port):
    """The two processes on ``port``: (outs, bind_conflict)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(port)], env=env, cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    outs = []
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                pytest.fail(f"process {i} timed out in the process group")
            if p.returncode != 0 and "address already in use" in err.lower():
                return None, True
            assert p.returncode == 0, f"process {i} failed:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, False


def test_two_process_hybrid_mesh(tmp_path):
    for _ in range(3):  # a fresh port per attempt (the probe closes first)
        outs, conflict = _run_pair(tmp_path, _free_port())
        if not conflict:
            break
    else:
        pytest.fail("the rendezvous port was taken 3 times in a row")
    results = []
    for i, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"process {i} printed no result:\n{out[-2000:]}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    a, b = results
    for k in ("scores", "elite_idx", "elite_scores", "new"):
        assert a[k] == b[k], k
    assert len(a["scores"]) == 8 and a["elite_scores"][0] > 0
    assert all(i < 7 for i in a["elite_idx"])  # the pad lane never wins
