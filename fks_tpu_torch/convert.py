"""Carry workloads and weights across from the JAX package, as numpy.

The port never imports fks_tpu; callers hand over fks_tpu's arrays as
numpy (``np.asarray`` of each field) and get the port's tensors back.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, Tuple

import numpy as np
import torch

from fks_tpu_torch.data.entities import ClusterArrays, PodArrays, Workload
from fks_tpu_torch.models.parametric import NUM_FEATURES

CLUSTER_FIELDS = ("cpu_total", "mem_total", "gpu_declared", "num_gpus",
                  "gpu_milli_total", "gpu_mem_total", "gpu_mask", "node_mask")
POD_FIELDS = ("cpu", "mem", "num_gpu", "gpu_milli", "creation_time",
              "duration", "tie_rank", "pod_mask")


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _fields(arrays: Mapping, names) -> dict:
    return {k: _tensor(arrays[k], bool if k.endswith("mask") else np.int32)
            for k in names}


def workload_from_numpy(cluster: Mapping, pods: Mapping,
                        device="cpu") -> Workload:
    """The port's ``Workload`` from fks_tpu's arrays: ``cluster`` maps each
    of ``CLUSTER_FIELDS`` (and optionally ``node_ids``) to a numpy array,
    ``pods`` each of ``POD_FIELDS`` (and optionally ``pod_ids``)."""
    wl = Workload(
        cluster=ClusterArrays(**_fields(cluster, CLUSTER_FIELDS),
                              node_ids=tuple(cluster.get("node_ids", ()))),
        pods=PodArrays(**_fields(pods, POD_FIELDS),
                       pod_ids=tuple(pods.get("pod_ids", ()))))
    return wl.to(device)


def workload_to_numpy(workload: Workload) -> Tuple[dict, dict]:
    """(cluster, pods) dicts of numpy arrays — ``workload_from_numpy``'s
    inverse."""
    c, p = workload.cluster, workload.pods
    cluster = {k: getattr(c, k).cpu().numpy() for k in CLUSTER_FIELDS}
    pods = {k: getattr(p, k).cpu().numpy() for k in POD_FIELDS}
    cluster["node_ids"], pods["pod_ids"] = c.node_ids, p.pod_ids
    return cluster, pods


def params_from_numpy(w, device="cpu") -> torch.Tensor:
    """A weight matrix f32[P, 16] (or one vector [16]) as a tensor."""
    arr = np.asarray(w, dtype=np.float32)
    if arr.shape[-1] != NUM_FEATURES or arr.ndim not in (1, 2):
        raise ValueError(f"expected weights of shape [P, {NUM_FEATURES}] or "
                         f"[{NUM_FEATURES}], got {arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def load_champion_weights(path, device="cpu") -> torch.Tensor:
    """The ``"weights"`` list (16 floats) of a discovered-policy record,
    e.g. ``policies/discovered/*.json``, as f32[16]."""
    with open(Path(path)) as f:
        record = json.load(f)
    if "weights" not in record:
        raise ValueError(f"{path} has no 'weights' (not a parametric "
                         "champion)")
    return params_from_numpy(record["weights"], device)


def vm_program_from_numpy(leaves, dtype=None, device="cpu"):
    """The port's ``funsearch.vm.VMProgram`` from fks_tpu's: ``leaves``
    maps each field name (opcode, a, b, c, imm, consts, n_ops, out_reg) to
    a numpy array, or is the eight arrays in that order (a stacked program
    keeps its leading axis). Integer fields become int32; ``imm`` and
    ``consts`` keep their float dtype unless ``dtype`` (a torch dtype)
    names another."""
    from fks_tpu_torch.funsearch.vm import VMProgram

    if isinstance(leaves, Mapping):
        leaves = [leaves[k] for k in VMProgram._fields]
    leaves = list(leaves)
    if len(leaves) != len(VMProgram._fields):
        raise ValueError(f"expected {len(VMProgram._fields)} arrays "
                         f"{VMProgram._fields}, got {len(leaves)}")
    out = {}
    for name, a in zip(VMProgram._fields, leaves):
        if name in ("imm", "consts"):
            t = torch.from_numpy(np.array(a, copy=True))
            out[name] = t if dtype is None else t.to(dtype)
        else:
            out[name] = _tensor(a, np.int32)
    return VMProgram(**out) if device == "cpu" else VMProgram(
        **{k: v.to(device) for k, v in out.items()})


def device_evolution_state_from_npz(path, device="cpu") -> dict:
    """The state of an fks_tpu ``ParametricEvolution.save_checkpoint``
    file for a port instance's ``load_state``: ``params`` and
    ``best_params`` as f32 tensors on ``device``, ``best_score``,
    ``generation``, ``real_count`` and ``history`` (the [gens, 3] rows) as
    fks_tpu wrote them. fks_tpu's ``key`` is a JAX PRNG key, which no
    ``torch.Generator`` state can express, so it is not carried: a run
    continued from a converted checkpoint draws other mutations than
    fks_tpu's continuation would."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as d:
        best = np.asarray(d["best_params"], np.float32)
        return {
            "params": params_from_numpy(d["params"], device),
            "best_params": (params_from_numpy(best, device) if best.size
                            else torch.zeros(0, device=device)),
            "best_score": float(d["best_score"]),
            "generation": int(d["generation"]),
            "real_count": int(d["real_count"]),
            "history": np.asarray(d["history"], np.float64).reshape(-1, 3),
        }
