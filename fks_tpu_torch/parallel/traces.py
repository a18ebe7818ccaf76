"""Trace batching: one batched run over many same-shape workloads.

Port of fks_tpu.parallel.traces. fks_tpu vmaps the engine over a stacked
workload; here the lane axis is written out. Same-shape workloads are
stacked leaf by leaf on a leading trace axis ``T`` (``stack_traces``) and
each lane of the batched step reads its own trace's tables through
``lane_trace`` (sim.engine module docstring). With a population the lanes
are laid out candidate-outer, trace-inner: lane ``c * T + t`` runs
candidate ``c`` on trace ``t``, and the results come back as ``[C, T]``.

On CUDA the batched step replays as a captured CUDA graph
(``sim.engine.GraphedChunk``), one graph per candidate count and params
shape (``sim.engine.graph_key``), which holds its step; results read from
a reused graph's state are copied out.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.models import parametric
from fks_tpu_torch.sim import get_engine
from fks_tpu_torch.sim.engine import (
    GraphedChunk, SimConfig, bind_step, copy_state_, graph_key,
    run_batched_lanes, stack_states, tile_state, zip_tensors,
)
from fks_tpu_torch.sim.evaluator import (
    max_snapshot_count, snapshot_trigger_table,
)
from fks_tpu_torch.sim.types import (
    SimResult, as_params, batch_size, clone_tensors, copy_tensors_,
    map_tensors,
)


def strip_ids(wl: Workload) -> Workload:
    """The workload without its host-side id tuples, the form a stack
    keeps (fks_tpu strips them so same-shape workloads share a treedef)."""
    return dataclasses.replace(
        wl, cluster=dataclasses.replace(wl.cluster, node_ids=()),
        pods=dataclasses.replace(wl.pods, pod_ids=()))


def stack_traces(workloads: Sequence[Workload], cfg: SimConfig,
                 engine: str = "exact"):
    """Same-shape workloads as ``(workload[T, ...], ktable i32[T, K],
    state0, max_steps)``, where ``state0`` holds one lane per trace.

    Each trace's snapshot table is sized from its own real pod count (the
    reference's ``initialize(total_events)``) and padded to a shared width
    with an unreachable INT32_MAX sentinel; initial states are built per
    trace by the chosen engine (the exact engine runs CPython heapq for its
    starting layout). The shared step budget is the largest trace's, and
    so is a default decision-trace length."""
    mod = get_engine(engine)
    if not workloads:
        raise ValueError("no workloads")
    shapes = {(w.cluster.n_padded, w.cluster.g_padded, w.pods.p_padded)
              for w in workloads}
    if len(shapes) != 1:
        raise ValueError(f"workloads span multiple padded shapes {shapes}; "
                         "bucket them first (fks_tpu_torch.data.synthetic)")
    fshapes = {None if w.faults is None else w.faults.f_padded
               for w in workloads}
    if len(fshapes) != 1:
        raise ValueError(
            f"workloads mix fault-event padding {fshapes}; a stacked batch "
            "needs one shared FaultEvents shape on every trace (or none) — "
            "materialize suites via fks_tpu_torch.scenarios, which pads "
            "faults uniformly (fault-free scenarios get an all-masked "
            "timeline)")
    max_steps = max(cfg.resolve_max_steps(w.num_pods) for w in workloads)
    if cfg.decision_trace and cfg.trace_len is None:
        cfg = dataclasses.replace(cfg, trace_len=max_steps)
    ktables = [snapshot_trigger_table(
        w.num_pods,
        max_snapshot_count(max_steps, w.num_pods, cfg.snapshot_interval),
        cfg.snapshot_interval) for w in workloads]
    klen = max(len(k) for k in ktables)
    kt = np.full((len(workloads), klen), np.iinfo(np.int32).max, np.int32)
    for i, k in enumerate(ktables):
        kt[i, : len(k)] = k

    states = [mod.initial_state(w, cfg) for w in workloads]
    hist_sizes = {int(s.wait_hist.shape[1]) for s in states}
    if len(hist_sizes) != 1:
        raise ValueError(f"wait histogram sizes differ across traces "
                         f"{hist_sizes}; traces exceed the shared gpu_milli "
                         "range — split the bucket")
    stacked = zip_tensors(torch.stack, [strip_ids(w) for w in workloads])
    return (stacked, torch.from_numpy(kt).to(stacked.device),
            stack_states(states), max_steps)


def _per_lane(result: SimResult, cands: int, traces: int) -> SimResult:
    return map_tensors(
        lambda x: x.reshape((cands, traces) + tuple(x.shape[1:])), result)


def make_trace_batch_eval(workloads: Sequence[Workload],
                          param_policy=parametric.score,
                          cfg: SimConfig = SimConfig(),
                          population: bool = False,
                          engine: str = "exact", device=None):
    """``eval(params) -> SimResult`` batched over the trace axis T, on
    ``device`` (default ``cuda``).

    ``population=False``: ``params`` is one candidate (or None for a
    policy that takes none), shared by every lane; results have leading
    axis [T]. ``population=True``: ``params[C, ...]`` adds the candidate
    axis; results are [C, T], every candidate on every trace in one run.
    ``engine`` is "exact" or "flat"."""
    dev = resolve_device(device)
    mod = get_engine(engine)
    wl, kt, state0, max_steps = stack_traces(
        [w.to(dev) for w in workloads], cfg, engine)
    traces = int(kt.shape[0])
    graphs = {}

    def build(params, lane_trace):
        return bind_step(mod.build_step, wl, param_policy, params, cfg, kt,
                         max_steps, lane_trace=lane_trace)

    def eval_fn(params) -> SimResult:
        if params is not None:
            params = map_tensors(lambda x: x.to(dev), as_params(params))
        cands = batch_size(params) if population else 1
        # lane c * T + t: candidate c on trace t
        lane_trace = torch.arange(traces, device=dev).repeat(cands)
        if population:
            params = map_tensors(
                lambda x: x.repeat_interleave(traces, dim=0), params)
        state = tile_state(state0, cands)
        if dev.type != "cuda":
            final = run_batched_lanes(build(params, lane_trace), state,
                                      max_steps, active_fn=mod.lane_active)
            res = mod.finalize(wl, cfg, final, lane_trace=lane_trace)
        else:
            key = graph_key(cands, params)
            chunk = graphs.get(key)
            if chunk is None:
                chunk = GraphedChunk(
                    build(clone_tensors(params), lane_trace), state,
                    max_steps, mod.lane_active)
                graphs[key] = chunk
            else:
                if params is not None:
                    copy_tensors_(chunk.step.params, params)
                copy_state_(chunk.state, state)
            res = map_tensors(torch.clone, mod.finalize(
                wl, cfg, chunk.run(), lane_trace=lane_trace))
        return _per_lane(res, cands, traces) if population else res

    eval_fn.graphs = graphs  # captured CUDA graphs, by engine.graph_key
    return eval_fn
