"""Mesh scale-out: population sharding and gathered elite ranking.

Port of fks_tpu.parallel.mesh. fks_tpu holds one ``jax.sharding.Mesh``
per process and runs ``shard_map`` bodies whose ``lax.all_gather`` and
``psum`` ride the interconnect. The port keeps the same surface with
PyTorch's means:

- ``Mesh`` is a named grid of ``torch.device``s. A device may repeat: a
  mesh of ``[cpu] * 8`` (or ``[cuda:0] * 4``) has 8 (4) logical shards
  on one device, which is how the tests stand in for fks_tpu's 8
  virtual CPU devices and how one card runs several shards. A hybrid
  ``("dcn", "pop")`` mesh across processes records which
  ``torch.distributed`` rank owns each row.
- One controller per process: each process runs the shards of its own
  rows. Every shard is launched before any result is read — the engines'
  lanes are ``sim.engine.LaneJob``s that ``sim.engine.drain`` advances
  together (one graph replay, or a few eager steps, on every shard, then
  one read of every shard's flag); the fused kernel launches once per
  shard. Each shard owns its runner and its captured graphs, so logical
  shards on one device never replay into each other's buffers.
- Collectives: within a process, each shard's score vector is copied to
  the lead device (the first shard's) and concatenated in shard order;
  across processes ``torch.distributed.all_gather`` (gloo on the CPU,
  NCCL on the card) joins the processes' blocks in row-major shard order
  (fks_tpu's ``_shard_index``). fks_tpu's ``psum`` of one flag is an
  ``any`` over the shards' flags (an ``all_reduce`` across processes).
  A failed collective raises; nothing falls back to one device.
- Elites: the stable top-k of the gathered scores (``top_k_real``), pad
  lanes masked as fks_tpu's ``_mask_pad``/``_top_k_real`` mask them.
- Mutation: each shard draws its offspring noise from a generator
  seeded by the step's seed folded with the shard id (fks_tpu folds its
  PRNG key per shard); the stream is the port's own.

Results come back on the lead device: the gathered score vector, and the
full per-lane ``SimResult`` of this process's shards (every shard when
one process holds the mesh).
"""
from __future__ import annotations

import collections
import datetime
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.models import parametric
from fks_tpu_torch.obs.spans import add, elapsed_s, is_open, span
from fks_tpu_torch.parallel.population import (
    ParamPolicyFn, fused_runner, occupancy_stats, pad_population, pad_stats,
)
from fks_tpu_torch.sim.engine import SimConfig, drain
from fks_tpu_torch.sim.types import (
    SimResult, as_params, batch_size, map_tensors, tensor_leaves,
)

POP_AXIS = "pop"
DCN_AXIS = "dcn"
SCN_AXIS = "scn"  # scenario axis of a layout_mesh (obs.layout specs)
#: how long a collective waits for the other processes before it raises
GROUP_TIMEOUT_S = 300

__all__ = [
    "DCN_AXIS", "LaneSharding", "Mesh", "POP_AXIS", "SCN_AXIS",
    "cuda_devices", "hybrid_population_mesh", "init_distributed",
    "layout_mesh", "make_sharded_code_eval", "make_sharded_eval",
    "make_sharded_generation_step", "make_sharded_portfolio_serve_fn",
    "make_sharded_serve_fn", "make_sharded_vm_serve_fn", "next_generation",
    "num_shards",
    "occupancy_stats", "pad_population", "pad_stats", "population_mesh",
    "serve_lane_count", "serve_sharding", "shard_population", "top_k_real",
]


# ------------------------------------------------------------------ meshes


def _device(d) -> torch.device:
    """A ``torch.device``, with a bare ``cuda`` pinned to the current
    card."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _world() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


class Mesh:
    """A named grid of devices (fks_tpu's ``jax.sharding.Mesh``).

    ``devices`` is an object ndarray of ``torch.device`` whose axes are
    ``axis_names``; ``shape`` maps each name to its size, in order.
    ``ranks`` (a hybrid mesh spanning processes) names the
    ``torch.distributed`` rank that owns each row of the outer axis; the
    other rows hold the devices those ranks reported. Without ``ranks``
    the whole mesh belongs to this process. Every CUDA device of a row
    this process owns must exist: a mesh never stands in a missing card
    with another device."""

    def __init__(self, devices, axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        arr = np.empty(np.shape(np.array(devices, dtype=object)), object)
        flat = np.array(devices, dtype=object).reshape(-1)
        arr.reshape(-1)[:] = [_device(d) for d in flat]
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"{arr.ndim}-D device grid for axes "
                             f"{self.axis_names}")
        self.devices = arr
        self.ranks = tuple(int(r) for r in ranks) if ranks is not None \
            else None
        if self.ranks is not None and len(self.ranks) != arr.shape[0]:
            raise ValueError(f"{len(self.ranks)} ranks for "
                             f"{arr.shape[0]} rows")
        for dev in _owned(self).reshape(-1):
            have = (torch.cuda.device_count()
                    if torch.cuda.is_available() else 0)
            if dev.type == "cuda" and (dev.index or 0) >= have:
                raise ValueError(f"mesh device {dev} does not exist here "
                                 f"({have} CUDA devices)")

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(
            zip(self.axis_names, (int(n) for n in self.devices.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len(set(self.ranks)) > 1

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{sorted({str(d) for d in self.devices.reshape(-1)})}"
                + (f", ranks={self.ranks}" if self.ranks else "") + ")")


def _owned(mesh: Mesh) -> np.ndarray:
    """The rows of the device grid this process runs."""
    if mesh.ranks is None:
        return mesh.devices
    me = _rank()
    return mesh.devices[[r == me for r in mesh.ranks]]


def cuda_devices(n: Optional[int] = None) -> List[torch.device]:
    """The first ``n`` CUDA devices (all of them by default); raises when
    the machine has fewer."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else int(n)
    if n < 1 or n > have:
        raise ValueError(f"asked for {n} CUDA devices, {have} present")
    return [torch.device("cuda", i) for i in range(n)]


def population_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the given devices (default: every CUDA device),
    population axis only — the problem has one parallel dimension,
    candidates."""
    devices = list(devices) if devices is not None else cuda_devices()
    return Mesh(np.array(devices, dtype=object), (POP_AXIS,))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Bring up the ``torch.distributed`` process group (fks_tpu's
    ``jax.distributed.initialize``, mesh.py:62-88). ``backend`` defaults
    to NCCL with a card and gloo without. With explicit arguments a
    failed bring-up raises — a two-process launch silently run as one
    would run at the wrong scale. With auto-detection only (torchrun's
    ``MASTER_ADDR``/``WORLD_SIZE``/``RANK``), no cluster environment or a
    failed bring-up means a single-process run. A collective that waits
    past ``GROUP_TIMEOUT_S`` raises. No-op when the group is up. Returns
    the process count."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    explicit = any(v is not None
                   for v in (coordinator_address, num_processes, process_id))
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("init_distributed needs coordinator_address, "
                             "num_processes and process_id together")
        addr = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=addr,
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)
        return dist.get_world_size()
    if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE",
                                         "RANK")):
        return 1
    try:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    except (RuntimeError, ValueError):
        return 1  # auto-detection found no cluster: single process
    return dist.get_world_size()


def hybrid_population_mesh(devices: Optional[Sequence] = None,
                           num_slices: Optional[int] = None) -> Mesh:
    """A 2-D ``("dcn", "pop")`` mesh: the outer axis across processes
    (fks_tpu's slices and hosts), the inner one within a process. The
    population shards over both.

    With a process group of W > 1 processes, ``devices`` are this
    process's own (default: its CUDA devices), every process must bring
    as many, and row r belongs to rank r (``num_slices`` must be W or
    None). In one process, ``num_slices`` (default 1) must divide the
    device count and every row is this process's."""
    devices = list(devices) if devices is not None else cuda_devices()
    world = _world()
    if world > 1:
        if num_slices not in (None, world):
            raise ValueError(f"num_slices={num_slices} but the process "
                             f"group has {world} processes (one row each)")
        import torch.distributed as dist

        rows: List[Optional[List[str]]] = [None] * world
        dist.all_gather_object(rows, [str(_device(d)) for d in devices])
        if len({len(r) for r in rows}) != 1:
            raise ValueError(f"processes bring different device counts: "
                             f"{[len(r) for r in rows]}")
        return Mesh(np.array(rows, dtype=object), (DCN_AXIS, POP_AXIS),
                    ranks=range(world))
    n = len(devices)
    slices = num_slices or 1
    if n % slices:
        raise ValueError(f"{n} devices not divisible into {slices} slices")
    return Mesh(np.array(devices, dtype=object).reshape(slices, n // slices),
                (DCN_AXIS, POP_AXIS))


def layout_mesh(devices: Optional[Sequence] = None,
                scenario_shards: int = 1) -> Mesh:
    """The mesh of a declared layout (``obs.layout.LayoutSpec``):
    ``scenario_shards=1`` is the 1-D population mesh; more factorizes the
    devices into a 2-D ``("pop", "scn")`` mesh, candidates on the outer
    axis and scenarios on the inner one."""
    devices = list(devices) if devices is not None else cuda_devices()
    s = int(scenario_shards)
    if s <= 1:
        return population_mesh(devices)
    if len(devices) % s:
        raise ValueError(f"{len(devices)} devices not divisible into "
                         f"{s} scenario shards")
    return Mesh(np.array(devices, dtype=object).reshape(-1, s),
                (POP_AXIS, SCN_AXIS))


def _check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def _pop_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes the population shards over, in mesh order: ("pop",), or
    ("dcn", "pop") on a hybrid mesh; a layout mesh's "scn" never is."""
    return tuple(a for a in mesh.axis_names if a in (DCN_AXIS, POP_AXIS))


def num_shards(mesh: Mesh) -> int:
    """Total population shards: the product of the mesh's pop axes."""
    n = 1
    for a in _pop_axes(mesh):
        n *= mesh.shape[a]
    return n


def _tiles(mesh: Mesh) -> np.ndarray:
    """The device grid as ``[population shards, scenario shards]``, rows
    in row-major shard order (fks_tpu's ``_shard_index``)."""
    scn = mesh.shape.get(SCN_AXIS, 1)
    return mesh.devices.reshape(num_shards(mesh), scn)


def _local_shards(mesh: Mesh) -> List[Tuple[int, torch.device]]:
    """(shard index, device) of every population shard this process runs;
    a shard of a layout mesh runs on its first scenario device."""
    tiles = _tiles(mesh)
    if mesh.ranks is None:
        return [(i, tiles[i, 0]) for i in range(tiles.shape[0])]
    me = _rank()
    per_row = tiles.shape[0] // len(mesh.ranks)
    return [(i, tiles[i, 0]) for i in range(tiles.shape[0])
            if mesh.ranks[i // per_row] == me]


def lead_device(mesh: Mesh) -> torch.device:
    """Where a mesh's gathered results land: its first local shard's
    device."""
    return _local_shards(mesh)[0][1]


def shard_population(params, mesh: Mesh) -> list:
    """This process's shards of a population (any tensor or NamedTuple of
    tensors with the candidate axis leading), each on its shard's
    device, in shard order. The count must divide over the shards (use
    ``pad_population``)."""
    params = as_params(params)
    c, n = batch_size(params), num_shards(mesh)
    if c % n:
        raise ValueError(f"population {c} not divisible by shard count "
                         f"{n}; use pad_population()")
    per = c // n
    return [map_tensors(lambda x, i=i, d=d: x[i * per:(i + 1) * per].to(d),
                        params)
            for i, d in _local_shards(mesh)]


def _concat(parts, device: torch.device):
    """Tensor trees of the same shape joined along their leading axis on
    ``device``."""
    if len(parts) == 1:
        return map_tensors(lambda x: x.to(device), parts[0])
    leaves = [tensor_leaves(p) for p in parts]
    joined = iter([torch.cat([x.to(device) for x in xs])
                   for xs in zip(*leaves)])
    return map_tensors(lambda _x: next(joined), parts[0])


def _collective_device() -> torch.device:
    import torch.distributed as dist

    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def gather_shards(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every shard's rows of a per-lane tensor, in shard order, on the
    lead device: ``local`` (this process's shards, concatenated) as it
    is in one process, joined with the other processes' blocks by one
    ``all_gather`` across processes (fks_tpu's tiled ``all_gather``)."""
    if not mesh.spans_processes:
        return local
    import torch.distributed as dist

    t = local.to(_collective_device()).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).to(local.device)


def _any_shard(mesh: Mesh, flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """fks_tpu's ``psum`` of the any-lane-active flags, as one device bool
    on the lead device (one ``all_reduce`` across processes)."""
    lead = flags[0].device
    local = torch.stack([f.to(lead) for f in flags]).any()
    if not mesh.spans_processes:
        return local
    import torch.distributed as dist

    t = local.to(device=_collective_device(), dtype=torch.int32)
    dist.all_reduce(t)
    return (t > 0).to(lead)


# ------------------------------------------------------------- elite ranking


def top_k_real(scores: torch.Tensor, real_count: int, k: int):
    """(elite_scores[k], elite_idx[k]): the k best of the first
    ``real_count`` slots, ties to the lower index (``lax.top_k``'s order;
    a stable descending sort guarantees it, ``torch.topk`` does not). A
    pad slot never wins: when ``real_count < k`` the trailing slots
    repeat the best real candidate (fks_tpu mesh.py:358-373)."""
    iota = torch.arange(scores.shape[0], device=scores.device)
    masked = torch.where(iota < real_count, scores,
                         torch.full_like(scores, -torch.inf))
    order = torch.sort(masked, descending=True, stable=True)
    elite_scores, elite_idx = order.values[:k], order.indices[:k]
    valid = torch.isfinite(elite_scores)
    return (torch.where(valid, elite_scores, elite_scores[0]),
            torch.where(valid, elite_idx, elite_idx[0]))


def next_generation(params: torch.Tensor, scores: torch.Tensor,
                    elite_k: int,
                    offspring: Callable[[torch.Tensor], torch.Tensor],
                    real_count: Optional[int] = None):
    """Elites survive in the leading slots; every other slot takes the
    offspring ``offspring(elites)`` made for it. Returns (new_params,
    elite_scores)."""
    pop = params.shape[0]
    real = pop if real_count is None else real_count
    elite_scores, elite_idx = top_k_real(scores, real, elite_k)
    elites = params[elite_idx]
    slot = torch.arange(pop, device=params.device)
    survivors = elites[slot.clamp(max=elite_k - 1)]
    new = torch.where((slot < elite_k)[:, None], survivors, offspring(elites))
    return new, elite_scores


# ---------------------------------------------------------------- layouts


def _resolve_layout(layout, *, scenarios: bool = False, seg_steps: int = 0,
                    scenario_shardable: bool = False):
    """An entry point's ``layout`` argument as a ``LayoutSpec``: None is
    the default spec; entry points without a scenario axis refuse specs
    that shard scenarios (fks_tpu mesh.py:129-147)."""
    from fks_tpu_torch.obs.layout import LayoutSpec, default_spec

    if layout is None:
        return default_spec(scenarios=scenarios, seg_steps=seg_steps)
    if not isinstance(layout, LayoutSpec):
        raise TypeError(f"layout must be a LayoutSpec or None, got "
                        f"{type(layout).__name__}")
    if "scenarios" in layout.shard and not scenario_shardable:
        raise ValueError(
            f"layout {layout.key!r} shards the scenario axis, but this "
            "entry point has no scenario axis (mesh-sharded suite "
            "evaluation lives at fks_tpu_torch.scenarios.robust."
            "make_sharded_suite_eval)")
    return layout


def _layout_eval(fn, component: str, spec, mesh: Mesh, scenarios: int = 1):
    """Wrap ``fn(params, real_count=None, ...)``: one ``layout_ledger``
    row at wiring time and one per launch (identical repeats dedupe)."""
    from fks_tpu_torch.obs.layout import record_layout, tag_layout

    record_layout(component, spec, mesh=mesh)

    def run(params, real_count=None, *args):
        real = (batch_size(as_params(params)) if real_count is None
                else int(real_count))
        record_layout(component, spec, mesh=mesh, real_count=real,
                      scenarios=scenarios)
        return fn(params, real, *args)

    return tag_layout(run, spec.key)


# ------------------------------------------------------ sharded population


class ShardedPopulation:
    """A population evaluated shard by shard on a mesh: one runner per
    local shard, on the shard's device, with graphs of its own (the
    fused engine shares one runner per device: its launch holds no
    state). ``run(params)`` launches every shard before it reads any,
    and returns the local shards' ``SimResult`` on the lead device, inside
    an ``eval`` span (``obs.spans``) whose stages are ``start``,
    ``drain`` and ``finish``, or ``launch`` for the fused engine; called
    under an open span, it keeps the fused launches' CUDA events for
    ``settle``. ``graphs`` lists each local shard's captured chunks by
    ``sim.engine.graph_key``."""

    def __init__(self, workload: Workload, mesh: Mesh,
                 param_policy: ParamPolicyFn, cfg: SimConfig, engine: str):
        from fks_tpu_torch.sim import get_engine

        self.mesh = _check_mesh(mesh)
        self.shards = _local_shards(mesh)
        self.lead = self.shards[0][1]
        self.fused = engine == "fused"
        self.launches = None  # the fused launches' events, for settle
        wls, states, fused = {}, {}, {}
        mod = None if self.fused else get_engine(engine)
        self.runners, self.state0 = [], []
        for _, dev in self.shards:
            if dev not in wls:
                wls[dev] = workload.to(dev)
                if self.fused:
                    fused[dev] = fused_runner(wls[dev], param_policy, cfg,
                                              device=dev)
                else:
                    states[dev] = mod.initial_state(wls[dev], cfg)
            if self.fused:
                self.runners.append(fused[dev])
            else:
                self.runners.append(mod.make_population_run_fn(
                    wls[dev], param_policy, cfg))
                self.state0.append(states[dev])

    @property
    def graphs(self) -> list:
        return [getattr(run, "graphs", {}) for run in self.runners]

    def __call__(self, params) -> SimResult:
        self.launches = [] if self.fused and is_open() else None
        with span("eval"):
            parts = shard_population(params, self.mesh)
            if self.fused:
                with span("launch"):
                    results = [run(p, self.launches)
                               for run, p in zip(self.runners, parts)]
            else:
                with span("start"):
                    jobs = [run.start(p, s0) for run, p, s0
                            in zip(self.runners, parts, self.state0)]
                with span("drain"):
                    drain(jobs)
                with span("finish"):
                    results = [run.finish(job) for run, job
                               in zip(self.runners, jobs)]
            return _concat(results, self.lead)

    def settle(self) -> None:
        """Add the last evaluation's fused launches' device seconds (their
        CUDA events) to the open spans as ``engine_device_s``. Call it
        once a read-back of that evaluation's results has completed them;
        ``drain`` counts the other engines' own."""
        if self.launches:
            add(engine_device_s=sum(elapsed_s(a, b)
                                    for a, b in self.launches))
        self.launches = None


def make_sharded_eval(workload: Workload, mesh: Mesh,
                      param_policy: ParamPolicyFn = parametric.score,
                      cfg: SimConfig = SimConfig(),
                      elite_k: int = 8, engine: str = "exact",
                      layout=None):
    """``eval(params[C, F], real_count=None) -> (scores[C], elite_idx[K],
    elite_scores[K])`` (fks_tpu mesh.py:422-474). ``C`` must divide over
    the mesh's shards (``pad_population``; forward its ``real_count`` so
    pad lanes never win). Each shard runs its chunk through the engine
    ("exact", "flat", or "fused": one kernel launch per shard), the
    score vectors are gathered, and the elites are the stable top-k of
    the real lanes. With ``cfg.decision_trace`` a fourth element is the
    local shards' ``TraceBuffer``. ``eval.results(params)`` is the local
    shards' whole ``SimResult``. ``layout`` as fks_tpu's (no scenario
    axis here); wiring and launches file ``layout_ledger`` rows
    (component "eval")."""
    spec = _resolve_layout(layout)
    pop = ShardedPopulation(workload, mesh, param_policy, cfg, engine)

    def sharded_eval(params, real_count):
        res = pop(params)
        scores = gather_shards(mesh, res.policy_score)
        elite_scores, elite_idx = top_k_real(scores, real_count, elite_k)
        out = (scores, elite_idx, elite_scores)
        if cfg.decision_trace:
            out = out + (res.trace,)
        return out

    run = _layout_eval(sharded_eval, "eval", spec, mesh)
    run.results = pop
    return run


def _fold_in(seed: int, shard: int) -> int:
    """A per-shard generator seed from a step seed (splitmix64 of both),
    the counterpart of ``jax.random.fold_in``."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + shard + 1) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & (2 ** 63 - 1)


def make_sharded_generation_step(workload: Workload, mesh: Mesh,
                                 param_policy: ParamPolicyFn = parametric.score,
                                 cfg: SimConfig = SimConfig(),
                                 elite_k: int = 4,
                                 noise: float = 0.05,
                                 engine: str = "exact",
                                 layout=None):
    """One evolution generation over a mesh (fks_tpu mesh.py:477-545):
    evaluate shard by shard, gather the scores, take the top-k elites,
    keep them in the leading slots and mutate every other slot from a
    random elite. ``step(params[C, F], seed, real_count=None) ->
    (new_params[C, F], scores[C], elite_scores[K])`` on the lead device;
    ``seed`` is an int. Shard i's offspring come from a generator seeded
    with ``seed`` folded with i, so the new population does not depend
    on which process computes it. ``step.results`` evaluates alone
    (``make_sharded_eval``'s ``results``). The evaluation is the
    population's ``eval`` span; the score gather, top-k, elites and
    mutation are the ``select`` span."""
    spec = _resolve_layout(layout)
    pop = ShardedPopulation(workload, mesh, param_policy, cfg, engine)
    n = num_shards(mesh)
    lead = pop.lead

    def offspring(elites, local_c: int, seed: int):
        out = []
        for i in range(n):
            gen = torch.Generator(device=lead)
            gen.manual_seed(_fold_in(seed, i))
            out.append(parametric.mutate(gen, elites, local_c, noise))
        return torch.cat(out)

    def gen_step(params, real_count, seed):
        params = as_params(params).to(lead)
        res = pop(params)
        with span("select"):
            scores = gather_shards(mesh, res.policy_score)
            new, elite_scores = next_generation(
                params, scores, elite_k,
                lambda elites: offspring(elites, params.shape[0] // n, seed),
                real_count)
        return new, scores, elite_scores

    inner = _layout_eval(gen_step, "gen_step", spec, mesh)

    def step(params, seed, real_count=None):
        return inner(params, real_count, int(seed))

    step._fks_layout_key = spec.key
    step.results = pop
    return step


def make_sharded_code_eval(workload: Workload, mesh: Mesh,
                           cfg: SimConfig = SimConfig(),
                           elite_k: int = 8, engine: str = "exact",
                           seg_steps: int = 0, on_segment=None,
                           layout=None, double_buffer: bool = True):
    """``eval(stacked, real_count=None) -> (result, elite_idx[K],
    elite_scores[K])`` for stacked VM code candidates
    (``vm.stack_programs``; fks_tpu mesh.py:548-626): each shard
    interprets its chunk of the program batch through the population
    engine with ``vm.score_static``, the scores are gathered and ranked.
    ``result`` is the local shards' ``SimResult``; ``eval.graphs`` lists
    each local shard's captured chunks by ``sim.engine.graph_key``.

    ``seg_steps > 0`` bounds each dispatch to about ``seg_steps`` events
    (flat engine; engines without a segmented runner take the
    single-dispatch path); ``on_segment`` fires after every segment, and
    ``double_buffer`` is ``sim.flat.run_segments``'. ``layout`` as
    fks_tpu's: a spec whose ``seg_steps`` disagrees with a nonzero
    ``seg_steps`` argument raises."""
    from fks_tpu_torch.funsearch import vm
    from fks_tpu_torch.sim import get_engine

    spec = _resolve_layout(layout, seg_steps=seg_steps)
    if layout is not None and seg_steps and spec.seg_steps != seg_steps:
        raise ValueError(
            f"layout {spec.key!r} declares seg_steps={spec.seg_steps} but "
            f"the seg_steps argument says {seg_steps}; declare it once")
    seg_steps = spec.seg_steps
    mod = get_engine(engine)
    if seg_steps > 0 and hasattr(mod, "make_segmented_population_run"):
        return _make_segmented_code_eval(workload, mesh, cfg, elite_k, mod,
                                         seg_steps, on_segment, spec,
                                         double_buffer)
    pop = ShardedPopulation(workload, mesh, vm.score_static, cfg, engine)

    def sharded_eval(stacked, real_count):
        res = pop(stacked)
        scores = gather_shards(mesh, res.policy_score)
        elite_scores, elite_idx = top_k_real(scores, real_count, elite_k)
        return res, elite_idx, elite_scores

    run = _layout_eval(sharded_eval, "code_eval", spec, mesh)
    run.graphs = pop.graphs
    return run


def _make_segmented_code_eval(workload: Workload, mesh: Mesh,
                              cfg: SimConfig, elite_k: int, mod,
                              seg_steps: int, on_segment, spec,
                              double_buffer: bool):
    """The segmented body of ``make_sharded_code_eval`` (fks_tpu
    mesh.py:629-731): ``sim.flat.run_segments``' host loop, in which
    every shard advances its lanes one segment (its own
    ``make_segmented_population_run``, so its own graphs) and the
    any-lane-active flags of all shards fold into one."""
    from fks_tpu_torch.funsearch import vm
    from fks_tpu_torch.obs.layout import record_layout, tag_layout
    from fks_tpu_torch.sim.engine import broadcast_state
    from fks_tpu_torch.sim.flat import run_segments

    _check_mesh(mesh)
    shards = _local_shards(mesh)
    lead = shards[0][1]
    wls, states, runs = {}, {}, []
    for _, dev in shards:
        if dev not in wls:
            wls[dev] = workload.to(dev)
            states[dev] = mod.initial_state(wls[dev], cfg)
        runs.append(mod.make_segmented_population_run(
            wls[dev], vm.score_static, cfg, seg_steps=seg_steps))
    _, max_steps = mod.loop_tables(workload, cfg)
    record_layout("code_eval", spec, mesh=mesh)

    def run(stacked, real_count=None):
        parts = shard_population(stacked, mesh)
        pop = batch_size(as_params(stacked))
        real = pop if real_count is None else int(real_count)
        bstates = [broadcast_state(states[d], batch_size(p))
                   for (_, d), p in zip(shards, parts)]

        def advance_all():
            flags = []
            for k, (r, p) in enumerate(zip(runs, parts)):
                bstates[k], flag = r.advance(p, bstates[k])
                flags.append(flag)
            return _any_shard(mesh, flags)

        segments = run_segments(advance_all, max_steps, seg_steps,
                                on_segment, double_buffer,
                                "the sharded population engine")
        record_layout("code_eval", spec, mesh=mesh, real_count=real,
                      segments=segments)
        res = _concat([r.finalize_pop(s) for r, s in zip(runs, bstates)],
                      lead)
        if res.policy_score.is_cuda:
            res = map_tensors(torch.clone, res)
        scores = gather_shards(mesh, res.policy_score)
        elite_scores, elite_idx = top_k_real(scores, real, elite_k)
        return res, elite_idx, elite_scores

    run.graphs = [r.graphs for r in runs]
    return tag_layout(run, spec.key)


# ----------------------------------------------------------- serve batches
#
# The serve engines coalesce what-if queries onto the lane axis the
# population shards: a query lane is a one-candidate population. Lane
# buckets are per shard; a batch of ``serve_lane_count`` lanes splits into
# equal shard slices (``LaneSharding``), each run by its shard's graph.


def serve_lane_count(lane_bucket: int, mesh: Optional[Mesh] = None) -> int:
    """Global lane count of a serve dispatch: the per-shard lane bucket
    times the mesh's shard count (identity without a mesh)."""
    return int(lane_bucket) * (num_shards(mesh) if mesh is not None else 1)


class LaneSharding:
    """The port's placement of a leading lane axis over a mesh's shards
    (fks_tpu's ``NamedSharding(mesh, P(pop axes))``): ``devices`` holds
    each shard's device, ``split`` cuts a batch into equal shard slices
    (host arrays and tensors alike, not moved), ``gather`` joins the
    shards' results on the lead device. Serving runs in one process, so
    a mesh spanning processes is refused."""

    def __init__(self, mesh: Mesh):
        _check_mesh(mesh)
        if mesh.spans_processes:
            raise ValueError("serving runs in one process; a mesh spanning "
                             "processes cannot serve")
        self.mesh = mesh
        self.devices = [d for _, d in _local_shards(mesh)]
        self.lead = self.devices[0]

    @property
    def shards(self) -> int:
        return len(self.devices)

    def split(self, obj) -> list:
        """``obj`` (an array, a tensor, or a dataclass / NamedTuple of
        them with the lane axis leading) cut into ``shards`` equal
        slices, in shard order."""
        lanes = _lead_len(obj)
        if lanes % self.shards:
            raise ValueError(f"{lanes} lanes do not split over "
                             f"{self.shards} shards")
        per = lanes // self.shards
        return [_slice_leaves(obj, s * per, (s + 1) * per)
                for s in range(self.shards)]

    def gather(self, parts):
        return _concat(parts, self.lead)


def _leaves_of(obj):
    import dataclasses

    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return [obj]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return [y for v in obj for y in _leaves_of(v)]
    if dataclasses.is_dataclass(obj):
        return [y for f in dataclasses.fields(obj)
                for y in _leaves_of(getattr(obj, f.name))]
    return []


def _lead_len(obj) -> int:
    return int(_leaves_of(obj)[0].shape[0])


def _slice_leaves(obj, a: int, b: int):
    import dataclasses

    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj[a:b]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_slice_leaves(v, a, b) for v in obj))
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _slice_leaves(getattr(obj, f.name), a, b)
            for f in dataclasses.fields(obj)
            if _leaves_of(getattr(obj, f.name))})
    return obj


def serve_sharding(mesh: Mesh) -> LaneSharding:
    """The lane placement serve batches are split by (fks_tpu's
    ``serve_sharding``)."""
    return LaneSharding(mesh)


class ShardedLanes:
    """A dispatched sharded serve batch: the shards' outputs (results, or
    ``LaneJob``s still running). ``result()`` drains the jobs together
    and joins the shards' results on the lead device."""

    def __init__(self, outs, finish, sharding: LaneSharding):
        self.outs, self._finish, self.sharding = outs, finish, sharding

    def result(self):
        drain([o for o in self.outs if hasattr(o, "advance")])
        return self.sharding.gather([self._finish(s, o)
                                     for s, o in enumerate(self.outs)])


def _sharded_lanes_fn(serve_fn, mesh: Mesh, component: str, layout,
                      finish=None):
    """``make_sharded_*_serve_fn``'s body: ``fn(*args)`` takes every
    argument as a list of per-shard values (replicated ones first, then
    the lane-split ones), calls ``serve_fn(shard, *values)`` for every
    shard before reading any, and returns a ``ShardedLanes``."""
    from fks_tpu_torch.obs.layout import record_layout, tag_layout

    spec = _resolve_layout(layout)
    sharding = serve_sharding(mesh)
    finish = finish or (lambda _s, out: out)

    def fn(*args):
        if any(len(a) != sharding.shards for a in args):
            raise ValueError(f"every argument must hold one value per "
                             f"shard ({sharding.shards})")
        outs = [serve_fn(s, *(a[s] for a in args))
                for s in range(sharding.shards)]
        return ShardedLanes(outs, finish, sharding)

    record_layout(component, spec, mesh=mesh)
    fn.sharding = sharding
    return tag_layout(fn, spec.key)


def make_sharded_serve_fn(serve_fn, mesh: Mesh, layout=None, finish=None):
    """A lane-batched serve pipeline over a mesh (fks_tpu mesh.py:284-303).
    ``serve_fn(shard, pods, ktable, state0)`` runs one shard's slice on
    that shard's device and returns a ``SimResult`` or a
    ``sim.engine.LaneJob``; ``finish(shard, out)`` (default: the output
    itself) turns a drained output into its ``SimResult``. The returned
    ``fn(pods, ktable, state0)`` takes each argument as a list of shard
    slices (``serve_sharding(mesh).split``) and returns a
    ``ShardedLanes``. Lanes need no collective: each shard drains its own
    slice. Tagged with its layout key; the wiring files one
    ``layout_ledger`` row (component "serve")."""
    return _sharded_lanes_fn(serve_fn, mesh, "serve", layout, finish)


def make_sharded_vm_serve_fn(serve_fn, mesh: Mesh, layout=None,
                             finish=None):
    """``make_sharded_serve_fn`` for the VM pipeline ``serve_fn(shard,
    program, pods, ktable, state0)``: the champion's program tables
    (argument 0) are replicated — one copy per shard, every shard holds
    the whole program — while the batch arguments split (fks_tpu
    mesh.py:306-323; component "vm_serve")."""
    return _sharded_lanes_fn(serve_fn, mesh, "vm_serve", layout, finish)


def make_sharded_portfolio_serve_fn(serve_fn, mesh: Mesh, layout=None,
                                    finish=None):
    """``make_sharded_vm_serve_fn`` for the portfolio pipeline
    ``serve_fn(shard, slot_tables, slots, pods, ktable, state0)``: the
    stacked slot tables (argument 0) are replicated, the per-lane slot
    indices (argument 1) split with the lanes they index (fks_tpu
    mesh.py:326-343; component "portfolio_serve")."""
    return _sharded_lanes_fn(serve_fn, mesh, "portfolio_serve", layout,
                             finish)
