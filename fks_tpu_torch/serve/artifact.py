"""Champion-serving artifacts: pinned champion -> warm query engine.

Port of fks_tpu.serve.artifact. The evolution loop persists champions as
JSON in the ledger format (``policies/discovered/funsearch_*.json``); this
module turns one of them plus a declared shape envelope into a query
engine that captures nothing on its warm path:

- ``load_champion`` / ``latest_champion``: read a champion (single-dict
  or top-policies-list ledger files) back off disk.
- ``ShapeEnvelope``: the declared serving envelope — max pods per query,
  max batch, the pod-bucket ladder queries pad to, the gpu_milli range
  the shared wait histogram must cover. Shape-bucketing is what makes
  "warm" possible: a finite set of (lane_bucket, pod_bucket) shapes.
- ``ServeEngine``: where fks_tpu AOT-compiles one XLA executable per
  (lane bucket, pod bucket), the port captures one CUDA graph per
  (lane bucket, pod bucket) on first use or in ``warmup()``. A graph holds
  ``graph_steps`` steps of the batched engine step (``sim.engine.
  GraphedChunk``) and is replayed until the batch's lanes drain, as the
  population runners do; the whole ``max_steps`` loop is never captured.
  The champion's policy and the pinned cluster are constants of the
  graph; the pod tables, the snapshot table and the state are its static
  input buffers, which every batch overwrites in place (the counterpart
  of fks_tpu's donated arguments: steady state allocates nothing per
  batch). On the CPU the same buffers drive the step eagerly. Lane
  buckets are per shard of a mesh (``parallel.mesh.Mesh``; without one,
  a one-shard mesh over the engine's device): a batch of ``lane bucket
  x shards`` lanes splits into equal shard slices, each run by its
  shard's own graph on its shard's device and stream, all launched
  before any is read (``parallel.mesh.make_sharded_serve_fn``).

``enable_persistent_cache`` has no counterpart: PyTorch keeps no cache of
captured graphs across processes, so a loaded artifact captures its
graphs again (ROADMAP records this).

The engine answers are plain dicts (score, scheduled count, per-pod
placements) so the service layer can JSON them straight out.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import math
import os
import time
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fks_tpu_torch import obs
from fks_tpu_torch.data.entities import ClusterArrays, PodArrays, Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.obs.layout import DEFAULT_LAYOUT_KEY, record_layout
from fks_tpu_torch.obs.memory import (
    FOOTPRINT_KEYS, capture_footprint, record_footprint,
)
from fks_tpu_torch.parallel.mesh import (
    _check_mesh, make_sharded_serve_fn, population_mesh, serve_sharding,
)
from fks_tpu_torch.parallel.population import occupancy_stats
from fks_tpu_torch.serve.batcher import (
    PODARRAY_FIELDS, build_query_workload, pack_query_tables, pods_to_dicts,
    query_pack_plan, stack_query_tables, to_tensor, tree_h2d_bytes,
    unpack_query_tables, validate_query_pods,
)
from fks_tpu_torch.sim import get_engine
from fks_tpu_torch.sim.engine import (
    GraphedChunk, LaneJob, SimConfig, bind_step, copy_state_,
    graph_key, resolve_auto_prefilter, static_work_hint, zip_tensors,
)
from fks_tpu_torch.sim.evaluator import max_snapshot_count
from fks_tpu_torch.sim.types import (
    clone_tensors, copy_tensors_, map_tensors,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: where the evolution loop lands its champion JSONs
CHAMPION_DIR = os.path.join(REPO, "policies", "discovered")

ARTIFACT_VERSION = 1

# ---------------------------------------------------------------- champions


@dataclasses.dataclass(frozen=True)
class ChampionSpec:
    """A pinned champion: the evolved source plus its ledger provenance."""

    code: str
    score: float = 0.0
    generation: int = -1
    timestamp: str = ""
    source: str = ""  # file path it was loaded from, "" for in-memory

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict, source: str = "") -> "ChampionSpec":
        return cls(code=doc["code"], score=float(doc.get("score", 0.0)),
                   generation=int(doc.get("generation", -1)),
                   timestamp=str(doc.get("timestamp", "")), source=source)


def load_champion(path: str) -> ChampionSpec:
    """Load a champion from an evolution-ledger JSON: either a single
    champion dict (``save_best_policy``) or a top-policies list
    (``save_top_policies`` — the best-scoring entry wins). Validates the
    fields an engine build would otherwise trip over later: ``code`` must
    be a non-empty string and ``score`` a finite number — a torn or
    hand-mangled ledger file fails HERE, with the path in the message."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: not valid JSON "
                         f"(truncated mid-write?): {e}") from e
    if isinstance(doc, list):
        if not doc:
            raise ValueError(f"{path}: empty top-policies list")
        doc = max(doc, key=lambda d: float(d.get("score", 0.0)))
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: champion JSON must be a dict or list, "
                         f"got {type(doc).__name__}")
    code = doc.get("code")
    if not isinstance(code, str) or not code.strip():
        raise ValueError(f"{path}: no usable 'code' field — "
                         "not a champion JSON")
    try:
        score = float(doc.get("score", 0.0))
    except (TypeError, ValueError) as e:
        raise ValueError(f"{path}: non-numeric 'score' "
                         f"{doc.get('score')!r}") from e
    if not math.isfinite(score):
        raise ValueError(f"{path}: non-finite 'score' {score!r}")
    return ChampionSpec.from_json(doc, source=path)


def latest_champion(directory: str = "", recorder=None) -> Optional[str]:
    """Path of the best champion JSON under ``directory`` (default: the
    repo's discovered-policies ledger), by score then filename; None when
    the ledger is empty. A malformed file is skipped with a recorded
    ``alert`` event instead of hiding the whole ledger or raising."""
    directory = directory or CHAMPION_DIR
    rec = recorder if recorder is not None else obs.get_recorder()
    best: Optional[Tuple[float, str]] = None
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        try:
            spec = load_champion(path)
        except (ValueError, KeyError, OSError) as e:
            rec.event("alert", source="champion_ledger", path=path,
                      detail=f"skipping unreadable champion: {e}")
            continue  # one malformed file must not hide the ledger
        if best is None or spec.score > best[0]:
            best = (spec.score, path)
    return best[1] if best else None


# ----------------------------------------------------------------- envelope


@dataclasses.dataclass(frozen=True)
class ShapeEnvelope:
    """The declared serving envelope: every shape the warm engine must
    answer without capturing. Queries pad UP to the nearest bucket, so
    the graph set is finite and enumerable (``warmup``)."""

    max_pods: int = 1024       # largest query (pods per what-if)
    max_batch: int = 8         # largest coalesced batch (lane bucket cap)
    min_pod_bucket: int = 16   # smallest pod bucket
    pod_bucket_growth: int = 4  # bucket ladder ratio
    max_gpu_milli: int = 1000  # sizes the shared wait histogram

    def __post_init__(self):
        if self.max_pods < 1 or self.max_batch < 1:
            raise ValueError("max_pods and max_batch must be >= 1")
        if self.min_pod_bucket < 1 or self.pod_bucket_growth < 2:
            raise ValueError("min_pod_bucket >= 1, pod_bucket_growth >= 2")

    def pod_buckets(self) -> Tuple[int, ...]:
        """The pod-bucket ladder: min_bucket * growth^i, clipped at
        max_pods (the top bucket is max_pods itself when the ladder does
        not land on it)."""
        out: List[int] = []
        b = self.min_pod_bucket
        while b < self.max_pods:
            out.append(b)
            b *= self.pod_bucket_growth
        out.append(self.max_pods)
        return tuple(dict.fromkeys(out))

    def pod_bucket_for(self, n_pods: int) -> int:
        for b in self.pod_buckets():
            if n_pods <= b:
                return b
        raise ValueError(
            f"query with {n_pods} pods exceeds envelope max_pods "
            f"{self.max_pods}")

    def min_real_pods(self, bucket: int) -> int:
        """Smallest real pod count routed to ``bucket`` (the previous
        rung + 1; 1 for the smallest bucket). Sizes the bucket's fixed
        snapshot-table width: tables grow as real pods shrink, and
        routing guarantees no query below this count lands here."""
        buckets = self.pod_buckets()
        i = buckets.index(bucket)
        return 1 if i == 0 else buckets[i - 1] + 1

    def lane_buckets(self) -> Tuple[int, ...]:
        """Lane (batch) buckets: powers of two up to max_batch, plus
        max_batch itself."""
        out = []
        b = 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(dict.fromkeys(out))

    def lanes_for(self, n_queries: int) -> int:
        for b in self.lane_buckets():
            if n_queries <= b:
                return b
        raise ValueError(
            f"batch of {n_queries} queries exceeds envelope max_batch "
            f"{self.max_batch}; chunk it first")

    @property
    def wait_hist_size(self) -> int:
        """Shared wait-histogram width covering the declared gpu_milli
        range (pinned so every bucket's states share one shape)."""
        return max(1001, self.max_gpu_milli + 2)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "ShapeEnvelope":
        return cls(**doc)


# ---------------------------------------------------------- persistence


def enable_persistent_cache(cache_dir: str) -> None:
    """fks_tpu points the JAX compilation cache at ``cache_dir`` so a
    reloaded artifact fetches its compiled binaries. PyTorch has no such
    cache for captured CUDA graphs: a loaded engine captures its graphs
    anew, on first use or in ``warmup()``. This function therefore only
    makes the directory, and caches nothing (ROADMAP queue 1 item 6)."""
    os.makedirs(cache_dir, exist_ok=True)


def _cluster_to_json(c: ClusterArrays) -> dict:
    """Cluster arrays as JSON lists (fks_tpu's artifact format)."""
    host = lambda x: x.cpu().numpy()  # noqa: E731
    return {
        "cpu_total": host(c.cpu_total).tolist(),
        "mem_total": host(c.mem_total).tolist(),
        "gpu_declared": host(c.gpu_declared).tolist(),
        "num_gpus": host(c.num_gpus).tolist(),
        "gpu_milli_total": host(c.gpu_milli_total).tolist(),
        "gpu_mem_total": host(c.gpu_mem_total).tolist(),
        "gpu_mask": host(c.gpu_mask).astype(int).tolist(),
        "node_mask": host(c.node_mask).astype(int).tolist(),
        "node_ids": list(c.node_ids),
    }


def _cluster_from_json(doc: dict) -> ClusterArrays:
    i32 = lambda k: torch.tensor(doc[k], dtype=torch.int32)  # noqa: E731
    return ClusterArrays(
        cpu_total=i32("cpu_total"), mem_total=i32("mem_total"),
        gpu_declared=i32("gpu_declared"), num_gpus=i32("num_gpus"),
        gpu_milli_total=i32("gpu_milli_total"),
        gpu_mem_total=i32("gpu_mem_total"),
        gpu_mask=torch.tensor(doc["gpu_mask"], dtype=torch.bool),
        node_mask=torch.tensor(doc["node_mask"], dtype=torch.bool),
        node_ids=tuple(doc["node_ids"]),
    )


# ------------------------------------------------------------------ engine


def _pad_rows(a: np.ndarray, lanes: int) -> np.ndarray:
    """Repeat a host table's last query row up to ``lanes`` rows (fks_tpu's
    ``pad_population`` rule)."""
    q = a.shape[0]
    return a if q >= lanes else np.concatenate(
        [a, np.repeat(a[-1:], lanes - q, axis=0)])


def _pad_lanes(pods: PodArrays, state, lanes: int):
    """Pad a host-staged batch's pod tables and states to ``lanes`` by
    repeating its last query: ``(pods, state)``."""
    q = int(pods.cpu.shape[0])
    if q == lanes:
        return pods, state
    pods = dataclasses.replace(
        pods, **{f: _pad_rows(getattr(pods, f), lanes)
                 for f in PODARRAY_FIELDS})
    state = map_tensors(lambda x: torch.cat(
        [x, x[-1:].expand((lanes - q,) + tuple(x.shape[1:]))]), state)
    return pods, state


def _device_scope(device, streams):
    """``device`` and its serving stream (``streams[device]``) for
    whichever thread runs the work; nothing on the CPU."""
    import contextlib

    stack = contextlib.ExitStack()
    if device.type == "cuda":
        stack.enter_context(torch.cuda.device(device))
        stack.enter_context(torch.cuda.stream(streams[device]))
    return stack


class _Graph:
    """One shard's part of a (lanes, pod bucket) program of a serve
    engine, on ``device``: the buffers its step reads and, on CUDA, the
    captured graph that replays the step. Its work runs on the engine's
    stream for ``device`` (``_device_scope``).

    Static inputs, rewritten for every batch: ``pods`` (a PodArrays of
    ``[lanes, P]`` tensors, read by ``finalize``), ``rows`` (the step's
    ``pod_table``), ``kt`` (the snapshot tables, ``[lanes, K]``), the
    graph's state and, where the engine passes per-batch params (the
    portfolio's lane slots), the params. Constants: the stacked cluster
    and the rest of ``params``. Staging buffers take the next batch's
    upload while this one replays."""

    def __init__(self, eng: "ServeEngine", lanes: int, bucket: int,
                 params, example, device):
        dev = self.device = device
        self.streams, self.lead = eng._streams, eng.device
        mod = eng._mod
        self.lanes, self.bucket = lanes, bucket
        self.cfg = cfg = eng.bucket_config(bucket)
        self.max_steps = cfg.max_steps
        self.plan = eng._pack_plan(bucket)
        self.mod = mod
        pods, kt, state0 = example
        cluster = dataclasses.replace(eng.cluster, node_ids=()).to(dev)
        self.pods = PodArrays(**{
            f: to_tensor(getattr(pods, f)).to(dev) for f in PODARRAY_FIELDS})
        self.pods, kt_t = unpack_query_tables(
            self.pods, to_tensor(kt).to(dev), self.plan)
        self.wl = Workload(cluster=zip_tensors(torch.stack,
                                               [cluster] * lanes),
                           pods=self.pods)
        self.rows = mod.pod_table(self.pods)
        self.kt = kt_t.clone()
        self.lane_trace = torch.arange(lanes, device=dev)
        self.params = params
        self.step = bind_step(mod.build_step, self.wl, eng.graph_policy,
                              params, cfg, self.kt, self.max_steps,
                              lane_trace=self.lane_trace,
                              pod_rows=self.rows)
        self.state = map_tensors(lambda x: x.to(dev), state0)
        self.chunk: Optional[GraphedChunk] = None
        self.job: Optional[LaneJob] = None
        self.footprint: Dict[str, int] = {}
        self.staging = None
        if dev.type == "cuda":
            inputs = tree_h2d_bytes(self.pods, self.rows, self.kt,
                                    self.state)
            with capture_footprint(dev, argument_bytes=inputs) as fp:
                self.chunk = GraphedChunk(self.step, self.state,
                                          self.max_steps, mod.lane_active)
            self.footprint = fp

    def stage(self, pods: PodArrays, kt, state, params=None) -> None:
        """Upload a batch's packed host tables and state (and per-batch
        params, device tensors already, like ``kt``) into the staging
        buffers; stream-ordered, so a graph still replaying the previous
        batch reads its own inputs."""
        up = lambda a: to_tensor(a).to(self.device,  # noqa: E731
                                       non_blocking=True)
        self.staging = (PodArrays(**{f: up(getattr(pods, f))
                                     for f in PODARRAY_FIELDS}),
                        kt, map_tensors(lambda x: x.to(self.device,
                                                        non_blocking=True),
                                        state), params)

    def start(self) -> LaneJob:
        """Copy the staged batch into the step's buffers (widening packed
        tables on the device) and queue its first replay (CUDA); returns
        the batch's ``LaneJob``."""
        pods, kt, state, params = self.staging
        self.staging = None
        pods, kt = unpack_query_tables(pods, kt, self.plan)
        for f in PODARRAY_FIELDS:
            getattr(self.pods, f).copy_(getattr(pods, f))
        self.rows.copy_(self.mod.pod_table(self.pods))
        self.kt.copy_(kt)
        if params is not None:
            copy_tensors_(self.params, params)
        if self.chunk is not None:
            copy_state_(self.chunk.state, state)
            self.chunk.replay()
        self.job = LaneJob(self.step, state, self.max_steps,
                           self.mod.lane_active, self.chunk)
        return self.job

    def harvest(self):
        """The drained batch's results, copied out of the graph's buffers
        onto the engine's device, on this shard's stream."""
        with _device_scope(self.device, self.streams):
            res = self.mod.finalize(self.wl, self.cfg, self.job.state,
                                    lane_trace=self.lane_trace)
            return map_tensors(lambda x: x.to(self.lead, copy=True), res)


class _MeshGraph:
    """One (global lanes, pod bucket) program of a serve engine: a
    ``_Graph`` of ``lanes / shards`` lanes per shard of the engine's
    mesh, on the shard's device, run through the engine's sharded serve
    function (``parallel.mesh.make_sharded_*_serve_fn``): every shard's
    batch is started before any is read, the shards drain together (each
    ``LaneJob`` on the stream it was started on), and their results join
    on the lead device."""

    def __init__(self, eng: "ServeEngine", lanes: int, bucket: int,
                 example):
        sh = eng._sharding
        per = lanes // sh.shards
        self.eng, self.lanes, self.bucket = eng, lanes, bucket
        pods, kt, state0 = example
        self.graphs = []
        for p, k, s, dev in zip(sh.split(pods), sh.split(kt),
                                sh.split(state0), sh.devices):
            with _device_scope(dev, eng._streams):
                self.graphs.append(_Graph(
                    eng, per, bucket,
                    eng._graph_constant(eng._graph_params(dev, per)),
                    (p, k, s), dev))
        self.fn = eng._sharded_serve_fn(self.graphs)
        self.footprint = {
            k: sum(g.footprint.get(k, 0) for g in self.graphs)
            for k in FOOTPRINT_KEYS + ("total_bytes",)
        } if self.graphs[0].footprint else {}
        self.staging = None
        self.pending = None

    def stage(self, pods: PodArrays, kt, state, params=None) -> None:
        """Upload each shard's slice of the batch to its device; ``kt``
        (and ``params``, when given) are already per-shard lists."""
        sh = self.eng._sharding
        params = params if params is not None else [None] * sh.shards
        for g, p, k, s, q in zip(self.graphs, sh.split(pods), kt,
                                 sh.split(state), params):
            with _device_scope(g.device, self.eng._streams):
                g.stage(p, k, s, q)
        self.staging = [g.staging for g in self.graphs]

    def start(self) -> None:
        self.pending = self.fn(*self.eng._sharded_args(self.graphs,
                                                       self.staging))
        self.staging = None

    def finish(self):
        return self.pending.result()


class _Inflight(NamedTuple):
    """One dispatched-but-unharvested chunk of the double-buffered
    answer pipeline."""

    graph: _MeshGraph
    idxs: List[int]     # answer slots, in lane order
    bucket: int
    lanes: int
    real: int


class ServeEngine:
    """A pinned (champion, cluster, envelope) triple ready for serving.

    One program per (lane_bucket, pod_bucket) combination
    (``_MeshGraph``, a graph per shard), built on demand or eagerly via ``warmup`` and kept for the engine's
    lifetime; on CUDA it is a captured CUDA graph of the batched step.
    Graphs are keyed by the pod bucket and ``sim.engine.graph_key`` (lane
    count and the params' tensor shapes), so params of another shape never
    replay a graph captured for other buffers. The warm path captures
    nothing: ``obs.telemetry.CompileWatcher`` counts zero captures.

    The hot path touches the host and the PCIe bus no more than it must:
    snapshot trigger tables are cached on the device keyed on a content
    hash of their bytes (``snapshot_cache_stats``), uploads are 16-bit
    packed under ``state_pack`` (``query_pack_plan``), every batch is
    copied into its graph's static buffers so steady state allocates
    nothing for the graph, and ``answer_batch`` double-buffers: chunk
    N+1's stacking and upload overlap chunk N's replays.

    ``engine`` picks the simulation module ("exact" serves reference
    semantics and is the parity default; "flat" trades the documented
    retry-rule divergence for throughput). ``prefilter_k=None`` engages
    the auto-enable heuristic (``sim.engine.resolve_auto_prefilter``).
    ``device`` defaults to ``cuda``. ``mesh`` (a ``parallel.mesh.Mesh``
    of this process) shards the lane axis: lane buckets are per shard,
    each (global lanes, pod bucket) program holds one graph per shard on
    the shard's device, and the engine's device is the mesh's lead
    device. Without a mesh the engine runs a one-shard mesh over
    ``device``. Each device's work runs on a stream of the engine's own
    (``_streams``), whichever thread drives it and whatever stream is
    current there."""

    #: how this engine binds the champion: "aot" makes the policy a
    #: constant of every graph (a new champion = new graphs); "vm"
    #: (serve.vm_engine.VMServeEngine) makes its program tables static
    #: inputs (a new champion = a table copy)
    engine_kind = "aot"
    #: the layout-ledger component of this engine's batches
    layout_component = "serve"
    #: the footprint-ledger component of this engine's graphs
    memory_component = "serve_aot"

    def __init__(self, champion: ChampionSpec, workload: Workload, *,
                 envelope: Optional[ShapeEnvelope] = None,
                 engine: str = "exact",
                 prefilter_k: Optional[int] = None,
                 state_pack: bool = False,
                 max_steps_factor: int = 8,
                 mesh=None,
                 snapshot_cache_max_bytes: int = 0,
                 recorder=None, profiler=None, device=None):
        if engine == "fused":
            raise ValueError(
                "the fused kernel evaluates parametric populations only; "
                "serve champions on 'exact' (parity default) or 'flat'")
        # the lane axis split over the mesh's shards (``mesh`` stays what
        # the caller passed, for the ledgers)
        self.mesh = mesh
        if mesh is not None:
            self._sharding = serve_sharding(mesh)
            if device is not None and \
                    torch.device(device).type != self._sharding.lead.type:
                raise ValueError(f"device={device!r} disagrees with the "
                                 f"mesh's {self._sharding.lead}")
        else:
            self._sharding = serve_sharding(
                population_mesh([resolve_device(device)]))
        self._shards = self._sharding.shards
        self.device = self._sharding.lead
        self.champion = champion
        self.cluster = workload.cluster.to(self.device)
        self._cluster_host = workload.cluster.to("cpu")
        self.base_pods = pods_to_dicts(workload.pods)
        self.envelope = envelope or ShapeEnvelope()
        self.engine_name = engine
        self.state_pack = bool(state_pack)
        self.max_steps_factor = int(max_steps_factor)
        self.recorder = recorder if recorder is not None else obs.get_recorder()
        self.profiler = (profiler if profiler is not None
                         else obs.NULL_PROFILER)
        self._mod = get_engine(engine)
        self._graphs: Dict[tuple, Any] = {}
        self.cold_compiles = 0
        # every batch of this engine runs on one stream per device,
        # whichever thread drives it (the caller's, or the service's
        # batcher thread)
        self._streams = {d: torch.cuda.Stream(d)
                         for d in self._sharding.devices if d.type == "cuda"}
        # device-resident snapshot tables: content-hash -> (buffer, bytes)
        self._ktable_cache: "OrderedDict[Tuple, Tuple[Any, int]]" = \
            OrderedDict()
        self._ktable_cache_cap = 32
        self._ktable_cache_max_bytes = int(snapshot_cache_max_bytes)
        self._ktable_cache_bytes = 0
        self.snapshot_cache_hits = 0
        self.snapshot_cache_misses = 0
        # H2D accounting (bytes actually shipped per answered query)
        self.h2d_bytes_total = 0
        self.h2d_queries = 0
        # host-wall split of the last answer_batch call (pack+upload vs
        # dispatch+harvest) — the serve-request waterfall's engine stages
        self.last_batch_timing: Dict[str, float] = {
            "pack_h2d_s": 0.0, "dispatch_s": 0.0}

        n, g = self.cluster.n_padded, self.cluster.g_padded
        self.param_policy, params, self.policy_tier = \
            self._resolve_policy(champion.code, n, g)
        self.params = map_tensors(lambda x: x.to(self.device), params)
        self.prefilter_k = resolve_auto_prefilter(
            self.param_policy, self.params, n, g,
            override=prefilter_k, recorder=self.recorder,
            work_hint=static_work_hint(champion.code, g),
            device=self.device)

    @staticmethod
    def _resolve_policy(code: str, n: int, g: int):
        """Champion source -> (param_policy, params, tier). VM lowering
        first (the register program as the params — the population tier's
        representation); candidates outside the VM vocabulary fall back
        to the transpiled policy. TranspileError (invalid source)
        propagates: a broken champion is a caller error."""
        from fks_tpu_torch.funsearch import transpiler, vm

        try:
            prog = vm.compile_policy(code, n, g)
            return vm.score_static, prog, "vm"
        except vm.VMUnsupported:
            policy = transpiler.transpile(code)
            return (lambda _p, pod, nodes: policy(pod, nodes)), None, "jit"

    # ----- bucket plumbing

    def bucket_config(self, pod_bucket: int) -> SimConfig:
        """The bucket's SimConfig — SHARED by the batched path and the
        unbatched exact reference (``reference_answer``), so bucket
        padding is part of the serving semantics, not a parity leak."""
        return SimConfig(
            max_steps=max(64, self.max_steps_factor * pod_bucket),
            wait_hist_size=self.envelope.wait_hist_size,
            node_prefilter_k=self.prefilter_k,
            state_pack=self.state_pack,
        )

    def _klen(self, pod_bucket: int) -> int:
        """Fixed snapshot-table width for the bucket, sized at the
        SMALLEST real pod count routing can send here."""
        cfg = self.bucket_config(pod_bucket)
        return max_snapshot_count(cfg.max_steps,
                                  self.envelope.min_real_pods(pod_bucket),
                                  cfg.snapshot_interval)

    def _pack_plan(self, pod_bucket: int) -> dict:
        """The bucket's static upload-packing plan (empty unless
        ``state_pack``)."""
        return query_pack_plan(self.bucket_config(pod_bucket), pod_bucket,
                               self.envelope.max_gpu_milli)

    def _graph_params(self, device, lanes: int):
        """The params a graph of ``lanes`` lanes on ``device`` reads: for
        this engine the champion's own, a constant of each graph (cloned
        into it by ``_graph_constant``)."""
        return map_tensors(lambda x: x.to(device), self.params)

    @property
    def graph_policy(self):
        """The policy the graphs bind to their params: the champion's
        (``param_policy``) for this engine."""
        return self.param_policy

    def _stage_params(self, lanes: int, idxs):
        """Per-batch params to copy into the graphs with the batch (a list
        of one per shard): none for this engine."""
        return None

    def _sharded_serve_fn(self, graphs):
        """The sharded serve function of a ``_MeshGraph``'s shard graphs:
        ``serve_fn(shard, pods, ktable, state0)`` starts one shard."""
        def serve_fn(s, pods, kt, state):
            return self._start_shard(graphs[s], pods, kt, state, None)

        return make_sharded_serve_fn(
            serve_fn, self._sharding.mesh,
            finish=lambda s, _job: graphs[s].harvest())

    def _sharded_args(self, graphs, staging):
        """A staged ``_MeshGraph`` batch as the sharded serve function's
        per-shard argument lists."""
        return tuple([st[i] for st in staging] for i in range(3))

    def _start_shard(self, graph: _Graph, pods, kt, state, params):
        graph.staging = (pods, kt, state, params)
        with _device_scope(graph.device, self._streams):
            return graph.start()

    def _stage_batch(self, pod_lists, bucket: int, lanes: int):
        """Host staging of one chunk: stacked, packed, lane-padded tables
        (numpy) and initial states (host tensors)."""
        pods, kt, s0 = stack_query_tables(
            self._mod, self._cluster_host, pod_lists, bucket,
            self.bucket_config(bucket), self._klen(bucket))
        pods, kt = pack_query_tables(pods, kt, self._pack_plan(bucket))
        return pods, kt, s0

    def _example_batch(self, lanes: int, pod_bucket: int):
        """A minimal valid batch at the bucket's shapes: the smallest
        query routing can send here, replicated across lanes by the same
        pack/pad path real batches use."""
        pods = [{"cpu_milli": 1, "memory_mib": 1, "creation_time": t,
                 "duration_time": 10}
                for t in range(self.envelope.min_real_pods(pod_bucket))]
        pq, kt, s0 = self._stage_batch([pods], pod_bucket, lanes)
        pq, s0 = _pad_lanes(pq, s0, lanes)
        return pq, _pad_rows(kt, lanes), s0

    def _device_scope(self):
        """The engine's (lead) device and stream, for whichever thread
        runs it."""
        return _device_scope(self.device, self._streams)

    def compiled_for(self, lanes: int, pod_bucket: int):
        """The (global lanes, pod_bucket) program, a ``_MeshGraph`` of a
        graph per shard, built (captured on CUDA) on first use; later
        calls replay it."""
        per = lanes // self._shards
        key = (pod_bucket,) + graph_key(
            lanes, self._graph_params(self.device, per))
        hit = self._graphs.get(key)
        if hit is not None:
            return hit
        with self._device_scope(), \
                self.profiler.stage("compile", lanes=lanes, pods=pod_bucket), \
                obs.span("serve_compile", lanes=lanes, pods=pod_bucket,
                         engine=self.engine_name):
            graph = _MeshGraph(self, lanes, pod_bucket,
                               self._example_batch(lanes, pod_bucket))
        self._graphs[key] = graph
        self.cold_compiles += 1
        # footprint ledger: every ladder rung's device claim (None, so no
        # record, on the CPU)
        record_footprint(self.memory_component, self._exe_key(lanes,
                                                              pod_bucket),
                         footprint=graph.footprint, mesh=self.mesh,
                         recorder=self.recorder, engine=self.engine_name,
                         engine_kind=self.engine_kind,
                         layout_key=DEFAULT_LAYOUT_KEY)
        return graph

    def _graph_constant(self, params):
        """What a new graph closes over as its params."""
        return clone_tensors(params)

    def _exe_key(self, lanes: int, pod_bucket: int) -> str:
        return f"lanes={lanes},pods={pod_bucket}"

    def warmup(self, lane_buckets: Optional[Sequence[int]] = None,
               pod_buckets: Optional[Sequence[int]] = None) -> int:
        """Eagerly build every (lane, pod) bucket combination (or the
        given subsets; lane buckets are per shard and scale by the
        mesh's shard count). Returns the number of programs now
        resident."""
        with self.profiler.stage("warmup"):
            for lb in lane_buckets or self.envelope.lane_buckets():
                for pb in pod_buckets or self.envelope.pod_buckets():
                    self.compiled_for(lb * self._shards, pb)
        return len(self._graphs)

    # ----- answering

    def _global_lanes(self, n_queries: int) -> int:
        """Global lane count for an n-query chunk: the smallest envelope
        lane bucket covering the per-shard share, times the shards."""
        per_shard = -(-int(n_queries) // self._shards)
        return self.envelope.lanes_for(max(1, per_shard)) * self._shards

    def snapshot_cache_stats(self) -> dict:
        """Device-resident snapshot-table cache counters plus the H2D
        accounting — the ``fks_serve_snapshot_cache_*`` gauge source."""
        total = self.snapshot_cache_hits + self.snapshot_cache_misses
        return {
            "hits": self.snapshot_cache_hits,
            "misses": self.snapshot_cache_misses,
            "entries": len(self._ktable_cache),
            "hit_rate": self.snapshot_cache_hits / total if total else 0.0,
            "h2d_bytes_total": int(self.h2d_bytes_total),
            "h2d_bytes_per_query": (self.h2d_bytes_total / self.h2d_queries
                                    if self.h2d_queries else 0.0),
            "bytes": int(self._ktable_cache_bytes),
            "max_bytes": int(self._ktable_cache_max_bytes),
        }

    @property
    def snapshot_cache_bytes(self) -> int:
        """Bytes of snapshot tables currently resident in the cache."""
        return int(self._ktable_cache_bytes)

    def _ktable_for(self, lanes: int, bucket: int, kt: np.ndarray):
        """The device-resident snapshot-table buffers for this batch (one
        per shard, each on its shard's device and stream): content-hash
        cache keyed on the (packed) table bytes at the dispatch shape.
        Consecutive batches whose queries share pod counts hash
        identically and re-use the resident buffer, shipping zero
        snapshot bytes."""
        digest = hashlib.blake2b(kt.tobytes(), digest_size=16).digest()
        key = (lanes, bucket, kt.dtype.str, digest)
        hit = self._ktable_cache.get(key)
        if hit is not None:
            self._ktable_cache.move_to_end(key)
            self.snapshot_cache_hits += 1
            return hit[0]
        self.snapshot_cache_misses += 1
        padded = _pad_rows(kt, lanes)
        dev = []
        for k, d in zip(self._sharding.split(padded), self._sharding.devices):
            with _device_scope(d, self._streams):
                dev.append(to_tensor(k).to(d, non_blocking=True))
        nbytes = int(padded.nbytes)
        self.h2d_bytes_total += nbytes
        self._ktable_cache[key] = (dev, nbytes)
        self._ktable_cache_bytes += nbytes
        while self._ktable_cache and (
                len(self._ktable_cache) > self._ktable_cache_cap
                or (self._ktable_cache_max_bytes
                    and self._ktable_cache_bytes
                    > self._ktable_cache_max_bytes)):
            _, (_, freed) = self._ktable_cache.popitem(last=False)
            self._ktable_cache_bytes -= freed
        return dev

    def answer_batch(self, pod_lists: Sequence[Sequence[dict]]) -> List[dict]:
        """Answer N "place this pod list" queries. Queries are grouped by
        pod bucket, chunked at the max batch, lane-padded to the graph's
        lane bucket, run through the warm graph, and scattered back in
        input order. Chunks are DOUBLE-BUFFERED: chunk i+1 is stacked
        and uploaded into its graph's staging buffers while chunk i's
        replays run, and a graph's static inputs are rewritten only after
        its previous batch was harvested."""
        for pods in pod_lists:
            validate_query_pods(pods, max_pods=self.envelope.max_pods,
                                max_gpu_milli=self.envelope.max_gpu_milli)
        self.last_batch_timing = {"pack_h2d_s": 0.0, "dispatch_s": 0.0}
        answers: List[Optional[dict]] = [None] * len(pod_lists)
        groups: Dict[int, List[int]] = {}
        for i, pods in enumerate(pod_lists):
            groups.setdefault(
                self.envelope.pod_bucket_for(len(pods)), []).append(i)
        mb = self.envelope.max_batch * self._shards
        with self._device_scope():
            inflight: Optional[_Inflight] = None
            for bucket, idxs in groups.items():
                for c0 in range(0, len(idxs), mb):
                    nxt = self._dispatch_chunk(bucket, idxs[c0:c0 + mb],
                                               pod_lists)
                    if inflight is not None:
                        self._harvest(inflight, pod_lists, answers)
                    inflight = nxt
                    inflight.graph.start()
            if inflight is not None:
                self._harvest(inflight, pod_lists, answers)
        return answers  # type: ignore[return-value]

    def _dispatch_chunk(self, bucket: int, idxs: List[int],
                        pod_lists) -> _Inflight:
        """Stack + pack + upload one chunk into its graph's staging
        buffers; ``_MeshGraph.start`` then loads and queues it."""
        t0 = time.perf_counter()
        lanes = self._global_lanes(len(idxs))
        pods, kt, s0 = self._stage_batch([pod_lists[i] for i in idxs],
                                         bucket, lanes)
        graph = self.compiled_for(lanes, bucket)
        with self.profiler.stage("h2d", lanes=lanes, pods=bucket):
            kt_dev = self._ktable_for(lanes, bucket, kt)
            pods, s0 = _pad_lanes(pods, s0, lanes)
            graph.stage(pods, kt_dev, s0, self._stage_params(lanes, idxs))
            self.h2d_bytes_total += tree_h2d_bytes(pods, s0)
        self.h2d_queries += len(idxs)
        self.last_batch_timing["pack_h2d_s"] += time.perf_counter() - t0
        return _Inflight(graph, list(idxs), bucket, lanes, len(idxs))

    def _harvest(self, inflight: _Inflight, pod_lists, answers) -> None:
        """Drive a started chunk to its end and scatter its answers."""
        graph, idxs, bucket, lanes, real = inflight
        t0 = time.perf_counter()
        with self.profiler.stage("steady", **occupancy_stats(real, lanes)):
            with obs.span("serve_batch", lanes=lanes, bucket_pods=bucket,
                          real=real):
                res = graph.finish()
                host = {k: getattr(res, k).cpu().numpy() for k in (
                    "assigned_node", "assigned_gpus", "policy_score",
                    "scheduled_pods", "failed", "truncated",
                    "events_processed")}
        self.last_batch_timing["dispatch_s"] += time.perf_counter() - t0
        record_layout(self.layout_component, DEFAULT_LAYOUT_KEY,
                      mesh=self.mesh, recorder=self.recorder,
                      **occupancy_stats(real, lanes))
        for lane, i in enumerate(idxs):
            answers[i] = self._extract(host, lane, len(pod_lists[i]),
                                       bucket, lanes)

    def _extract(self, res: dict, lane: Optional[int], p_real: int,
                 bucket: int, lanes: int) -> dict:
        """One lane of host result arrays -> an answer dict (``lane=None``
        reads a one-lane result). Placements cover REAL pods only; node
        -1 means unplaced; GPU bitmask unpacked to indices."""
        pick = (lambda k: res[k][0]) if lane is None else \
            (lambda k: res[k][lane])
        assigned = pick("assigned_node")[:p_real]
        gpus = pick("assigned_gpus")[:p_real].astype(np.int64)
        node_ids = self.cluster.node_ids
        placements = []
        for i, (nd, gm) in enumerate(zip(assigned, gpus)):
            row = {"pod": i, "node": int(nd),
                   "gpus": [b for b in range(int(gm).bit_length())
                            if int(gm) >> b & 1]}
            if 0 <= int(nd) < len(node_ids):
                row["node_id"] = node_ids[int(nd)]
            placements.append(row)
        return {
            "score": float(pick("policy_score")),
            "scheduled": int(pick("scheduled_pods")),
            "failed": bool(pick("failed")),
            "truncated": bool(pick("truncated")),
            "events": int(pick("events_processed")),
            "placements": placements,
            "bucket_pods": bucket,
            "bucket_lanes": lanes,
        }

    def reference_answer(self, pods: Sequence[dict]) -> dict:
        """The UNBATCHED exact-engine answer for one query, at the same
        bucket semantics (same padded workload, same SimConfig) — what
        the ParitySentinel audits served answers against. Independent
        code path on purpose: one lane through ``make_param_run_fn``, with
        its own ``loop_tables`` sizing and no lane padding (on CUDA it
        captures a graph of its own per call, as fks_tpu compiles one)."""
        from fks_tpu_torch.sim import engine as exact

        validate_query_pods(pods, max_pods=self.envelope.max_pods,
                            max_gpu_milli=self.envelope.max_gpu_milli)
        bucket = self.envelope.pod_bucket_for(len(pods))
        cfg = self.bucket_config(bucket)
        with self._device_scope():
            wl = build_query_workload(self.cluster, pods, bucket)
            res = exact.make_param_run_fn(wl, self.param_policy, cfg)(
                self.params, exact.initial_state(wl, cfg))
            host = {k: getattr(res, k).cpu().numpy() for k in (
                "assigned_node", "assigned_gpus", "policy_score",
                "scheduled_pods", "failed", "truncated", "events_processed")}
        return self._extract(host, None, len(pods), bucket, 1)

    # ----- persistence

    def save(self, directory: str) -> str:
        """Persist the engine spec (champion + cluster + envelope + knobs)
        as fks_tpu's ``artifact.json`` (version 1); fks_tpu's
        ``ServeEngine.load`` reads it, and ``load`` reads fks_tpu's."""
        os.makedirs(directory, exist_ok=True)
        doc = {
            "version": ARTIFACT_VERSION,
            "champion": self.champion.to_json(),
            "envelope": self.envelope.to_json(),
            "engine": self.engine_name,
            "engine_kind": self.engine_kind,
            "prefilter_k": self.prefilter_k,
            "state_pack": self.state_pack,
            "max_steps_factor": self.max_steps_factor,
            "policy_tier": self.policy_tier,
            "cluster": _cluster_to_json(self.cluster),
            "base_pods": self.base_pods,
        }
        cap = getattr(self, "program_capacity", None)
        if cap is not None:
            doc["program_capacity"] = int(cap)
        path = os.path.join(directory, "artifact.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)  # atomic: a loader never sees a half-write
        enable_persistent_cache(os.path.join(directory, "xla_cache"))
        return path

    @classmethod
    def load(cls, directory: str, recorder=None, mesh=None,
             device=None) -> "ServeEngine":
        """Rebuild a saved engine (fks_tpu's or the port's artifact).
        Self-contained: the artifact pins the cluster arrays and the
        resolved prefilter-k (no re-probe). An artifact saved by a VM
        engine loads as one, or, with a portfolio manifest, as a
        ``portfolio.PortfolioEngine`` of its whole slot table. ``mesh`` is
        a property of the process that runs the engine, so it is passed
        here and never saved."""
        if mesh is not None:
            _check_mesh(mesh)
        with open(os.path.join(directory, "artifact.json")) as f:
            doc = json.load(f)
        if doc.get("version") != ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {doc.get('version')} != "
                f"{ARTIFACT_VERSION}")
        cluster = _cluster_from_json(doc["cluster"])
        wl = Workload(cluster=cluster,
                      pods=_pods_from_dicts(doc.get("base_pods", [])))
        extra = {}
        portfolio = doc.get("portfolio")
        if doc.get("engine_kind", "aot") == "vm" and cls.engine_kind != "vm":
            if portfolio:
                from fks_tpu_torch.portfolio.engine import PortfolioEngine
                cls = PortfolioEngine
            else:
                from fks_tpu_torch.serve.vm_engine import VMServeEngine
                cls = VMServeEngine
        if cls.engine_kind == "vm" and doc.get("program_capacity"):
            extra["program_capacity"] = int(doc["program_capacity"])
        champ: Any = ChampionSpec.from_json(doc["champion"])
        if portfolio and getattr(cls, "is_portfolio", False):
            champ = [ChampionSpec.from_json(c, source=c.get("source", ""))
                     for c in portfolio["slots"]]
            extra["n_slots"] = int(portfolio["n_slots"])
        return cls(champ, wl,
                   envelope=ShapeEnvelope.from_json(doc["envelope"]),
                   engine=doc["engine"],
                   prefilter_k=int(doc["prefilter_k"]),
                   state_pack=bool(doc["state_pack"]),
                   max_steps_factor=int(doc["max_steps_factor"]),
                   mesh=mesh, recorder=recorder, device=device, **extra)


def _pods_from_dicts(pods: List[dict]) -> PodArrays:
    """Query-schema dicts -> a real-sized PodArrays (artifact base trace)."""
    from fks_tpu_torch.serve.batcher import DEFAULT_DURATION

    p = max(1, len(pods))
    col = lambda f, d=0: torch.tensor(  # noqa: E731
        [int(x.get(f, d)) for x in pods] + [0] * (p - len(pods)),
        dtype=torch.int32)
    return PodArrays(
        cpu=col("cpu_milli"), mem=col("memory_mib"),
        num_gpu=col("num_gpu"), gpu_milli=col("gpu_milli"),
        creation_time=col("creation_time"),
        duration=col("duration_time", DEFAULT_DURATION),
        tie_rank=torch.arange(p, dtype=torch.int32),
        pod_mask=torch.arange(p) < len(pods),
        pod_ids=tuple(f"q-{i:05d}" for i in range(len(pods))),
    )
