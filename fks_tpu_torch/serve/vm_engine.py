"""VM-native serving: the champion is a static input, not a constant.

Port of fks_tpu.serve.vm_engine. ``ServeEngine`` (serve.artifact) makes
the champion's policy a constant of every captured graph, so a promotion
captures the whole bucket ladder again. ``VMServeEngine`` binds it the way
the evolve tier does: the champion is lowered to a ``VMProgram`` register
program, NOP-padded to a capacity bucket, and its packed tables
(``batcher.pack_program_tables``) are static input buffers of the graphs,
shared by every graph of that capacity. One graph per (lane bucket, pod
bucket) then serves EVERY champion of that capacity bucket, and a hot-swap
degenerates to ``swap_program``: transpile + lower + pack + upload of the
new tables and a copy into those buffers — zero graph captures.

Graphs are keyed by ``sim.engine.graph_key`` (lane count and the program's
tensor shapes), so a program of another capacity bucket captures graphs of
its own instead of being copied into another shape's buffers. With a mesh
every shard device holds its own copy of the tables (the replicated
argument of ``parallel.mesh.make_sharded_vm_serve_fn``), and
``swap_program`` copies the new tables into each.

Champions outside the VM vocabulary raise ``VMUnsupported`` from the
constructor / ``swap_program`` — the caller (``cli serve``) falls back to
the closure engine, which remains the exact reference and the escape
hatch.
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.funsearch import vm
from fks_tpu_torch.parallel.mesh import make_sharded_vm_serve_fn
from fks_tpu_torch.serve.artifact import (
    ChampionSpec, ServeEngine, _device_scope,
)
from fks_tpu_torch.serve.batcher import (
    pack_program_tables, to_tensor, tree_h2d_bytes, unpack_program_tables,
)
from fks_tpu_torch.sim.types import map_tensors


class VMServeEngine(ServeEngine):
    """A serve engine whose graphs are champion-agnostic.

    Construction lowers the champion via ``vm.compile_policy`` and pads
    it to ``program_capacity`` (default: ``vm.capacity_bucket`` of the
    lowered op count) — ``VMUnsupported`` propagates to the caller, the
    fallback trigger. Everything else (shape envelope, bucket routing,
    snapshot-table cache, double-buffered dispatch) is inherited; the
    graphs differ only in reading the program from the capacity's shared
    table buffers.

    ``swap_program(champion)`` is the whole promotion hot path: it
    re-binds the served champion IN PLACE under a lock that excludes
    in-flight batches, and returns the previous ``ChampionSpec`` as the
    rollback handle (``ServeService.swap_engine`` accepts a
    ``ChampionSpec`` and routes it here)."""

    engine_kind = "vm"
    layout_component = "vm_serve"
    memory_component = "serve_vm"

    def __init__(self, champion: ChampionSpec, workload: Workload, *,
                 program_capacity: Optional[int] = None, **kw):
        # set BEFORE super().__init__: the parent constructor resolves
        # the policy (which fixes the capacity bucket) during init
        self._capacity_override = (int(program_capacity)
                                   if program_capacity else None)
        self.program_capacity = 0
        self.vm_swaps = 0
        self.vm_swap_h2d_bytes = 0
        self.last_swap_breakdown: dict = {}
        # host-side transpile cache: canonical code key -> padded
        # VMProgram; a probation rollback or A/B flip re-swaps a champion
        # this engine already lowered, so the warm swap is the upload alone
        self._transpile_cache: "OrderedDict[tuple, vm.VMProgram]" = \
            OrderedDict()
        self._transpile_cache_max = 32
        self.transpile_cache_hits = 0
        self.transpile_cache_misses = 0
        # the cache is shared with shadow views AND a background transpile
        # worker — all access goes under this lock
        self._transpile_lock = threading.Lock()
        # code keys whose transpile was overlapped with shadow eval: the
        # next swap of that champion reports transpile_overlapped=True
        self._overlap_warmed: set = set()
        # swaps exclude in-flight batches: answer_batch holds this for the
        # whole batch, swap_program for the flip. A shadow view shares it,
        # since it shares the graphs (and their buffers) too. The
        # turnstile lets a waiting swap in before the next batch: batches
        # pass through it, a swap holds it while it waits for the lock, so
        # callers answering batches back to back cannot starve a swap
        self._swap_lock = threading.RLock()
        self._swap_turnstile = threading.Lock()
        # the graphs' program buffers, per (capacity, device): (packed
        # device tables, the VMProgram of views into them), and which
        # uploaded tables they hold now (shared with shadow views)
        self._graph_tables: Dict[tuple, tuple] = {}
        self._graph_holds: Dict[tuple, object] = {}
        super().__init__(champion, workload, **kw)
        self._prog_dev = self._upload_program(self.params)

    # ----- champion lowering / residency

    def _resolve_policy(self, code: str, n: int, g: int):
        """Champion source -> (score_static, padded VMProgram, "vm"). No
        transpiled fallback here — a champion outside the VM vocabulary
        raises ``VMUnsupported`` to the caller, who serves it on the
        closure engine instead."""
        prog = vm.compile_policy(code, n, g)
        cap = self._capacity_override or vm.capacity_bucket(int(prog.n_ops))
        prog = vm.pad_capacity(prog, cap)  # VMUnsupported if too long
        self.program_capacity = cap
        # seed the transpile cache: re-swapping the construction champion
        # (rollback after a failed promotion) is a warm swap
        with self._transpile_lock:
            self._transpile_cache[self._code_key(code, n, g, cap)] = prog
        return vm.score_static, prog, "vm"

    @staticmethod
    def _code_key(code: str, n: int, g: int, cap: int) -> tuple:
        """Canonical transpile-cache key: exact content hash of the
        champion source plus the lowering shape (never a fuzzy
        fingerprint: a swap must serve exactly what was promoted)."""
        return (hashlib.sha256(code.encode()).hexdigest(), n, g, cap)

    def _lower_champion(self, code: str, n: int, g: int) -> tuple:
        """``compile_policy`` + ``pad_capacity`` through the host-side
        cache; returns ``(prog, "hit"|"miss")``. ``VMUnsupported``
        propagates uncached — a rejected champion must re-raise on retry,
        not silently hit."""
        key = self._code_key(code, n, g, self.program_capacity)
        with self._transpile_lock:
            hit = self._transpile_cache.get(key)
            if hit is not None:
                self.transpile_cache_hits += 1
                self._transpile_cache.move_to_end(key)
                return hit, "hit"
        prog = vm.pad_capacity(vm.compile_policy(code, n, g),
                               self.program_capacity)
        with self._transpile_lock:
            self.transpile_cache_misses += 1
            self._transpile_cache[key] = prog
            while len(self._transpile_cache) > self._transpile_cache_max:
                self._transpile_cache.popitem(last=False)
        return prog, "miss"

    def begin_overlapped_transpile(self, champion: ChampionSpec):
        """Kick the host-side transpile of ``champion`` on a worker
        thread, so a cache miss's ``compile_policy`` overlaps a shadow
        replay instead of sitting on the commit swap's critical path. The
        worker lowers THROUGH the shared transpile cache; the next swap of
        this champion reports ``transpile_overlapped=True``.
        ``VMUnsupported`` candidates are swallowed — the swap itself
        re-raises. Returns the thread (joinable in tests)."""
        n, g = self.cluster.n_padded, self.cluster.g_padded
        key = self._code_key(champion.code, n, g, self.program_capacity)

        def _work() -> None:
            try:
                self._lower_champion(champion.code, n, g)
            except vm.VMUnsupported:
                return
            with self._transpile_lock:
                self._overlap_warmed.add(key)

        thread = threading.Thread(target=_work, daemon=True,
                                  name="vm-transpile-overlap")
        thread.start()
        return thread

    def _consume_overlap(self, key: tuple) -> bool:
        """Whether this swap's transpile was prewarmed by an overlapped
        worker (one-shot: the flag is consumed)."""
        with self._transpile_lock:
            if key in self._overlap_warmed:
                self._overlap_warmed.discard(key)
                return True
            return False

    def _upload_program(self, prog: vm.VMProgram) -> tuple:
        """Packed program tables -> device tensors, synchronously — the
        swap's H2D cost must be on the swap, not smeared into the next
        batch."""
        packed = tuple(to_tensor(x).to(self.device)
                       for x in pack_program_tables(prog))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return packed

    def _unpack_tables(self, tables):
        """Device tables -> the program the graphs read (views)."""
        return unpack_program_tables(tables)

    def _graph_program(self, device=None):
        """The program the graphs of this capacity on ``device`` (default:
        the engine's) read: views into that device's table buffers, made
        on first need."""
        key = (self.program_capacity,
               self.device if device is None else device)
        if key not in self._graph_tables:
            tables = tuple(x.to(device, copy=True) for x in self._prog_dev)
            self._graph_tables[key] = (tables, self._unpack_tables(tables))
            self._graph_holds[key] = self._prog_dev
        return self._graph_tables[key][1]

    def _hold_program(self) -> None:
        """Copy this engine's tables into its capacity's graph buffers on
        every device unless they hold them already (call under
        ``_swap_lock``); each copy runs on its device's serving stream,
        where the graphs read the buffers."""
        for key, (tables, _) in self._graph_tables.items():
            if key[0] != self.program_capacity \
                    or self._graph_holds.get(key) is self._prog_dev:
                continue
            with _device_scope(key[1], self._streams):
                for dst, src in zip(tables, self._prog_dev):
                    dst.copy_(src)
            self._graph_holds[key] = self._prog_dev

    def swap_program(self, champion: ChampionSpec) -> ChampionSpec:
        """The zero-capture promotion hot path: lower the new champion,
        pad to THIS engine's capacity bucket, upload the packed tables and
        copy them into the graphs' buffers. Raises ``VMUnsupported``
        (champion outside the vocabulary, or longer than the bucket) with
        the engine untouched. Returns the previous champion — the rollback
        handle; rolling back is another ``swap_program``."""
        t0 = time.perf_counter()
        n, g = self.cluster.n_padded, self.cluster.g_padded
        prog, cache = self._lower_champion(champion.code, n, g)
        overlapped = self._consume_overlap(
            self._code_key(champion.code, n, g, self.program_capacity))
        t1 = time.perf_counter()
        dev = self._upload_program(prog)
        t2 = time.perf_counter()
        h2d = tree_h2d_bytes(pack_program_tables(prog))
        with self._swap_flip():  # exclude in-flight batches for the flip
            old = self.champion
            self.champion = champion
            self.params = map_tensors(lambda x: x.to(self.device), prog)
            self._prog_dev = dev
            self._hold_program()
        self.vm_swaps += 1
        self.vm_swap_h2d_bytes += h2d
        self.last_swap_breakdown = {
            "transpile_ms": round((t1 - t0) * 1e3, 3),
            "h2d_ms": round((t2 - t1) * 1e3, 3),
            "swap_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "h2d_bytes": h2d,
            "capacity": self.program_capacity,
            "transpile_cache": cache,
            "transpile_overlapped": overlapped,
            "transpile_cache_hits": self.transpile_cache_hits,
            "transpile_cache_misses": self.transpile_cache_misses,
        }
        self.recorder.event("vm_swap", outcome="swapped",
                            champion=champion.source or "<inline>",
                            **self.last_swap_breakdown)
        return old

    def shadow_for(self, champion: ChampionSpec) -> "VMServeEngine":
        """A shadow VIEW of this engine serving ``champion``: shares the
        graph set and the device snapshot cache (warm by construction —
        shadow evaluation captures nothing) with its own champion tables,
        so a candidate can be replayed on live traffic while the
        incumbent keeps serving. The two take turns on the shared graphs
        (one lock); each batch finds its own tables in the buffers.
        ``VMUnsupported`` propagates — the fallback trigger."""
        n, g = self.cluster.n_padded, self.cluster.g_padded
        # shares the incumbent's transpile cache too: promoting the
        # champion just shadow-evaluated is then a warm swap
        prog, _ = self._lower_champion(champion.code, n, g)
        shadow = copy.copy(self)
        shadow.champion = champion
        shadow.params = map_tensors(lambda x: x.to(self.device), prog)
        shadow._prog_dev = self._upload_program(prog)
        shadow.last_batch_timing = {"pack_h2d_s": 0.0, "dispatch_s": 0.0}
        shadow.last_swap_breakdown = {}
        return shadow

    # ----- graphs (champion-agnostic)

    def _graph_params(self, device, lanes: int):
        return self._graph_program(device)

    def _sharded_serve_fn(self, graphs):
        """``serve_fn(shard, program, pods, ktable, state0)``: the program
        is the shard's own table buffers, replicated per device."""
        def serve_fn(s, program, pods, kt, state):
            return self._start_shard(graphs[s], pods, kt, state, program)

        return make_sharded_vm_serve_fn(
            serve_fn, self._sharding.mesh,
            finish=lambda s, _job: graphs[s].harvest())

    def _sharded_args(self, graphs, staging):
        return ([self._graph_program(g.device) for g in graphs],) + \
            super()._sharded_args(graphs, staging)

    def _graph_constant(self, params):
        # the shared buffers themselves: swap_program rewrites them
        return params

    def _exe_key(self, lanes: int, pod_bucket: int) -> str:
        return (f"lanes={lanes},pods={pod_bucket},"
                f"cap={self.program_capacity}")

    # ----- answering

    @contextlib.contextmanager
    def _batch_scope(self):
        """Hold the swap lock for a whole batch, after letting a waiting
        swap go first."""
        with self._swap_turnstile:
            pass
        with self._swap_lock:
            yield

    @contextlib.contextmanager
    def _swap_flip(self):
        """Hold the swap lock for a flip; new batches wait meanwhile."""
        with self._swap_turnstile, self._swap_lock:
            yield

    def answer_batch(self, pod_lists):
        # a whole batch answers under ONE champion: swap_program's flip
        # waits for the in-flight batch instead of tearing it; the batch
        # turn comes first (``ServeEngine.exclusive``)
        with self.exclusive(), self._batch_scope():
            self._hold_program()
            return super().answer_batch(pod_lists)
