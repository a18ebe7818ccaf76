"""PortfolioEngine: N resident champions in ONE set of warm graphs.

Port of fks_tpu.portfolio.engine. ``VMServeEngine`` made the champion a
static input of its graphs; this engine makes that input a table of
champions. All N resident ``VMProgram``s are padded to one shared
capacity bucket, packed into one stacked block (``batcher.
pack_portfolio_tables``) and copied into every graph's table buffers, on
every shard device of a mesh, while each batch lane carries a slot index
(a per-graph buffer, copied in with the batch) that ``vm.select_slot``
gathers inside the step. One graph per (lanes, pod bucket) then answers
batches that mix tenants and policies, and the whole fleet shares its
captures.

Slot lifecycle is the ``swap_program`` story per slot: ``swap_slot(i,
champion)`` lowers through the shared transpile cache, re-stacks the slot
table on the host, uploads the block and copies it into the graphs'
buffers under the batch lock — zero graph captures, the old slot
champion returned as the rollback handle, one ``slot_swap`` event
emitted. Spare slots (``n_slots`` > len(champions)) start as clones of
slot 0: staging capacity for a candidate, not a new capture.
"""
from __future__ import annotations

import json
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.funsearch import vm
from fks_tpu_torch.parallel.mesh import make_sharded_portfolio_serve_fn
from fks_tpu_torch.serve.artifact import (
    ChampionSpec, ServeEngine, _device_scope,
)
from fks_tpu_torch.serve.batcher import (
    pack_portfolio_tables, to_tensor, tree_h2d_bytes,
    unpack_portfolio_tables,
)
from fks_tpu_torch.serve.vm_engine import VMServeEngine
from fks_tpu_torch.sim.types import map_tensors


class PortfolioParams(NamedTuple):
    """What a portfolio graph's step reads: the slot-stacked program
    (views of the device's table buffers, shared by its graphs) and the
    graph's own per-lane slot indices."""

    tables: vm.VMProgram  # leading slot axis on every field
    slots: torch.Tensor  # i64[lanes]


def portfolio_score(params: PortfolioParams, pod, nodes) -> torch.Tensor:
    """Each lane's policy is its slot's program (``vm.select_slot``
    gathers one program per lane), run by ``vm.score_static``."""
    return vm.score_static(vm.select_slot(params.tables, params.slots),
                           pod, nodes)


portfolio_score.graph_steps = vm.score_static.graph_steps


class PortfolioEngine(VMServeEngine):
    """A VM serve engine whose resident program is a slot table.

    ``champions`` fill slots 0..len-1 (slot 0 is the default and
    reference champion — ``self.champion``/``self.params`` track it so
    every inherited single-champion path, ``reference_answer`` included,
    stays honest); ``n_slots`` (default ``len(champions)``) fixes the
    slot table's shape, so spare slots are free staging capacity, not a
    new capture. Every champion must lower to the VM vocabulary:
    ``VMUnsupported`` propagates from construction, and the Router's
    coverage fallback keeps such champions on the closure engine."""

    is_portfolio = True
    layout_component = "portfolio_serve"

    def __init__(self, champions: Sequence[ChampionSpec],
                 workload: Workload, *, n_slots: Optional[int] = None,
                 program_capacity: Optional[int] = None, **kw):
        champions = list(champions)
        if not champions:
            raise ValueError("PortfolioEngine needs at least one champion")
        self.n_slots = int(n_slots) if n_slots else len(champions)
        if self.n_slots < len(champions):
            raise ValueError(
                f"n_slots={self.n_slots} < {len(champions)} champions")
        # consumed by _resolve_policy during the parent constructor
        self._pending_portfolio = champions
        self._slot_champions: List[ChampionSpec] = []
        self._slot_progs: List[vm.VMProgram] = []
        self.slot_requests = [0] * self.n_slots
        self.slot_swaps = [0] * self.n_slots
        self.last_slot_swapped: Optional[int] = None
        self._batch_slots: Optional[List[int]] = None
        super().__init__(champions[0], workload,
                         program_capacity=program_capacity, **kw)
        # the parent uploaded slot 0 alone; replace it with the full table
        self._prog_dev = self._upload_stacked(self._slot_progs)

    # ----- portfolio lowering / residency

    def _resolve_policy(self, code: str, n: int, g: int):
        """Lower every pending champion, size the shared capacity bucket
        to the longest member, pad all to it, seed the transpile cache
        (re-swapping a construction champion is a warm swap). The parent
        contract (score_static, the slot-0 program, "vm") holds."""
        champs = self._pending_portfolio
        raw = [vm.compile_policy(c.code, n, g) for c in champs]
        cap = self._capacity_override or max(
            vm.capacity_bucket(int(p.n_ops)) for p in raw)
        progs = [vm.pad_capacity(p, cap) for p in raw]
        self.program_capacity = cap
        with self._transpile_lock:
            for c, p in zip(champs, progs):
                self._transpile_cache[self._code_key(c.code, n, g, cap)] = p
        spare = self.n_slots - len(champs)
        self._slot_champions = list(champs) + [champs[0]] * spare
        self._slot_progs = list(progs) + [progs[0]] * spare
        return vm.score_static, progs[0], "vm"

    @property
    def slot_champions(self) -> List[ChampionSpec]:
        """The resident champion of every slot (copy)."""
        return list(self._slot_champions)

    def _upload_stacked(self, progs: Sequence[vm.VMProgram]) -> tuple:
        """Stacked slot tables -> device tensors on the lead device,
        synchronously; ``_hold_program`` copies them into every device's
        graph buffers."""
        packed = tuple(to_tensor(x).to(self.device)
                       for x in pack_portfolio_tables(progs))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return packed

    def _unpack_tables(self, tables):
        return unpack_portfolio_tables(tables)

    def swap_slot(self, slot: int, champion: ChampionSpec) -> ChampionSpec:
        """Per-slot promotion with zero captures: lower the champion (warm
        through the shared transpile cache), re-stack the slot table on
        the host, upload it, and flip the tables and copy them into the
        graphs' buffers under the batch lock. Raises ``VMUnsupported``
        with the engine untouched. Returns the slot's previous champion —
        the rollback handle; rolling back is another ``swap_slot``. Emits
        one ``slot_swap`` event."""
        slot = int(slot)
        if not 0 <= slot < self.n_slots:
            raise ValueError(
                f"slot {slot} outside portfolio [0, {self.n_slots})")
        t0 = time.perf_counter()
        n, g = self.cluster.n_padded, self.cluster.g_padded
        prog, cache = self._lower_champion(champion.code, n, g)
        overlapped = self._consume_overlap(
            self._code_key(champion.code, n, g, self.program_capacity))
        t1 = time.perf_counter()
        new_progs = list(self._slot_progs)
        new_progs[slot] = prog
        dev = self._upload_stacked(new_progs)
        t2 = time.perf_counter()
        h2d = tree_h2d_bytes(pack_portfolio_tables(new_progs))
        with self._swap_flip():  # exclude in-flight batches for the flip
            old = self._slot_champions[slot]
            self._slot_progs = new_progs
            self._slot_champions[slot] = champion
            self._prog_dev = dev
            if slot == 0:  # slot 0 is the default/reference champion
                self.champion = champion
                self.params = map_tensors(lambda x: x.to(self.device), prog)
            self._hold_program()
        self.slot_swaps[slot] += 1
        self.vm_swaps += 1
        self.vm_swap_h2d_bytes += h2d
        self.last_slot_swapped = slot
        self.last_swap_breakdown = {
            "slot": slot,
            "transpile_ms": round((t1 - t0) * 1e3, 3),
            "h2d_ms": round((t2 - t1) * 1e3, 3),
            "swap_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "h2d_bytes": h2d,
            "capacity": self.program_capacity,
            "transpile_cache": cache,
            "transpile_overlapped": overlapped,
        }
        self.recorder.event(
            "slot_swap", outcome="swapped",
            champion=champion.source or "<inline>",
            **self.last_swap_breakdown)
        return old

    def swap_program(self, champion: ChampionSpec) -> ChampionSpec:
        """The single-champion hot path maps to the default slot, so
        ``ServeService.swap_engine(ChampionSpec)`` keeps working over a
        portfolio unchanged."""
        return self.swap_slot(0, champion)

    def shadow_for(self, champion: ChampionSpec):
        """Portfolio shadows are slots, not engine copies: a copied view
        cannot carry the slot table. Stage a candidate in a spare slot
        with ``swap_slot`` instead."""
        raise TypeError(
            "PortfolioEngine stages shadows in slots: use swap_slot on a "
            "spare slot")

    # ----- graphs (slot-agnostic)

    @property
    def graph_policy(self):
        return portfolio_score

    def _graph_params(self, device, lanes: int) -> PortfolioParams:
        """The device's slot-table views and a fresh per-lane slot buffer
        (each graph owns its slots; every batch copies its own in)."""
        return PortfolioParams(
            self._graph_program(device),
            torch.zeros(lanes, dtype=torch.int64, device=device))

    def _exe_key(self, lanes: int, pod_bucket: int) -> str:
        return (f"lanes={lanes},pods={pod_bucket},"
                f"cap={self.program_capacity},slots={self.n_slots}")

    def _stage_params(self, lanes: int, idxs):
        """The chunk's per-lane slots: pad lanes repeat the last real
        lane's slot (the ``pad_population`` rule; their answers are never
        scattered back). One ``PortfolioParams`` per shard, its slots
        uploaded on the shard's serving stream."""
        chunk = ([self._batch_slots[i] for i in idxs]
                 if self._batch_slots is not None else [0] * len(idxs))
        for s in chunk:
            self.slot_requests[s] += 1
        padded = np.asarray(chunk + [chunk[-1]] * (lanes - len(chunk)),
                            np.int64)
        out = []
        for part, d in zip(self._sharding.split(padded),
                           self._sharding.devices):
            with _device_scope(d, self._streams):
                out.append(PortfolioParams(
                    self._graph_program(d),
                    torch.from_numpy(part).to(d, non_blocking=True)))
        return out

    def _sharded_serve_fn(self, graphs):
        """``serve_fn(shard, slot_tables, slots, pods, ktable, state0)``:
        the slot tables are replicated per device, the slots split with
        their lanes."""
        def serve_fn(s, tables, slots, pods, kt, state):
            return self._start_shard(graphs[s], pods, kt, state,
                                     PortfolioParams(tables, slots))

        return make_sharded_portfolio_serve_fn(
            serve_fn, self._sharding.mesh,
            finish=lambda s, _job: graphs[s].harvest())

    def _sharded_args(self, graphs, staging):
        params = [st[3] for st in staging]
        return ([p.tables for p in params], [p.slots for p in params]) + \
            tuple([st[i] for st in staging] for i in range(3))

    # ----- answering (slot threading)

    def answer_batch(self, pod_lists, slots: Optional[Sequence[int]] = None):
        """Answer a batch that may mix champions: ``slots[i]`` picks the
        resident policy for query i (default: slot 0 for every lane). The
        whole batch stays under the swap lock, so a concurrent
        ``swap_slot`` flips between batches, never inside one."""
        if slots is not None:
            slots = [int(s) for s in slots]
            if len(slots) != len(pod_lists):
                raise ValueError(
                    f"{len(slots)} slots for {len(pod_lists)} queries")
            for s in slots:
                if not 0 <= s < self.n_slots:
                    raise ValueError(
                        f"slot {s} outside portfolio [0, {self.n_slots})")
        with self.exclusive(), self._batch_scope():
            self._batch_slots = slots
            try:
                self._hold_program()
                return ServeEngine.answer_batch(self, pod_lists)
            finally:
                self._batch_slots = None

    # ----- persistence (portfolio manifest)

    def save(self, directory: str) -> str:
        """The parent artifact plus a ``portfolio`` manifest (fks_tpu's):
        the full slot table, so ``ServeEngine.load`` rebuilds the whole
        fleet."""
        path = super().save(directory)
        with open(path) as f:
            doc = json.load(f)
        doc["portfolio"] = {
            "n_slots": self.n_slots,
            "slots": [c.to_json() for c in self._slot_champions],
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def portfolio_selftest(engine: PortfolioEngine, count: int = 8,
                       pods_per_query: int = 3, tol: float = 1e-5) -> dict:
    """The portfolio parity sweep (fks_tpu's): every slot's answers
    through the shared graphs must match a single-champion
    ``VMServeEngine`` serving that champion alone (placements identical,
    scores within ``tol``), and a batch mixing slots must reproduce the
    per-slot answers lane for lane. The reference is ONE VM engine
    re-pointed per slot with ``swap_program`` at the portfolio's capacity
    bucket, so the sweep captures one reference ladder, not one per
    champion."""
    from fks_tpu_torch.serve.artifact import _pods_from_dicts

    base = engine.base_pods
    if not base:
        base = [{"cpu_milli": 1 + i, "memory_mib": 1, "creation_time": i,
                 "duration_time": 100} for i in range(pods_per_query * 2)]
    queries = []
    for i in range(count):
        start = i % max(1, len(base) - pods_per_query + 1)
        q = base[start:start + pods_per_query]
        queries.append(q if q else base[:1])
    wl = Workload(cluster=engine._cluster_host,
                  pods=_pods_from_dicts(engine.base_pods))
    ref = VMServeEngine(engine.slot_champions[0], wl,
                        envelope=engine.envelope,
                        engine=engine.engine_name,
                        prefilter_k=engine.prefilter_k,
                        state_pack=engine.state_pack,
                        max_steps_factor=engine.max_steps_factor,
                        program_capacity=engine.program_capacity,
                        mesh=engine.mesh, recorder=engine.recorder,
                        device=engine.device)
    max_drift = 0.0
    placements_ok = True
    failures: List[dict] = []
    per_slot: List[List[dict]] = []
    for k in range(engine.n_slots):
        mine = engine.answer_batch(queries, slots=[k] * len(queries))
        ref.swap_program(engine.slot_champions[k])
        solo = ref.answer_batch(queries)
        per_slot.append(mine)
        for i, (a, b) in enumerate(zip(mine, solo)):
            drift = abs(a["score"] - b["score"])
            max_drift = max(max_drift, drift)
            same = a["placements"] == b["placements"]
            placements_ok = placements_ok and same
            if drift > tol or not same:
                failures.append({"slot": k, "query": i,
                                 "drift": round(drift, 8),
                                 "placements_match": same})
    # the mixing check: one batch, every lane on its own slot, must
    # reproduce the per-slot sweeps bit for bit
    mix = [i % engine.n_slots for i in range(len(queries))]
    mixed = engine.answer_batch(queries, slots=mix)
    mixed_drift = 0.0
    for i, a in enumerate(mixed):
        b = per_slot[mix[i]][i]
        drift = abs(a["score"] - b["score"])
        mixed_drift = max(mixed_drift, drift)
        same = a["placements"] == b["placements"]
        placements_ok = placements_ok and same
        if drift > tol or not same:
            failures.append({"slot": mix[i], "query": i, "mixed": True,
                             "drift": round(drift, 8),
                             "placements_match": same})
    return {
        "ok": not failures,
        "checked": len(queries),
        "n_slots": engine.n_slots,
        "program_capacity": engine.program_capacity,
        "max_drift": round(max_drift, 10),
        "mixed_max_drift": round(mixed_drift, 10),
        "placements_match": placements_ok,
        "tol": tol,
        "failures": failures[:5],
    }
