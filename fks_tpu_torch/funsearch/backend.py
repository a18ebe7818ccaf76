"""Fitness backend for code candidates: lower -> run -> score.

Port of fks_tpu.funsearch.backend. Each unique candidate is scored against
a workload held on the evaluator's device (``cuda`` unless the caller
passes ``device="cpu"``); the trace is parsed once for the life of the
evaluator, and repeated or reformatted candidates hit a canonical-AST
cache.

Failure semantics follow the reference's subprocess path: any failure —
validation, transpile, or execution — maps to fitness 0.0 and the
candidate stays in the pool's view.

Tiers:
- VM candidates (the default): the candidate is lowered to a register
  program (``funsearch.vm``) and interpreted as data by one runner, so a
  fresh candidate is a table copied into a captured CUDA graph, not a new
  program. The graph is captured once per lane count and capacity bucket
  (``sim.engine.graph_key``). Batched (the default on CUDA, or with an
  eval budget): a generation's programs are stacked and scored in one
  launch, bucketed to a power-of-two lane count;
- transpiled candidates (the fallback, outside the VM vocabulary): one
  runner per canonical key, whose CUDA graph is its "compile"
  (``compile_count``).

On CUDA every candidate runs in the calling thread, one after another: a
CUDA graph capture (``torch.cuda.graph``) fails if another thread touches
the card meanwhile. On the CPU the transpiled tier fans out over a thread
pool as in fks_tpu. Result order is the input order either way.

The batched tier runs a generation through
``parallel.mesh.make_sharded_code_eval`` over ``mesh=`` (a
``parallel.mesh.Mesh``; without one, a one-shard mesh over the
evaluator's device): each shard interprets its chunk of the stacked
programs. On a mesh of several shards a failure there raises instead of
falling back to candidate-by-candidate scoring on one device. While a
flight recorder is on, the first launch of each (lanes, capacity) bucket
on the card lands one ``memory_footprint`` record (component
``"evolve"``): the allocator's peak across the launch that captures the
bucket's graphs, ``obs.memory.capture_footprint``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fks_tpu_torch import obs
from fks_tpu_torch.data.entities import Workload
from fks_tpu_torch.device import resolve_device
from fks_tpu_torch.funsearch import transpiler, vm
from fks_tpu_torch.sim.engine import SimConfig
from fks_tpu_torch.sim.types import SimResult, map_tensors
from fks_tpu_torch.utils.segments import validate_seg_steps

@dataclasses.dataclass
class EvalRecord:
    """One candidate's evaluation outcome."""

    code: str
    score: float
    error: Optional[str] = None  # why fitness is 0, when it is
    result: Optional[SimResult] = None  # host tensors
    # scenario-suite evaluations only: the per-scenario fitness vector the
    # composite ``score`` was folded from, and the fold that produced it
    scenario_scores: Optional[List[float]] = None
    aggregation: Optional[str] = None
    # budget-allocated evaluations (funsearch.budget): 0 = pruned at the
    # probe rung (score is the capped probe aggregate), 1 = survived to the
    # full suite; None on unbudgeted evaluations
    budget_rung: Optional[int] = None

    @property
    def ok(self) -> bool:
        return self.error is None


def _host(result: SimResult) -> SimResult:
    """One device-to-host copy of a result."""
    return map_tensors(lambda x: x.cpu(), result)


def _scores64(result: SimResult) -> np.ndarray:
    return result.policy_score.to(torch.float64).numpy()


class CodeEvaluator:
    """Evaluate candidate source strings against one workload on
    ``device`` (default ``cuda``).

    The compile cache maps canonical AST keys to runners, so a
    re-submitted (or whitespace-variant) candidate costs one run, not a
    new capture."""

    VM_CAPACITY = 512  # op budget; longer programs use the transpiled tier

    def __init__(self, workload: Workload, cfg: SimConfig = SimConfig(),
                 max_workers: Optional[int] = None, use_vm: bool = True,
                 engine: str = "exact", vm_batch: Optional[bool] = None,
                 mesh=None, suite=None, robust=None, budget=None,
                 preflight: bool = True, fp_dedup: bool = True,
                 profiler=None, device=None):
        from fks_tpu_torch.parallel.mesh import (
            _check_mesh, lead_device, num_shards, population_mesh,
        )
        from fks_tpu_torch.sim import get_engine

        # the batched tier's mesh: each shard interprets its chunk of a
        # stacked generation; the workload lives on the mesh's lead device
        self.mesh = mesh
        self._mesh = (_check_mesh(mesh) if mesh is not None
                      else population_mesh([resolve_device(device)]))
        self._n_shards = num_shards(self._mesh)
        self.device = lead_device(self._mesh)
        self.workload = workload.to(self.device)
        self.profiler = (profiler if profiler is not None
                         else obs.NULL_PROFILER)
        self.cfg = cfg
        self.engine = engine
        self._mod = get_engine(engine)
        self.suite = suite
        self.robust = robust
        self.budget = budget if (budget is not None
                                 and budget.enabled) else None
        self.last_budget_stats: List[dict] = []  # per-rung, last evaluate()
        if self.budget is not None and suite is None:
            raise ValueError(
                "budget allocation prunes between a probe suite and the "
                "full suite, so it requires suite mode; set "
                "EvolutionConfig.scenario_suite")
        if suite is not None and robust is None:
            from fks_tpu_torch.scenarios.robust import RobustConfig
            self.robust = RobustConfig()
        self.state0 = self._mod.initial_state(self.workload, cfg)
        self._cache: Dict[str, object] = {}
        self._lock = threading.Lock()
        self.compile_count = 0  # unique transpiled runners built
        self.vm_count = 0  # candidates served by the VM tier
        # static pre-flight (analysis.candidate): reject candidates the
        # transpiler provably cannot lower before anything is spent on
        # them, and collapse fingerprint duplicates within a batch
        self.preflight = preflight
        self.fp_dedup = fp_dedup
        self.preflight_rejected = 0
        self.preflight_duplicates = 0
        self.segments_dispatched = 0
        self.last_eval_stats: Dict[str, int] = {}  # most recent evaluate()
        self.max_workers = max_workers or min(8, os.cpu_count() or 1)
        self.use_vm = use_vm
        self._vm_run = None  # lazily built one-candidate VM runner
        self._vm_pop_run = None  # lazily built population VM runner
        self._budget_eval = None  # lazily built rung ladder (budget mode)
        self.vm_batch_count = 0  # batched VM launches
        self._footprinted_buckets = set()  # footprint records, once each
        # batched launches that raised, their candidates then scored one
        # by one: nonzero means the one-launch path is not engaging
        self.vm_batch_fallbacks = 0
        # Batched VM evaluation: every slot computes all 33 opcode
        # branches for every lane and selects. On the card a branch is one
        # small kernel whatever the lane count, so a generation as one
        # launch wins; on the CPU the same fan-out runs serially and loses
        # to the one-candidate tier, which runs only the live ops. An
        # enabled budget batches everywhere: its rung ladder is a batched
        # construct, and the pruning pays for the fan-out.
        if vm_batch is None:
            vm_batch = (self.device.type == "cuda" or self._n_shards > 1
                        or self.budget is not None)
        self.vm_batch = vm_batch
        # bounded device-call length for the batched tier (flat engine
        # only); 0 (the default) runs each launch to its end
        seg = os.environ.get("FKS_VM_SEG_STEPS")
        self.vm_seg_steps = (validate_seg_steps(seg, source="FKS_VM_SEG_STEPS")
                             if seg is not None else 0)
        self.vm_double_buffer = (
            os.environ.get("FKS_VM_DOUBLE_BUFFER", "1") not in ("0", ""))

    def _to_device(self, params):
        return map_tensors(lambda x: x.to(self.device), params)

    # ----- VM tier: one runner, candidates as data

    def _vm_runner(self):
        """``run(prog) -> SimResult`` of one program: a population runner
        at one lane, so on the card a capacity bucket captures its graph
        once and every later program of that bucket is copied in
        (``run.graphs``, by ``sim.engine.graph_key``)."""
        if self._vm_run is None:
            if self.suite is not None:
                from fks_tpu_torch.scenarios.robust import make_suite_eval
                self._vm_run = make_suite_eval(
                    self.suite, vm.score, self.cfg, engine=self.engine,
                    device=self.device)
            else:
                pop_run = self._mod.make_population_run_fn(
                    self.workload, vm.score,
                    dataclasses.replace(self.cfg, cond_policy=True))

                def run(prog):
                    return pop_run(map_tensors(lambda x: x[None], prog),
                                   self.state0).lane(0)

                run.graphs = pop_run.graphs
                self._vm_run = run
        return self._vm_run

    def _try_vm(self, code: str) -> Optional[SimResult]:
        """SimResult via the shared VM runner, or None when the candidate
        is outside the VM vocabulary (the caller transpiles it instead).
        The program is padded to its own capacity bucket (fks_tpu pads to
        ``VM_CAPACITY``; padding slots are NOPs, so scores are the same)."""
        c = self.workload.cluster
        try:
            prog = vm.compile_policy(code, c.n_padded, c.g_padded)
            if prog.capacity > self.VM_CAPACITY:
                raise vm.VMUnsupported(
                    f"program too long: capacity {prog.capacity}")
        except vm.VMUnsupported:
            return None
        with self._lock:
            self.vm_count += 1
        return _host(self._vm_runner()(self._to_device(prog)))

    # ----- batched VM tier: a generation as one launch

    def _count_segment(self):
        """Segment-dispatch callback of the segmented batched runner."""
        with self._lock:
            self.segments_dispatched += 1
        self.profiler.segment_tick()

    def _vm_pop_runner(self):
        """``run(stacked, real_count) -> SimResult`` of a stacked
        generation (``run.graphs``: each shard's captured chunks): in
        suite mode candidates x scenarios ``[C, T]`` from one runner on
        the evaluator's device (the segmented runner has no trace-batched
        variant; fks_tpu shards suites at the parametric tier), else the
        sharded code eval over the evaluator's mesh."""
        if self._vm_pop_run is None:
            if self.suite is not None:
                from fks_tpu_torch.scenarios.robust import make_suite_eval
                ev = make_suite_eval(self.suite, vm.score_static, self.cfg,
                                     population=True, engine=self.engine,
                                     device=self.device)

                def run(progs, _real_count):
                    return ev(progs)

                run.graphs = [ev.graphs]
            else:
                from fks_tpu_torch.parallel.mesh import (
                    make_sharded_code_eval,
                )
                ev = make_sharded_code_eval(
                    self.workload, self._mesh, cfg=self.cfg, elite_k=1,
                    engine=self.engine, seg_steps=self.vm_seg_steps,
                    on_segment=self._count_segment,
                    double_buffer=self.vm_double_buffer)

                def run(progs, real_count):
                    # the elites are dropped: the evolution loop ranks on
                    # the host
                    return ev(progs, real_count)[0]

                run.graphs = ev.graphs
            self._vm_pop_run = run
        return self._vm_pop_run

    def _sharded(self) -> bool:
        """Whether the batched tier shards over the mesh: a mesh of more
        than one shard, outside suite mode (the sharded code eval has no
        scenario axis; fks_tpu shards suites at the parametric tier)."""
        return self._n_shards > 1 and self.suite is None

    def _bucket_footprint(self, bucket: str, stacked):
        """``obs.memory.capture_footprint`` around the first launch of a
        (lanes, capacity) bucket on the card while a flight recorder is on
        (the launch that captures its graphs); otherwise a null context
        yielding an empty footprint, so nothing is recorded."""
        from fks_tpu_torch.obs.memory import capture_footprint
        from fks_tpu_torch.serve.batcher import tree_h2d_bytes

        done = self._footprinted_buckets
        if (not obs.get_recorder().enabled or self.device.type != "cuda"
                or bucket in done):
            return contextlib.nullcontext({})
        done.add(bucket)
        return capture_footprint(self.device,
                                 argument_bytes=tree_h2d_bytes(stacked))

    def _run_vm_batch(self, progs: List[vm.VMProgram]) -> List[SimResult]:
        """Evaluate stacked VM candidates in ONE launch, sharded over the
        evaluator's mesh. The capacity is the
        stack's power-of-two bucket and the lane count the next power of
        two rounded up to the shard count, padded by repeating the last
        program, so a captured graph is reused per bucket, never rebuilt
        per generation. One copy to the host per launch; the ``vm_batch``
        span closes after it."""
        pop = vm.bucket_lanes(len(progs), self._n_shards)
        padded = list(progs) + [progs[-1]] * (pop - len(progs))
        stacked = self._to_device(vm.stack_programs(padded))
        bucket = f"pop={pop},cap={int(stacked.opcode.shape[-1])}"
        with self._bucket_footprint(bucket, stacked) as fp, \
                obs.span("vm_batch", candidates=len(progs), lanes=pop,
                         shards=self._n_shards):
            result = _host(self._vm_pop_runner()(stacked, len(progs)))
        from fks_tpu_torch.obs.layout import DEFAULT_LAYOUT_KEY
        from fks_tpu_torch.obs.memory import record_footprint
        record_footprint("evolve", bucket, footprint=fp, mesh=self.mesh,
                         engine=self.engine, layout_key=DEFAULT_LAYOUT_KEY)
        with self._lock:
            self.vm_batch_count += 1
            self.vm_count += len(progs)
        return [map_tensors(lambda x, i=i: x[i], result)
                for i in range(len(progs))]

    # ----- budgeted batched tier: probe rung -> survivors -> full rung

    def _budget_ladder(self):
        """The lazily built rung ladder (funsearch.budget); its full rung
        reuses this evaluator's population suite runner."""
        if self._budget_eval is None:
            from fks_tpu_torch.funsearch.budget import BudgetedSuiteEval
            self._budget_eval = BudgetedSuiteEval(
                self.workload, self.cfg, self.budget, self.robust,
                full_runner=lambda stacked: self._vm_pop_runner()(
                    stacked, None),
                engine=self.engine, n_shards=self._n_shards,
                segment_counter=lambda: self.segments_dispatched,
                device=self.device)
        return self._budget_eval

    def _budget_active(self, n: int) -> bool:
        """Budget pruning engages only when it would actually prune."""
        return (self.budget is not None and self.suite is not None
                and n >= 2 and self.budget.survivors(n) < n)

    def _run_vm_batch_budget(self, progs: List[vm.VMProgram],
                             codes: List[str]) -> List[EvalRecord]:
        """Budgeted generation evaluation: survivors get full-suite
        records (budget_rung=1); the pruned keep their probe aggregate
        capped below the worst survivor's full score (budget_rung=0), so
        pruning can demote but never promote."""
        outcome = self._budget_ladder().run(progs)
        with self._lock:
            self.vm_batch_count += len(outcome.rungs)
            self.vm_count += len(progs)
        records: List[Optional[EvalRecord]] = [None] * len(progs)
        floor = None
        for i in outcome.survivor_indices:
            rec = self._record_suite(codes[i], outcome.results[i])
            rec.budget_rung = 1
            records[i] = rec
            floor = rec.score if floor is None else min(floor, rec.score)
        for i, pruned in enumerate(outcome.pruned):
            if pruned:
                records[i] = self._record_pruned(
                    codes[i], outcome.results[i],
                    outcome.probe_scores[i], floor or 0.0)
        self.last_budget_stats = [r.asdict() for r in outcome.rungs]
        return records

    def _record_pruned(self, code: str, result: SimResult,
                       probe_score: float, floor: float) -> EvalRecord:
        """Probe-rung record for a pruned candidate: truncation is the
        probe's design, so only an all-scenarios failure is an error; the
        score is the probe aggregate capped at the worst survivor's."""
        breakdown = [float(x) for x in _scores64(result)]
        agg = self.robust.aggregation
        if bool(result.failed.all()):
            return EvalRecord(code, 0.0, "gpu allocation aborted "
                              "(all scenarios)", result, breakdown, agg,
                              budget_rung=0)
        return EvalRecord(code, float(min(probe_score, floor)), None,
                          result, breakdown, agg, budget_rung=0)

    def _record(self, code: str, result: SimResult) -> EvalRecord:
        if self.suite is not None:
            return self._record_suite(code, result)
        if bool(result.failed):
            return EvalRecord(code, 0.0, "gpu allocation aborted", result)
        if bool(result.truncated):
            return EvalRecord(code, 0.0, "event budget exceeded", result)
        return EvalRecord(code, float(result.policy_score), None, result)

    def _record_suite(self, code: str, result: SimResult) -> EvalRecord:
        """Suite-mode record: result tensors carry the scenario axis [T].
        A failed scenario scores 0 there and drags the aggregate; the
        candidate errors out only when every scenario failed."""
        from fks_tpu_torch.scenarios.robust import aggregate

        per = _scores64(result)
        breakdown = [float(x) for x in per]
        agg = self.robust.aggregation
        failed, truncated = result.failed, result.truncated
        if bool(failed.all()):
            return EvalRecord(code, 0.0, "gpu allocation aborted "
                              "(all scenarios)", result, breakdown, agg)
        if bool((failed | truncated).all()):
            return EvalRecord(code, 0.0, "event budget exceeded "
                              "(all scenarios)", result, breakdown, agg)
        score = float(aggregate(torch.from_numpy(per), self.robust))
        return EvalRecord(code, score, None, result, breakdown, agg)

    def _compiled(self, code: str):
        """The transpiled tier's runner for ``code``: built once per
        canonical key (``compile_count``); on the card its first call
        captures the candidate's CUDA graph and later calls replay it."""
        key = transpiler.canonical_key(code)
        with self._lock:
            fn = self._cache.get(key)
        if fn is None:
            policy = transpiler.transpile(code)

            def param_policy(_p, pod, nodes):
                return policy(pod, nodes)

            if self.suite is not None:
                from fks_tpu_torch.scenarios.robust import make_suite_eval
                ev = make_suite_eval(self.suite, param_policy, self.cfg,
                                     engine=self.engine, device=self.device)

                def fn(_state0):
                    return ev(None)

                fn.graphs = ev.graphs
            else:
                # a one-lane population runner keeps its captured graph
                # (fks_tpu's jit cache); the dummy params are never read
                run = self._mod.make_population_run_fn(
                    self.workload, param_policy, self.cfg)
                dummy = torch.zeros(1, device=self.device)

                def fn(state0):
                    return run(dummy, state0).lane(0)

                fn.graphs = run.graphs
            with self._lock:
                if key in self._cache:  # lost the race: reuse the winner
                    fn = self._cache[key]
                else:
                    self._cache[key] = fn
                    self.compile_count += 1
        return fn

    def evaluate_one(self, code: str, *,
                     try_vm: Optional[bool] = None) -> EvalRecord:
        """Reference semantics: exceptions -> score 0 with the reason
        kept. ``try_vm=False`` skips the VM attempt (candidates already
        known to be outside the VM vocabulary)."""
        try:
            result: Optional[SimResult] = None
            if self.use_vm if try_vm is None else try_vm:
                result = self._try_vm(code)
            if result is None:
                result = _host(self._compiled(code)(self.state0))
            return self._record(code, result)
        except transpiler.TranspileError as e:
            return EvalRecord(code, 0.0, f"transpile: {e}")
        except Exception as e:  # noqa: BLE001 — candidate code is untrusted
            return EvalRecord(code, 0.0, f"runtime: {e}")

    def evaluate(self, codes: Sequence[str]) -> List[EvalRecord]:
        """Evaluate a batch; duplicate sources are computed once.

        VM-vocabulary candidates are lowered on the host and, when
        batching, stacked and scored in ONE launch (``_run_vm_batch``).
        The rest go one by one to the transpiled tier (over a thread pool
        on the CPU). Result order — and therefore population admission
        order — is the input order."""
        seg0 = self.segments_dispatched
        vm0 = self.vm_count
        pf_rejected = 0
        fp_dupes = 0
        works: List[int] = []  # static per-node work bounds (accepted)
        fps: Dict[str, Optional[str]] = {}  # canonical key -> fingerprint
        keyed: List[Optional[str]] = []
        errors: Dict[int, EvalRecord] = {}
        analysis = None
        unique: Dict[str, str] = {}
        alias: Dict[str, str] = {}
        with self.profiler.stage("sandbox+preflight",
                                 candidates=len(codes)) as hp:
            if self.preflight or self.fp_dedup:
                # lazy: analysis imports funsearch tables, and
                # funsearch/__init__ imports this module first
                from fks_tpu_torch import analysis
            g_padded = self.workload.cluster.g_padded
            for i, code in enumerate(codes):
                rep = None
                if analysis is not None:
                    rep = analysis.preflight_check(code)
                    if self.preflight and not rep.ok:
                        keyed.append(None)
                        errors[i] = EvalRecord(
                            code, 0.0,
                            f"preflight: {rep.taxonomy}: {rep.reason}")
                        obs.get_recorder().event(
                            "candidate_rejected", taxonomy=rep.taxonomy,
                            stage="preflight", reason=rep.reason[:200])
                        pf_rejected += 1
                        continue
                    if rep.ok and rep.cost is not None:
                        works.append(rep.cost.work(g_padded))
                try:
                    key = transpiler.canonical_key(code)
                except SyntaxError as e:
                    keyed.append(None)
                    errors[i] = EvalRecord(code, 0.0, f"syntax: {e}")
                    continue
                keyed.append(key)
                if rep is not None and key not in fps:
                    fps[key] = rep.fingerprint
            for key, code in zip(keyed, codes):
                if key is not None and key not in unique:
                    unique[key] = code

            # normalized-AST near-duplicate suppression within the batch:
            # every echo receives the representative's full EvalRecord
            if self.fp_dedup:
                by_fp: Dict[str, str] = {}
                for key in list(unique):
                    fp = fps.get(key)
                    if fp is None:
                        continue
                    owner = by_fp.setdefault(fp, key)
                    if owner != key:
                        alias[key] = owner
                        del unique[key]
                        fp_dupes += 1
                        obs.get_recorder().event(
                            "candidate_rejected",
                            taxonomy="duplicate_fingerprint",
                            stage="fp_dedup", reason=f"fingerprint {fp}")
            hp.annotate(rejected=pf_rejected, duplicates=fp_dupes,
                        unique=len(unique))

        memo: Dict[str, EvalRecord] = {}
        vm_progs: Dict[str, vm.VMProgram] = {}
        jit_only: Dict[str, str] = {}  # known outside the VM vocabulary
        general: Dict[str, str] = {}  # default tier choice (VM, then jit)
        c = self.workload.cluster
        with self.profiler.stage("transpile") as ht:
            if self.use_vm and self.vm_batch and len(unique) > 1:
                for key, code in unique.items():
                    try:
                        prog = vm.compile_policy(code, c.n_padded,
                                                 c.g_padded)
                        if prog.capacity > self.VM_CAPACITY:
                            raise vm.VMUnsupported(
                                f"program too long: capacity "
                                f"{prog.capacity}")
                        vm_progs[key] = prog
                    except vm.VMUnsupported:
                        jit_only[key] = code
                    except transpiler.TranspileError as e:
                        memo[key] = EvalRecord(code, 0.0, f"transpile: {e}")
                    except Exception as e:  # noqa: BLE001 — untrusted code
                        memo[key] = EvalRecord(code, 0.0, f"runtime: {e}")
                if len(vm_progs) == 1:  # one lane: the one-candidate tier
                    (key,) = vm_progs
                    general[key] = unique[key]
                    vm_progs = {}
            else:
                general = dict(unique)
            ht.annotate(vm_lanes=len(vm_progs),
                        jit_fallback=len(jit_only) + len(general))

        batch_served = 0
        self.last_budget_stats = []
        with self.profiler.stage("device-eval") as hd:
            if vm_progs:
                vm_keys = list(vm_progs)
                try:
                    if self._budget_active(len(vm_keys)):
                        recs = self._run_vm_batch_budget(
                            [vm_progs[k] for k in vm_keys],
                            [unique[k] for k in vm_keys])
                        for key, rec in zip(vm_keys, recs):
                            memo[key] = rec
                    else:
                        results = self._run_vm_batch(
                            [vm_progs[k] for k in vm_keys])
                        for key, res in zip(vm_keys, results):
                            memo[key] = self._record(unique[key], res)
                    batch_served = len(vm_keys)
                except Exception as e:  # noqa: BLE001 — batch failed:
                    # score them one by one, and say why the one-launch
                    # path is not engaging (``vm_batch_fallbacks``); a
                    # sharded batch never falls back to one device
                    if self._sharded():
                        raise
                    from fks_tpu_torch.utils.logging import get_logger
                    get_logger("fks_tpu_torch.funsearch.backend").warning(
                        "batched VM launch failed (%s: %s); falling back "
                        "to per-candidate evaluation", type(e).__name__, e)
                    with self._lock:
                        self.vm_batch_fallbacks += 1
                    for key in vm_keys:
                        general.setdefault(key, unique[key])

            jobs = [(key, code, False) for key, code in jit_only.items()]
            jobs += [(key, code, None) for key, code in general.items()]
            if jobs and self.device.type == "cuda":
                # one after another in this thread: a graph capture must
                # not overlap other CUDA work
                for key, code, try_vm in jobs:
                    memo[key] = self.evaluate_one(code, try_vm=try_vm)
            elif jobs:
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=self.max_workers) as ex:
                    futs = {key: ex.submit(self.evaluate_one, code,
                                           try_vm=try_vm)
                            for key, code, try_vm in jobs}
                    for key, f in futs.items():
                        memo[key] = f.result()

            if batch_served:
                from fks_tpu_torch.parallel.population import (
                    occupancy_stats,
                )
                hd.annotate(lanes=batch_served, **occupancy_stats(
                    batch_served, self._n_shards,
                    scenarios=len(self.suite) if self.suite else 1,
                    segments=max(1, self.segments_dispatched - seg0)))
            else:
                hd.annotate(lanes=len(jobs), pad_waste_fraction=0.0)

        self.preflight_rejected += pf_rejected
        self.preflight_duplicates += fp_dupes
        self.last_eval_stats = {
            "candidates": len(codes),
            "unique": len(unique),
            "syntax_failed": len(errors) - pf_rejected,
            "preflight_rejected": pf_rejected,
            "fingerprint_duplicates": fp_dupes,
            "mean_static_work": (round(sum(works) / len(works), 1)
                                 if works else 0),
            "vm_batch_lanes": batch_served,
            "fallback_lanes": len(jit_only) + len(general),
            "segments": self.segments_dispatched - seg0,
            "budget_pruned": sum(r["entered"] - r["survived"]
                                 for r in self.last_budget_stats),
            "vm_coverage": round((self.vm_count - vm0)
                                 / max(1, len(unique)), 4),
        }

        out = []
        for i, (key, code) in enumerate(zip(keyed, codes)):
            if key is None:
                out.append(errors[i])
            else:
                r = memo[alias.get(key, key)]
                out.append(EvalRecord(code, r.score, r.error, r.result,
                                      r.scenario_scores, r.aggregation,
                                      r.budget_rung))
        return out

    def scores(self, codes: Sequence[str]) -> np.ndarray:
        return np.asarray([r.score for r in self.evaluate(codes)],
                          np.float64)
