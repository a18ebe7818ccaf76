"""Closed-loop parametric evolution: the traffic of researchers who search
for a scheduling policy and pay for candidate evaluations per second.

The mix (``traffic/<mix>.json``) gives the engine, the population, the
elite count and the mutation noise of ``ParametricEvolution``, run with
``SimConfig(track_ctime=False)`` as ``tools.discover`` runs it, on the
configuration's whole trace. The initial population is drawn from the
run's seed; a mix with a ``population_seed`` draws it, and the search's
mutations, from that fixed seed instead, so every seed offers the same
work and the run's seed draws only the candidates that are checked. (A
reordered population is not the same work: candidates that place every
pod alike tie, the stable top-k keeps the first of them, and their
offspring differ.)

Set-up builds the search, builds the kernels and captures the graphs:
it runs ``warmup_generations`` generations, or with ``warmup_capture``
only captures the engine's graph (a generation of the flat engine on the
large park takes seconds), and hands the same object to the
window. The window runs whole generations through the
program's own loop (``ParametricEvolution.run``) until ``--seconds`` have
passed; a generation that started before then runs to its end, and the
window ends at the last one's end.

After the window the run is checked (``check``): every generation's
elites against the stable top-k of its scores, the next population's
leading rows and its mutated rows, every kept lane's event count, and
candidates replayed by the plain reference (``reference.flat_sim``) and
compared field by field: in the first and the latest generation one
drawn from the seed in each part of the population, and some of the
lanes whose whole result repeats the previous generation's in that lane
(``pick_lanes``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from portbench import harness
from portbench.loops import inputs
from portbench.reference import flat_sim

#: SimResult fields the comparison reads
INT_FIELDS = ("num_snapshots", "num_fragmentation_events", "events_processed",
              "scheduled_pods", "max_nodes", "failed", "truncated")
FLOAT_FIELDS = ("policy_score", "avg_cpu_utilization",
                "avg_memory_utilization", "avg_gpu_count_utilization",
                "avg_gpu_memory_utilization", "gpu_fragmentation_score")
POD_FIELDS = ("assigned_node", "assigned_gpus")


class _Log:
    """What the window's generations produced, kept by reference (no copy
    and no device work inside the window): every generation's input
    population, new population, scores and elite scores, and the whole
    ``SimResult`` of the first and of the latest generation, each with
    the ``SimResult`` of the generation before it (for the first, the
    last warm-up generation's, where set-up ran one)."""

    def __init__(self, pe, count_work: bool):
        import torch

        self.gens: List[tuple] = []
        self.results = {}
        self.work: List = []  # per generation: scored events, on device
        self.count_work = count_work
        self.recording = False
        pop = pe.eval
        cls = type(pop)

        class Recording(cls):  # keeps the eval's whole result
            def __call__(self, params):
                res = super().__call__(params)
                self.last_result = res
                return res

        pop.__class__ = Recording
        step = pe.step
        before = [None]  # the previous generation's result

        def recorded_step():
            params_in = pe.params
            new, scores, elite = step()
            res = pop.last_result
            if self.recording:
                self.gens.append((params_in, new, scores, elite))
                key = "first" if len(self.gens) == 1 else "last"
                self.results[key] = (len(self.gens) - 1, res, before[0])
                if self.count_work:
                    self.work.append(
                        (res.events_processed - res.scheduled_pods).sum(
                            dtype=torch.int64))
            before[0] = res
            return new, scores, elite

        pe.step = recorded_step


def _capture(pe) -> None:
    """Build each shard's captured graph without running a generation:
    start the population's lanes (the runner captures its graph there),
    finalize the started state and drop it. The window's first
    generation copies its own population and state into the graph."""
    from fks_tpu_torch.parallel.mesh import shard_population

    pop = pe.eval
    for run, part, s0 in zip(pop.runners, shard_population(
            pe.params, pop.mesh), pop.state0):
        run.finish(run.start(part, s0))


def _traced_replays(torch, pe, replays: int):
    """A trace of the engine's own loop over at most ``replays`` graph
    replays of the current population (the host's flag read, then one
    replay, as ``sim.engine.drain`` runs them), for a cell whose steps
    launch too many kernels to trace a whole window. Returns (the
    timeline, the replays run, steps per replay)."""
    from fks_tpu_torch.parallel.mesh import shard_population
    from fks_tpu_torch.sim.engine import SYNC_EVERY

    pop = pe.eval
    run = pop.runners[0]
    job = run.start(shard_population(pe.params, pop.mesh)[0], pop.state0[0])
    ran = 0
    with harness.profile() as prof:
        t0 = harness.now()
        while ran < replays and job.read(job.active()):
            job.advance()
            ran += 1
        if pe.device.type == "cuda":
            torch.cuda.synchronize(pe.device)
        window_s = harness.now() - t0
    steps = job.chunk.steps if job.chunk is not None else SYNC_EVERY
    return harness.Timeline(prof, window_s), ran, steps


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device: str = "cuda", overrides: Optional[dict] = None
        ) -> dict:
    """Set up, measure, check. ``overrides`` (tests only) may cut the
    trace to its first pods (``max_pods``), change the mix (``mix``) and
    plant a fault in the program's pieces (``fault``, called with the
    search object before anything is recorded)."""
    import torch
    from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
    from fks_tpu_torch.sim.engine import SimConfig

    overrides = overrides or {}
    mix = dict(mix, **overrides.get("mix", {}))
    dev = torch.device(device)
    max_pods = overrides.get("max_pods")
    wl = inputs.port_workload(cfg, max_pods)
    pe = ParametricEvolution(
        wl, pop_size=mix["pop"], elite_k=mix["elite_k"], noise=mix["noise"],
        cfg=SimConfig(track_ctime=False), engine=mix["engine"],
        seed=mix.get("population_seed", seed), device=dev)
    if "fault" in overrides:
        overrides["fault"](pe)
    log = _Log(pe, count_work=trace)
    if mix.get("warmup_capture"):
        _capture(pe)
    pe.run(mix["warmup_generations"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = harness.process_age_s()

    log.recording = True

    def window():
        t0 = harness.now()
        while True:
            pe.run(1)
            t_last = harness.now()
            if t_last >= t0 + seconds:
                return t_last - t0

    tl = None
    if trace and "trace_replays" not in mix:
        with harness.profile() as prof:
            window_s = window()
        tl = harness.Timeline(prof, window_s)
    else:
        window_s = window()
    rec = {"setup_s": setup_s, "window_s": window_s,
           "generations": len(log.gens), "pop": int(pe.real_count),
           "candidates": len(log.gens) * int(pe.real_count),
           "engine": mix["engine"]}
    if trace:
        if tl is None:
            tl, rec["trace_replays"], rec["steps_per_replay"] = \
                _traced_replays(torch, pe, mix["trace_replays"])
        rec["trace_whole_window"] = "trace_replays" not in rec
        rec["timeline"] = tl.summary()
        rec["kernel_seconds"] = {
            "fused_sim": tl.durations("fused_sim_kernel"),
            "param_score": tl.durations("param_score_kernel")}
        rec["shapes"] = _shapes(pe, wl)
        rec["scored_events"] = [int(x) for x in log.work]
    if dev.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    else:
        rec["memory_peak_bytes"] = 0
    pods = wl.pods.num_pods
    kept = {k: (g, _host(res, pods), None if prev is None
                else _host(prev, pods))
            for k, (g, res, prev) in log.results.items()}
    gens = [tuple(x.detach().cpu().numpy() for x in g) for g in log.gens]
    elite_k = pe.elite_k
    del pe, log, wl
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.update(check(cfg, mix, seed, gens, kept, elite_k, max_pods))
    return rec


def _host(res, pods: int) -> dict:
    out = {k: getattr(res, k).detach().cpu().numpy()
           for k in INT_FIELDS + FLOAT_FIELDS}
    for k in POD_FIELDS:
        out[k] = getattr(res, k).detach().cpu().numpy()[:, :pods]
    return out


def _shapes(pe, wl) -> dict:
    c = wl.cluster
    out = {"pop": int(pe.params.shape[0]), "n": int(c.n_padded),
           "g": int(c.g_padded), "q": int(wl.pods.p_padded)}
    for run in getattr(pe.eval, "runners", []):
        plan = getattr(run, "plan", None)
        if plan is not None:
            out.update(q=plan.q, klen=plan.klen)
    return out


def _lane(res: dict, lane: int) -> dict:
    return {k: v[lane] for k, v in res.items()}


def compare(answers: list, refs: list) -> tuple:
    """(integer values that differ, widest float gap) between answers and
    the reference's results, lane by lane: every integer field and every
    pod's node and GPUs exactly, the fitness and the utilisations by
    their gap."""
    int_bad, gap = 0, 0.0
    for got, ref in zip(answers, refs):
        for k in INT_FIELDS:
            int_bad += int(int(got[k]) != int(ref[k]))
        for k in POD_FIELDS:
            int_bad += int((np.asarray(got[k]) != ref[k]).sum())
        for k in FLOAT_FIELDS:
            gap = max(gap, abs(float(got[k]) - float(ref[k])))
    return int_bad, gap


def _top_k(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k best scores, ties to the lower index."""
    return np.argsort(-scores, kind="stable")[:k]


def repeats(res: dict, prev: Optional[dict], elite_k: int) -> List[int]:
    """Lanes past the elites whose whole result equals the previous
    generation's result in the same lane: what a lane left unevaluated,
    with its buffers still holding the last generation's answer, shows.
    Two different candidates can place every pod alike, so such a lane
    is replayed by the reference rather than counted as wrong."""
    if prev is None:
        return []
    same = np.ones(len(res["policy_score"]), bool)
    for k, v in res.items():
        eq = np.asarray(v) == np.asarray(prev[k])
        same &= eq.reshape(len(same), -1).all(axis=1)
    return [int(i) for i in np.flatnonzero(same) if i >= elite_k]


def pick_lanes(mix: dict, seed: int, gens: list, kept: dict,
               elite_k: int) -> tuple:
    """The lanes the reference replays, as (kept generation, lane): in
    each kept generation one lane from each of ``check_parts`` equal parts
    of the population, drawn from the seed, with the first generation's
    best candidate standing for its part; then up to ``check_repeats``
    of the lanes that repeat their previous result (``repeats``), drawn
    from the seed. Also returns the count of repeating lanes."""
    rng = np.random.default_rng(seed)
    lanes = []
    for key in sorted(kept):
        g = kept[key][0]
        scores = gens[g][2]
        best = int(_top_k(scores, 1)[0]) if key == min(kept) else None
        for part in np.array_split(np.arange(len(scores)),
                                   mix["check_parts"]):
            if best is not None and best in part:
                lanes.append((key, best))
            elif len(part):
                lanes.append((key, int(rng.choice(part))))
    rep = [(key, lane) for key in sorted(kept)
           for lane in repeats(kept[key][1], kept[key][2], elite_k)]
    extra = [x for x in rep if x not in lanes]
    if extra:
        for i in rng.choice(len(extra), size=min(mix["check_repeats"],
                                                 len(extra)), replace=False):
            lanes.append(extra[int(i)])
    return lanes, len(rep)


def check(cfg: dict, mix: dict, seed: int, gens: list, kept: dict,
          elite_k: int, max_pods: Optional[int] = None) -> dict:
    """The comparison that decides ``correct`` (module docstring). Each
    compared number is returned beside its limit (``mix["limits"]``)."""
    limits = mix["limits"]
    elites_wrong = stale = 0
    for j, (params_in, new, scores, elite) in enumerate(gens):
        idx = _top_k(scores, elite_k)
        ok = (np.array_equal(elite, scores[idx])
              and np.array_equal(new[:elite_k], params_in[idx]))
        if j + 1 < len(gens):
            ok = ok and np.array_equal(gens[j + 1][0], new)
        elites_wrong += int(not ok)
        stale += int((new[elite_k:] == params_in[elite_k:]).all(axis=1).sum())
    cluster, pods, _ = inputs.reference_inputs(cfg, max_pods)
    short = 0
    for key in sorted(kept):
        g, res, _ = kept[key]
        scores = gens[g][2]
        short += int((res["events_processed"] < pods.count).sum())
        short += int((res["policy_score"] != scores).sum())
    lanes, repeating = pick_lanes(mix, seed, gens, kept, elite_k)
    weights = [gens[kept[key][0]][0][lane] for key, lane in lanes]
    t = harness.now()
    refs = flat_sim.run(cluster, pods, np.stack(weights),
                        max_steps_factor=cfg["sim"]["max_steps_factor"],
                        snapshot_interval=cfg["sim"]["snapshot_interval"])
    ref_s = harness.now() - t
    int_bad, gap = compare([_lane(kept[key][1], lane) for key, lane in lanes],
                           refs)
    checks = [["elites_wrong", elites_wrong, limits["elites_wrong"]],
              ["stale_rows", stale, limits["stale_rows"]],
              ["short_lanes", short, limits["short_lanes"]],
              ["int_mismatch", int_bad, limits["int_mismatch"]],
              ["fitness_gap", gap, limits["fitness_gap"]]]
    return {"checks": checks, "correct": all(v <= lim for _, v, lim in checks),
            "checked_lanes": [[k, lane] for k, lane in lanes],
            "repeating_lanes": repeating,
            "checked_weights": weights, "reference_results": refs,
            "reference_s": ref_s,
            "reference_steps": max(r["events_processed"] for r in refs),
            "attempted": sum(len(g[2]) for g in gens), "failed": 0}
