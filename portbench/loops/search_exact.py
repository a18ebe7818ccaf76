"""Closed-loop parametric evolution on the exact heap engine: the traffic of
researchers whose fitness must be the reference simulator's own.

The run is ``loops.search``'s (its module docstring: window, the kept
results, the lanes the reference replays), with
``ParametricEvolution(engine="exact")`` as ``tools.discover`` builds it,
and a configuration that states the exact semantics (``"semantics":
"exact"``); any other configuration or engine is refused before set-up.
Set-up captures the engine's graph (``warmup_capture``) and runs the
mix's warm-up generations, as ``loops.search`` does.

The check holds the run to ``reference.exact_sim``, the reference
simulator's event loop replayed in plain Python: the elites and the next
population as ``loops.search`` checks them, and on the replayed lanes
every integer field and every pod's node, GPUs and final creation time
(``pod_ctime``, which the retry rule rewrites) exactly, the fitness and
the utilisations by their gap. A lane of the first or the latest
generation with fewer events than pods is short unless the program ended
it ``failed`` (a GPU shortfall aborts a candidate) and the reference,
replaying it, fails it too; at most ``check_parts`` such lanes are
replayed, and the rest count as short.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from portbench import harness
from portbench.loops import inputs
from portbench.loops.search import (
    _Log, _capture, _host, _lane, _shapes, _top_k, _traced_replays, compare,
    pick_lanes,
)
from portbench.reference import exact_sim


def _refuse(cfg: dict, mix: dict) -> None:
    if cfg.get("semantics") != "exact" or mix["engine"] != "exact":
        raise ValueError(
            f"{cfg['name']} states semantics {cfg.get('semantics')!r} and "
            f"the mix runs engine {mix['engine']!r}: this loop checks the "
            "exact engine against the exact semantics only")


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device: str = "cuda", overrides: Optional[dict] = None
        ) -> dict:
    """Set up, measure, check; ``overrides`` as in ``loops.search.run``."""
    import torch
    from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
    from fks_tpu_torch.sim.engine import SimConfig

    overrides = overrides or {}
    mix = dict(mix, **overrides.get("mix", {}))
    _refuse(cfg, mix)
    dev = torch.device(device)
    max_pods = overrides.get("max_pods")
    wl = inputs.port_workload(cfg, max_pods)
    pe = ParametricEvolution(
        wl, pop_size=mix["pop"], elite_k=mix["elite_k"], noise=mix["noise"],
        cfg=SimConfig(track_ctime=False), engine=mix["engine"],
        seed=mix.get("population_seed", seed), device=dev)
    if "fault" in overrides:
        overrides["fault"](pe)
    log = _Log(pe, count_work=False)
    if mix.get("warmup_capture"):
        _capture(pe)
    pe.run(mix["warmup_generations"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = harness.process_age_s()

    log.recording = True
    t0 = harness.now()
    while True:
        pe.run(1)
        t_last = harness.now()
        if t_last >= t0 + seconds:
            break
    rec = {"setup_s": setup_s, "window_s": t_last - t0,
           "generations": len(log.gens), "pop": int(pe.real_count),
           "candidates": len(log.gens) * int(pe.real_count),
           "engine": "exact"}
    if trace:
        tl, rec["trace_replays"], rec["steps_per_replay"] = \
            _traced_replays(torch, pe, mix["trace_replays"])
        rec["timeline"] = tl.summary()
        rec["kernel_seconds"] = {
            "param_score": tl.durations("param_score_kernel")}
        rec["shapes"] = _shapes(pe, wl)
    rec["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                if dev.type == "cuda" else 0)
    pods = wl.pods.num_pods
    kept = {k: (g, _host_exact(res, pods), None if prev is None
                else _host_exact(prev, pods))
            for k, (g, res, prev) in log.results.items()}
    gens = [tuple(x.detach().cpu().numpy() for x in g) for g in log.gens]
    elite_k = pe.elite_k
    del pe, log, wl
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.update(check(cfg, mix, seed, gens, kept, elite_k, max_pods))
    return rec


def _host_exact(res, pods: int) -> dict:
    out = _host(res, pods)
    out["pod_ctime"] = res.pod_ctime.detach().cpu().numpy()[:, :pods]
    return out


def check(cfg: dict, mix: dict, seed: int, gens: list, kept: dict,
          elite_k: int, max_pods: Optional[int] = None) -> dict:
    """The comparison that decides ``correct`` (module docstring). Each
    compared number is returned beside its limit (``mix["limits"]``)."""
    _refuse(cfg, mix)
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
    short, aborted = 0, []
    for key in sorted(kept):
        g, res, _ = kept[key]
        for lane in np.flatnonzero(res["events_processed"] < pods.count):
            if res["failed"][lane]:
                aborted.append((key, int(lane)))
            else:
                short += 1
        short += int((res["policy_score"] != gens[g][2]).sum())
    lanes, repeating = pick_lanes(mix, seed, gens, kept, elite_k)
    lanes += [x for x in aborted if x not in lanes][:mix["check_parts"]]
    weights = [gens[kept[key][0]][0][lane] for key, lane in lanes]
    sim = cfg["sim"]
    t = harness.now()
    refs = exact_sim.run(cluster, pods, np.stack(weights),
                         max_steps_factor=sim["max_steps_factor"],
                         snapshot_interval=sim["snapshot_interval"])
    ref_s = harness.now() - t
    ref_of = dict(zip(lanes, refs))
    short += sum(not (x in ref_of and ref_of[x]["failed"]) for x in aborted)
    answers = [_lane(kept[key][1], lane) for key, lane in lanes]
    int_bad, gap = compare(answers, refs)
    int_bad += sum(int((np.asarray(a["pod_ctime"]) != r["pod_ctime"]).sum())
                   for a, r in zip(answers, refs))
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
            "reference_steps": max(r["steps"] for r in refs),
            "attempted": sum(len(g[2]) for g in gens), "failed": 0}
