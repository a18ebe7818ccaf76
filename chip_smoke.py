#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fks_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build ``fks_tpu_torch/csrc/fused_sim.cu`` for sm_90a and print the
   ``-Xptxas -v`` report (registers, shared memory, spills); spills fail;
3. hold the kernel against its plain PyTorch version on the card, on the
   same inputs: integer outputs exact, float outputs within 2e-6
   (rtol and atol), on the roomy and contended workloads of fks_tpu's
   tests/test_fused.py, the tied workload (equal times across queue
   chunks, retries onto held times), the multigpu50 and cpu250 OpenB
   traces at pop 8 cut to 2,000 steps (multi-GPU picks, retry storms,
   chunk counts that are not a multiple of 32) and the full default OpenB
   trace at pop 8;
4. the main path: ``make_population_eval(engine="fused")`` on the full
   default trace (16 nodes x 8,152 pods) at pop 256 — the seeds plus
   jitter, with the 0.5365 champion's weights in one lane — timed, its
   launch count read, the lane-step distribution (``acci[:, 1]``) and the
   kernel time per step of the longest lane reported, and the kernel's raw
   outputs held against the plain version at the same inputs;
5. ``ParametricEvolution`` for 3 generations at pop 256 on the fused
   engine: the best score must not decrease;
6. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the fks_tpu package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHAMPION = (ROOT / "policies" / "discovered"
            / "funsearch_20260801_045536_score0.5365.json")
TOL = 2e-6
POP = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SMEM_BYTES_PER_CLOCK_PER_SM = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def compare_raw(name, got, want):
    """Max abs error of the kernel's raw outputs against the plain
    version's; raises unless ints are exact and floats within TOL."""
    import torch

    labels = ("aux", "cpu", "mem", "gpu", "gmil", "acci", "accf")
    worst = 0.0
    for label, a, b in zip(labels, got, want):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {label} shape {tuple(a.shape)} "
                                 f"!= plain {tuple(b.shape)}")
        if a.dtype == torch.float32:
            err = (a - b).abs()
            bad = err > TOL + TOL * b.abs()
        else:
            err = (a.to(torch.int64) - b.to(torch.int64)).abs().to(
                torch.float64)
            bad = err > 0
        if bool(bad.any()):
            idx = bad.nonzero()[0].tolist()
            raise AssertionError(
                f"{name}: {label} differs from the plain version at {idx}: "
                f"kernel {a[tuple(idx)].item()} plain {b[tuple(idx)].item()}"
                f" ({int(bad.sum())} entries)")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not (ROOT / "fks_tpu_torch" / "csrc" / "fused_sim.cu").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout that holds "
                         "fks_tpu_torch/")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fks_tpu_torch.convert import load_champion_weights
    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.funsearch.device_evolution import ParametricEvolution
    from fks_tpu_torch.models import parametric
    from fks_tpu_torch.ops import _ext
    from fks_tpu_torch.parallel import make_population_eval
    from fks_tpu_torch.sim import fused
    from fks_tpu_torch.sim.engine import SimConfig
    from fks_tpu_torch.testing import (
        contended_workload, roomy_workload, tied_workload,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. the card
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[card] nvidia-smi: {card}")
    log(f"[card] torch: {kind}, {props.multi_processor_count} SMs, "
        f"max SM clock {max_clock_mhz} MHz, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    so = _ext.build("fused_sim")
    _ext.fused_sim_library()
    log(f"[build] {so.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in _ext.ptxas_report("fused_sim").splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                raise AssertionError(f"the kernel spills registers: {line}")

    # ---- 3. kernel vs plain version on the card
    def check(name, wl, cfg, params):
        plan = fused.make_fused_population_run(wl, cfg, device=dev).plan
        got = fused.fused_sim(plan, params)
        torch.cuda.synchronize()
        want = fused.fused_sim_plain(plan, params)
        err = compare_raw(name, got, want)
        steps = int(got[5][:, 1].sum())
        log(f"[check] {name}: pop {params.shape[0]}, {steps} lane-steps, "
            f"ints exact, max abs err {err:.3g} (tol {TOL}) ok")
        return err

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    max_err = 0.0
    max_err = max(max_err, check(
        "roomy", roomy_workload(), SimConfig(track_ctime=False),
        parametric.init_population(gen, 8, noise=0.2)))
    max_err = max(max_err, check(
        "contended", contended_workload(),
        SimConfig(track_ctime=False, max_steps=4 * 96),
        parametric.init_population(gen, 8, noise=0.5)))
    max_err = max(max_err, check(
        "tied", tied_workload(), SimConfig(track_ctime=False),
        parametric.init_population(gen, 8, noise=0.5)))
    parser = TraceParser()
    for pod_file in ("openb_pod_list_multigpu50.csv",
                     "openb_pod_list_cpu250.csv"):
        t0 = time.perf_counter()
        max_err = max(max_err, check(
            pod_file, parser.parse_workload(pod_file=pod_file).to(dev),
            SimConfig(track_ctime=False, max_steps=2000),
            parametric.init_population(gen, 8)))
        log(f"[check] {pod_file} pop 8 took {time.perf_counter() - t0:.1f} s")
    wl = parser.parse_workload().to(dev)
    cfg = SimConfig(track_ctime=False)
    t0 = time.perf_counter()
    max_err = max(max_err, check(
        "default-trace", wl, cfg, parametric.init_population(gen, 8)))
    log(f"[check] default-trace pop 8 took {time.perf_counter() - t0:.1f} s")

    # ---- 4. the main path at pop 256
    gen.manual_seed(1)
    params = parametric.init_population(gen, POP)
    params[4] = load_champion_weights(CHAMPION, device=dev)
    evaluate = make_population_eval(wl, cfg=cfg, engine="fused", device=dev)
    res = evaluate(params)  # warm-up
    torch.cuda.synchronize()
    fused.fused_sim.launches = 0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        res = evaluate(params)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = fused.fused_sim.launches
    if launches == 0:
        raise AssertionError("the main path never launched the fused kernel")
    scores = res.policy_score
    if scores.shape != (POP,) or not bool(torch.isfinite(scores).all()) \
            or not bool(((scores >= 0) & (scores <= 1)).all()):
        raise AssertionError(f"bad policy scores: {scores}")
    events = int(res.events_processed.sum())
    log(f"[main] pop {POP} default trace (16 nodes x 8152 pods): "
        f"{wall:.4f} s/eval, {POP / wall:.1f} evals/s, {events} events, "
        f"best {float(scores.max()):.6f}, mean {float(scores.mean()):.6f}, "
        f"champion lane {float(scores[4]):.6f}, "
        f"launches {launches} ({reps} evals), card {card}")

    plan = evaluate.plan
    kernel_ms = cuda_ms(lambda: fused.fused_sim(plan, params), 3)
    fused.fused_sim.launches = 0  # timing launches are not main-path ones
    got = fused.fused_sim(plan, params)
    fused.fused_sim.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fused.fused_sim_plain(plan, params)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_err = max(max_err, compare_raw("main-path pop 256", got, want))
    steps = got[5][:, 1]
    lane_steps = int(steps.sum())
    max_lane_steps = int(steps.max())
    mean_lane_steps = float(steps.double().mean())
    ns_per_critical_step = kernel_ms * 1e6 / max_lane_steps
    log(f"[main] kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{lane_steps} lane-steps (per lane max {max_lane_steps}, mean "
        f"{mean_lane_steps:.1f}), {ns_per_critical_step:.1f} ns per step "
        f"of the longest lane, kernel == plain ok")

    # bound: the shared-memory words the kernel moves on every event — its
    # 32 threads read 3 x run chunk minima (run = chunks per thread) and
    # write the slot's ev and aux and the chunk's two minima — and on every
    # CREATE the five words per node of the fit test; GPU rows of GPU pods,
    # the float scores of feasible nodes, histogram and bookkeeping words
    # are left out, so this is a floor. CREATEs are placements (aux >= 0)
    # plus failed placements (frag_count) plus aborted allocations.
    # Device-memory bytes are read/written once.
    run = -(-(plan.q // 32) // 32)
    creates = int((got[0] >= 0).sum() + got[5][:, 4].sum()
                  + got[5][:, 6].sum())
    smem_words = lane_steps * (3 * run + 4) + creates * 5 * plan.n
    sm_bytes_per_s = (props.multi_processor_count
                      * SMEM_BYTES_PER_CLOCK_PER_SM * max_clock_mhz * 1e6)
    smem_bound_ms = smem_words * 4 / sm_bytes_per_s * 1e3
    io_bytes = (params.numel() * 4 + plan.ev0.numel() * 4
                + plan.feat.numel() * 4 + sum(o.numel() * 4 for o in got))
    hbm_bound_ms = io_bytes / HBM_BYTES_PER_S * 1e3

    # ---- 5. evolution
    fused.fused_sim.launches = 0
    t0 = time.perf_counter()
    pe = ParametricEvolution(wl, pop_size=POP, cfg=cfg, engine="fused",
                             device=dev, seed=0)
    pe.run(3)
    torch.cuda.synchronize()
    bests = [h.best_score for h in pe.history]
    if any(b < a for a, b in zip(bests, bests[1:])) or len(bests) != 3:
        raise AssertionError(f"evolution best score decreased: {bests}")
    log(f"[evolve] 3 generations pop {POP}: best {bests}, mean "
        f"{[round(h.mean_score, 6) for h in pe.history]}, "
        f"{time.perf_counter() - t0:.2f} s, launches "
        f"{fused.fused_sim.launches}")

    # ---- 6. summary
    log(f"[card] {card}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_sim", "route": "cuda",
        "source": "fks_tpu_torch/csrc/fused_sim.cu",
        "replaces": "fks_tpu/sim/fused.py:471",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(smem_bound_ms, hbm_bound_ms),
        "bound_by": "bytes", "library_ms": None,
        "bound_note": "floor of shared-memory bytes: per lane-step "
                      "(3 x run + 4) words (chunk minima read, slot and "
                      "chunk minima written), per CREATE 5 x N node words, "
                      "over SMs x 128 B/clock x max SM clock; the kernel is "
                      "latency-bound on its longest lane "
                      "(ns_per_critical_step)",
        "smem_bound_ms": smem_bound_ms, "hbm_bound_ms": hbm_bound_ms,
        "smem_bytes_per_lane_step": 4 * (3 * run + 4),
        "creates": creates, "lane_steps": lane_steps,
        "max_lane_steps": max_lane_steps,
        "mean_lane_steps": mean_lane_steps,
        "ns_per_critical_step": ns_per_critical_step,
        "pop": POP, "check": "ok",
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
