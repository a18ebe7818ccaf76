"""Step-cost profile of the engines' event-loop body on the card.

Port of fks_tpu's ``tools/profile_step.py`` (:46-197). It times each
component of the per-event step alone — the loop's floor, heap pop and
push, the first-deletion scan, the full exact step, the flat step and
three flat variants — at the REAL default-trace shapes and several
population widths, and prints a per-step cost table:

  noop         one trivial kernel per step: the floor of a step in a
               captured graph (fks_tpu's loop overhead)
  pop+repush   ``ops.heap.heap_pop`` then ``heap_push`` of the popped item
  2pop+2push   pop, push, push a DELETE, pop
  del-scan     ``ops.heap.first_deletion_in_array_order``
  full-step    the exact engine's step (``sim.engine.build_step``) with
               the parametric best_fit policy
  flat-step    the flat step (``sim.flat.build_step``), parametric policy,
               under the bench configuration (``track_ctime=False,
               max_steps=4*pods``)
  flat-ff      the first-fit policy — the delta to flat-step is the
               parametric feature basis
  flat-ffalloc parametric policy, first-fit GPU sub-allocator — the delta
               isolates the best-fit allocator
  flat-ctime   parametric policy with the per-event pod_ctime blend on

Every variant is the port's own function, bound as a step and run as
``--steps`` steps from the same start state on every call: on the card,
replays of one captured ``sim.engine.GraphedChunk`` (16 steps per graph)
between two CUDA events, so a step's cost is device time with the
launches batched as the engines batch them; on the CPU (``--cpu``),
eager steps on the host clock. The parametric variants launch the
``param_score`` kernel (``csrc/param_score.cu``) on the card.

Timing rides on ``obs.profiler.profile_launch``: each variant's first
call (it captures the chunk) lands in a ``{name}:compile`` stage with its
capture split, the measured call in ``{name}:steady``, and ``--json``
appends one line with fks_tpu's keys, the ``device_profile`` summary
included.

Usage: python -m fks_tpu_torch.tools.profile_step [--steps 4096]
       [--lanes 1,16,256] [--json] [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: every variant, in fks_tpu's order
VARIANTS = ("noop", "pop+repush", "2pop+2push", "del-scan", "full-step",
            "flat-step", "flat-ff", "flat-ffalloc", "flat-ctime")


class StepLoop:
    """``steps`` steps of ``body`` from a fixed start state, timed on the
    state's device. Each call first copies the start state in (outside
    the clock). On the card the first call captures one
    ``sim.engine.GraphedChunk`` of ``graph_steps(body)`` steps and every
    call replays it ``steps // graph_steps`` times between two CUDA
    events; on the CPU the steps run eagerly on the host clock.
    ``seconds`` and ``steps_run`` are the last call's reading."""

    def __init__(self, body: Callable, state0, steps: int):
        from fks_tpu_torch.sim.types import map_tensors

        self.body = body
        self.state0 = state0
        self.state = map_tensors(torch.clone, state0)
        self.steps = int(steps)
        self.chunk = None
        self.seconds = 0.0
        self.steps_run = 0

    def __call__(self):
        from fks_tpu_torch.sim.engine import GraphedChunk, copy_state_
        from fks_tpu_torch.sim.types import tensor_leaves

        copy_state_(self.state, self.state0)
        if not tensor_leaves(self.state)[0].is_cuda:
            t0 = time.perf_counter()
            s = self.state
            for _ in range(self.steps):
                s = self.body(s)
            copy_state_(self.state, s)
            self.seconds = time.perf_counter() - t0
            self.steps_run = self.steps
            return self.state
        if self.chunk is None:  # the first call captures (its "compile")
            self.chunk = GraphedChunk(self.body, self.state, self.steps)
            copy_state_(self.state, self.state0)
        reps = max(1, self.steps // self.chunk.steps)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            self.chunk.replay()
        end.record()
        end.synchronize()
        self.seconds = start.elapsed_time(end) * 1e-3
        self.steps_run = reps * self.chunk.steps
        return self.state


def heap_bodies() -> Dict[str, Callable]:
    """The heap variants' bodies over one ``ops.heap.EventHeap``."""
    from fks_tpu_torch.ops.heap import (
        KIND_DELETE, first_deletion_in_array_order, heap_pop, heap_push,
    )

    def body_noop(h):
        return dataclasses.replace(h, size=h.size + 0)

    def body_pop(h):
        # re-push what was popped so the heap never drains
        pred = h.size > 0
        h2, (t, rk, kind, pod) = heap_pop(h, pred=pred)
        return heap_push(h2, t + 7, rk, kind, pod, pred=pred)

    def body_push_pop(h):
        pred = h.size > 0
        h2, (t, rk, kind, pod) = heap_pop(h, pred=pred)
        h3 = heap_push(h2, t + 7, rk, kind, pod, pred=pred)
        # the kind as a device tensor: a host constant would be copied to
        # the card inside the capture
        h4 = heap_push(h3, t + 11, rk, torch.full_like(kind, KIND_DELETE),
                       pod, pred=pred)
        h5, _ = heap_pop(h4, pred=h4.size > 0)
        return h5

    def body_scan(h):
        found, dt = first_deletion_in_array_order(h)
        # fold the result into the carry so the work is not dropped
        return dataclasses.replace(
            h, size=h.size + 0 * (found.to(torch.int32) + dt))

    return {"noop": body_noop, "pop+repush": body_pop,
            "2pop+2push": body_push_pop, "del-scan": body_scan}


def build_variants(wl, device) -> List[Tuple[str, Callable, object]]:
    """(name, step, one-lane start state) of every variant, in
    ``VARIANTS`` order, on ``wl`` (already on ``device``)."""
    from fks_tpu_torch.models import parametric, zoo
    from fks_tpu_torch.sim import engine, flat
    from fks_tpu_torch.sim.engine import SimConfig, bind_step, loop_tables

    params = parametric.seed_weights("best_fit").to(device)
    cfg = SimConfig()
    ktable, max_steps = loop_tables(wl, cfg)
    state0 = engine.initial_state(wl, cfg)
    out = [(name, body, state0.heap)
           for name, body in heap_bodies().items()]
    out.append(("full-step", bind_step(engine.build_step, wl,
                                       parametric.score, params, cfg,
                                       ktable, max_steps), state0))
    # flat variants under the bench configuration
    cfg_bench = SimConfig(max_steps=4 * wl.num_pods, track_ctime=False)
    ktable_b, max_steps_b = loop_tables(wl, cfg_bench)
    cfg_ctime = dataclasses.replace(cfg_bench, track_ctime=True)
    cfg_ffalloc = dataclasses.replace(cfg_bench, gpu_allocator="first_fit")
    fstate0 = flat.initial_state(wl, cfg_bench)
    ff = zoo.ZOO["first_fit"]()

    def param_step(c):
        return bind_step(flat.build_step, wl, parametric.score, params, c,
                         ktable_b, max_steps_b)

    out += [
        ("flat-step", param_step(cfg_bench), fstate0),
        ("flat-ff", flat.build_step(wl, ff, cfg_bench, ktable_b,
                                    max_steps_b), fstate0),
        ("flat-ffalloc", param_step(cfg_ffalloc), fstate0),
        ("flat-ctime", param_step(cfg_ctime),
         flat.initial_state(wl, cfg_ctime)),
    ]
    return out


def profile(wl, steps: int, lanes_list: Sequence[int], device,
            log=print) -> Tuple[List[Tuple[int, str, float]], object]:
    """Time every variant at every width: ``([(lanes, name, us/step)],
    profiler)``. ``wl`` is put on ``device``; each row is printed through
    ``log`` as it lands."""
    from fks_tpu_torch.obs.profiler import StageProfiler, profile_launch
    from fks_tpu_torch.sim.engine import broadcast_state

    prof = StageProfiler(scope="profile_step")
    wl = wl.to(device)
    variants = build_variants(wl, device)
    rows = []
    for lanes in lanes_list:
        for name, body, carry in variants:
            loop = StepLoop(body, broadcast_state(carry, lanes), steps)
            _, rec = profile_launch(loop, name=f"{name}@l{lanes}",
                                    profiler=prof)
            us = loop.seconds / loop.steps_run * 1e6
            rows.append((lanes, name, us))
            log(f"lanes={lanes:4d} {name:12s} {us:9.2f} us/step "
                f"({loop.seconds:.3f}s total)")
    return rows, prof


def summary_lines(rows, lanes_list) -> List[str]:
    """fks_tpu's per-step cost summary (us)."""
    out = ["", "per-step cost summary (us):"]
    for lanes in lanes_list:
        d = {n: u for (ln, n, u) in rows if ln == lanes}
        out.append(
            f"  lanes={lanes}: loop={d['noop']:.1f} "
            f"pop+push={d['pop+repush'] - d['noop']:.1f} "
            f"2pop+2push={d['2pop+2push'] - d['noop']:.1f} "
            f"del-scan={d['del-scan'] - d['noop']:.1f} "
            f"full={d['full-step']:.1f} flat={d['flat-step']:.1f} "
            f"basis={d['flat-step'] - d['flat-ff']:+.1f} "
            f"alloc={d['flat-step'] - d['flat-ffalloc']:+.1f} "
            f"ctime={d['flat-ctime'] - d['flat-step']:+.1f}")
    return out


def payload(rows, lanes_list, steps: int, device_name: str, prof) -> dict:
    """The ``--json`` line: fks_tpu's keys."""
    out = {
        "device": device_name, "steps": steps,
        "rows": [{"lanes": ln, "name": n, "us_per_step": round(u, 2)}
                 for (ln, n, u) in rows],
    }
    for lanes in lanes_list:
        d = {n: u for (ln, n, u) in rows if ln == lanes}
        out[f"lanes{lanes}"] = {
            "flat_us": round(d["flat-step"], 2),
            "basis_us": round(d["flat-step"] - d["flat-ff"], 2),
            "alloc_us": round(d["flat-step"] - d["flat-ffalloc"], 2),
            "ctime_us": round(d["flat-ctime"] - d["flat-step"], 2),
            "exact_full_us": round(d["full-step"], 2),
        }
    # the same attribution record shape as evolve --profile / cli report
    out["device_profile"] = prof.summary()
    return out


def device_name(device) -> str:
    """``platform:kind``, as fks_tpu prints a device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fks_tpu_torch.tools.profile_step",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4096)
    ap.add_argument("--lanes", type=str, default="1,16,256")
    ap.add_argument("--json", action="store_true",
                    help="append one machine-readable JSON result line")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (eager steps, host clock); "
                         "default: the card, raising without one")
    args = ap.parse_args(argv)
    from fks_tpu_torch.data import TraceParser
    from fks_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    lanes_list = [int(x) for x in args.lanes.split(",")]
    name = device_name(dev)
    print(f"device: {name}; steps={args.steps}", file=sys.stderr)
    rows, prof = profile(TraceParser().parse_workload(), args.steps,
                         lanes_list, dev,
                         log=lambda s: print(s, flush=True))
    print("\n".join(summary_lines(rows, lanes_list)))
    if args.json:
        print(json.dumps(payload(rows, lanes_list, args.steps, name, prof)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
