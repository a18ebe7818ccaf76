"""Primitive cost model for the per-event step on the card.

Port of fks_tpu's ``tools/probe_ops.py``, in its PyTorch meaning. Each of
fks_tpu's building blocks (under its name) runs ``--steps`` steps as ONE
captured CUDA graph, timed between two CUDA events after a warm replay,
at several lane (population) widths. The step counter is a device
scalar the graph advances, so every step reads its own index as
fks_tpu's ``while_loop`` body does; the carry is updated in place:

  dense16     predicated dense update of a [L,16] i32 row (no scatter)
  dense-grid  predicated dense update of a [L,16,8] grid
  scat1-8k    batched 1-element scatter into [L,8192] (``scatter_``)
  scat15-8k   batched 15-element scatter into [L,8192] (heap-sift shape)
  scat15u-8k  the same indices (unique per row) written through
              ``index_put_``: PyTorch has no unique-indices hint, so this
              is the other write path, advanced indexing
  gath15-8k   batched 15-element gather from [L,8192]
  chain14     14 DEPENDENT rounds of 2-wide gathers (the heap pop
              descent's critical path shape)
  argmin256   masked argmin over a [L,256] ring buffer
  tape-read   indexed row read from a static [40k, 8] tape
  dense-8k    full dense blend of [L,8192] (scatter-free waiting-set upd)

With ``--cpu`` the steps run eagerly on the host clock. The card's
numbers are in PERF.md (chip_smoke.py phase 17).

Usage: python -m fks_tpu_torch.tools.probe_ops [--steps 2048]
       [--lanes 16,256,1024] [--cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

#: fks_tpu's bodies, in its order
NAMES = ("dense16", "dense-grid", "scat1-8k", "scat15-8k", "scat15u-8k",
         "gath15-8k", "chain14", "argmin256", "tape-read", "dense-8k")
P = 8192
TAPE_ROWS = 40000


def time_steps(body: Callable, carry: Tuple[torch.Tensor, ...], steps: int,
               per_graph: Optional[int] = None) -> float:
    """Seconds per step of ``body(i, carry)`` (which updates ``carry`` in
    place; ``i`` is the step index, a device int32 scalar advanced after
    every step). On the card, ``per_graph`` steps are captured in one CUDA
    graph (after one eager warm-up chunk, on a side stream, as
    ``sim.engine.GraphedChunk`` does) and the graph is replayed
    ``steps // per_graph`` times between two CUDA events after a warm
    replay; ``per_graph=None`` launches every step eagerly between the
    events instead. On the CPU the steps run eagerly on the host clock."""
    from fks_tpu_torch.sim.engine import capture

    dev = carry[0].device
    i = torch.zeros((), dtype=torch.int32, device=dev)

    def run(n):
        for _ in range(n):
            body(i, carry)
            i.add_(1)

    if dev.type != "cuda":
        t0 = time.perf_counter()
        run(steps)
        return (time.perf_counter() - t0) / steps
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if per_graph is None:
            run(1)  # warm-up: first-use allocations and library handles
            torch.cuda.synchronize(dev)
            start.record()
            run(steps)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3 / steps
        k = max(1, min(int(per_graph), steps))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run(k)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture(graph, side, "probe"):
            run(k)
        graph.replay()  # the first replay uploads the graph
        torch.cuda.synchronize(dev)
        reps = max(1, steps // k)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / (reps * k)


def make_body(name: str, lanes: int, device) -> Tuple[Callable, tuple]:
    """``(body, carry)`` of one of ``NAMES`` at ``lanes`` lanes."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    idx1 = torch.randint(0, P, (lanes,), generator=gen).to(device)
    idx15 = torch.stack([torch.randperm(P, generator=gen)[:15]
                         for _ in range(lanes)]).to(device)
    lane = torch.arange(lanes, device=device, dtype=torch.int32)
    rows = torch.arange(lanes, device=device)[:, None].expand(lanes, 15)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    if name == "dense16":
        iota = torch.arange(16, device=device, dtype=torch.int32)

        def body(i, c):
            b = (i + lane) % 16
            c[0].add_(torch.where(iota[None, :] == b[:, None], i, 0))
        return body, (zeros(lanes, 16),)
    if name == "dense-grid":
        iota = torch.arange(16, device=device, dtype=torch.int32)

        def body(i, c):
            b = (i + lane) % 16
            oh = iota[None, :] == b[:, None]
            c[0].add_(torch.where(oh[:, :, None], i, 0))
        return body, (zeros(lanes, 16, 8),)
    if name == "scat1-8k":
        def body(i, c):
            ix = (idx1 + i) % P
            c[0].scatter_(1, ix[:, None], (i + lane)[:, None])
        return body, (zeros(lanes, P),)
    if name in ("scat15-8k", "scat15u-8k"):
        unique = name == "scat15u-8k"

        def body(i, c):
            ix = (idx15 + i) % P
            vals = (i + ix).to(torch.int32)
            if unique:
                c[0].index_put_((rows, ix), vals)
            else:
                c[0].scatter_(1, ix, vals)
        return body, (zeros(lanes, P),)
    if name == "gath15-8k":
        def body(i, c):
            ix = (idx15 + i) % P
            g = torch.gather(c[0], 1, ix)
            c[0].add_(g.sum(1, keepdim=True, dtype=torch.int32) * 0 + 1)
        return body, (zeros(lanes, P),)
    if name == "chain14":
        def body(i, c):
            pos = torch.zeros(lanes, dtype=torch.int64, device=device) \
                + (i % 7)
            acc = torch.zeros(lanes, dtype=torch.int32, device=device)
            for _ in range(14):
                p = torch.clamp(2 * pos + 1, 0, P - 2)
                pair = torch.gather(c[0], 1, torch.stack([p, p + 1], 1))
                use_r = pair[:, 1] < pair[:, 0]
                pos = torch.clamp(2 * pos + 1 + use_r, 0, P - 1)
                acc = acc + pair[:, 0]
            c[0][:, 0].copy_(acc)
        return body, (zeros(lanes, P),)
    if name == "argmin256":
        def body(i, c):
            m = torch.argmin(c[0] + i % 3, dim=1)
            c[0].scatter_(1, m[:, None], (i + lane)[:, None])
        return body, (zeros(lanes, 256),)
    if name == "tape-read":
        tape = torch.arange(TAPE_ROWS * 8, dtype=torch.int32,
                            device=device).reshape(TAPE_ROWS, 8)

        def body(i, c):
            r = torch.index_select(
                tape, 0, torch.clamp(i, max=TAPE_ROWS - 1).reshape(1))
            c[0][:, :8].add_(r)
        return body, (zeros(lanes, 16),)
    if name == "dense-8k":
        iota = torch.arange(P, device=device)

        def body(i, c):
            ix = (idx1 + i) % P
            oh = iota[None, :] == ix[:, None]
            torch.where(oh, c[0] + i, c[0], out=c[0])
        return body, (zeros(lanes, P),)
    raise ValueError(name)


def probe(lanes_list: Sequence[int], steps: int, device,
          log=print) -> List[Tuple[int, str, float]]:
    """``[(lanes, name, us per step)]`` of every body at every width,
    ``steps`` steps in one captured graph; each row goes through ``log``
    in fks_tpu's format as it lands."""
    rows = []
    for lanes in lanes_list:
        for name in NAMES:
            body, carry = make_body(name, lanes, device)
            us = time_steps(body, carry, steps, per_graph=steps) * 1e6
            rows.append((lanes, name, us))
            log(f"lanes={lanes:5d} {name:11s} {us:9.2f} us/step")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fks_tpu_torch.tools.probe_ops",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--lanes", type=str, default="16,256,1024")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (eager steps, host clock); "
                         "default: the card, raising without one")
    args = ap.parse_args(argv)
    from fks_tpu_torch.device import resolve_device
    from fks_tpu_torch.tools.profile_step import device_name

    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device_name(dev)}; steps={args.steps}",
          file=sys.stderr)
    probe([int(x) for x in args.lanes.split(",")], args.steps, dev,
          log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
