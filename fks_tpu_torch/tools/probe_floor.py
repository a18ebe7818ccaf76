"""The per-step floor of a device loop on the card, and what amortises it.

Port of fks_tpu's ``tools/probe_floor.py``, in its PyTorch meaning.
fks_tpu asks what a ``lax.while_loop`` iteration costs and whether
``lax.scan(unroll=K)`` amortises it; the port's loops are captured CUDA
graphs of ``sim.engine.SYNC_EVERY`` (16) steps, replayed with a host
check in between, so here the columns are:

  while     every step launched eagerly from the host (no graph)
  scan/uK   K steps per captured graph, the graph replayed steps/K times
            between two CUDA events (K = 1, 4, 8, 16; 16 is the
            engines' SYNC_EVERY)

  A. an almost empty body (the carry plus the step index, in place),
     carries from a scalar to [256,8192]x2, eagerly
  B. the same bodies at 1, 4, 8 and 16 steps per captured graph
  C. a composite "sweep step" shaped like the scatter-free flat engine
     body (argmin over [L,Q] + one-hot blends + small node math), lanes
     in {64, 256}, eagerly and at 4, 8 and 16 steps per graph

Lines are fks_tpu's, in us per step. With ``--cpu`` every column runs
eagerly on the host clock.

Usage: python -m fks_tpu_torch.tools.probe_floor [--steps 2048]
       [--parts abc] [--cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from fks_tpu_torch.tools.probe_ops import time_steps

INF = torch.iinfo(torch.int32).max
#: part A/B's carries, by fks_tpu's names
SHAPES = {
    "scalar": (),
    "[64,16]": ((64, 16),),
    "[64,8192]": ((64, 8192),),
    "[64,8192]x2": ((64, 8192), (64, 8192)),
    "[256,8192]x2": ((256, 8192), (256, 8192)),
}
#: steps per captured graph in part B (fks_tpu's unroll factors and 4)
UNROLLS = (1, 4, 8, 16)
#: part C's lanes and steps per graph
SWEEP_LANES = (64, 256)
SWEEP_UNROLLS = (4, 8, 16)


def _touch(i, c):
    # minimal data-dependent touch so nothing folds away
    for x in c:
        x.add_(i)


def _carry(name: str, device) -> tuple:
    shapes = SHAPES[name]
    if not shapes:
        return (torch.zeros((), dtype=torch.int32, device=device),)
    return tuple(torch.zeros(s, dtype=torch.int32, device=device)
                 for s in shapes)


def part_a_b(steps: int, device, log=print) -> Dict[str, Dict[str, float]]:
    """``{shape: {"while": us, "scan/u1": us, ...}}`` (module docstring),
    each row logged in fks_tpu's format."""
    log("== A/B: empty-ish bodies, while vs scan(unroll) ==")
    out = {}
    for name in SHAPES:
        row = {"while": time_steps(_touch, _carry(name, device), steps)}
        for u in UNROLLS:
            row[f"scan/u{u}"] = time_steps(_touch, _carry(name, device),
                                           steps, per_graph=u)
        out[name] = {k: v * 1e6 for k, v in row.items()}
        log(f"{name:14s} " + "  ".join(
            f"{k} {v:8.2f}" for k, v in out[name].items()) + "  us/step")
    return out


def make_sweep_step(lanes: int, Q: int, device, N: int = 16, G: int = 8,
                    F: int = 8):
    """``(body, init)``: a composite body shaped like the scatter-free
    engine step (fks_tpu's ``make_sweep_step``), in place on its carry
    ``(ev_t, aux, cpu, mem, gmil, hist)``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    pod_feat = torch.randint(1, 1000, (Q, 8), generator=gen,
                             dtype=torch.int32).to(device)
    w = torch.randn((lanes, F), generator=gen).to(device)
    n_iota = torch.arange(N, dtype=torch.int32, device=device)
    g_iota = torch.arange(G, dtype=torch.int32, device=device)
    q_iota = torch.arange(Q, dtype=torch.int32, device=device)
    h_iota = torch.arange(1001, dtype=torch.int32, device=device)
    bit = torch.ones((), dtype=torch.int32, device=device) << g_iota

    def body(i, c):
        ev_t, aux, cpu, mem, gmil, hist = c
        # 1. fused reduce pass: pop argmin + pending-delete min
        s = torch.argmin(ev_t, dim=-1)                          # [L]
        t = torch.gather(ev_t, 1, s[:, None])[:, 0]             # [L]
        bdel = torch.where(aux >= 0, ev_t, INF).amin(-1)
        # 2. gather pod features + aux at popped slot
        pf = torch.index_select(pod_feat, 0, s)                 # [L,8]
        aux_s = torch.gather(aux, 1, s[:, None])[:, 0]
        is_del = aux_s >= 0
        # 3. refunds: one-hot dense adds over node axes
        a = torch.where(is_del, aux_s >> 8, 0)
        bits = aux_s & 255
        oh_a = (n_iota[None, :] == a[:, None]).to(torch.int32)
        oh_a = oh_a * is_del.to(torch.int32)[:, None]
        cpu.add_(oh_a * pf[:, 0:1])
        mem.add_(oh_a * pf[:, 1:2])
        selb = (bits[:, None] >> g_iota[None, :]) & 1
        gmil.add_(oh_a[:, :, None] * (pf[:, 2:3, None] * selb[:, None, :]))
        # 4. policy: linear features over node state
        feats = torch.stack([
            cpu.float(), mem.float(), gmil.sum(-1).float(),
            (cpu - pf[:, 0:1]).float(), (mem - pf[:, 1:2]).float(),
            gmil.amax(-1).float(),
            (t[:, None] + bdel[:, None] * 0).expand_as(cpu).float(),
            pf[:, 3:4].expand_as(cpu).float(),
        ], dim=-1)                                              # [L,N,F]
        scores = torch.einsum("lnf,lf->ln", feats, w)
        wn = torch.argmax(scores, dim=-1)                       # [L]
        placed = (~is_del) & (scores.amax(-1) > 0)
        # 5. allocator: sort one gathered gpu row
        grow = torch.gather(gmil, 1, wn[:, None, None].expand(
            lanes, 1, G))[:, 0, :]                              # [L,G]
        order = torch.argsort(grow, dim=-1)
        sel = order < pf[:, 4:5] % 3
        nbits = torch.where(sel, bit[None, :], 0).sum(-1, dtype=torch.int32)
        # 6. place: one-hot dense node updates
        oh_w = (n_iota[None, :] == wn[:, None]).to(torch.int32)
        oh_w = oh_w * placed.to(torch.int32)[:, None]
        cpu.sub_(oh_w * pf[:, 0:1])
        mem.sub_(oh_w * pf[:, 1:2])
        gmil.sub_(oh_w[:, :, None] * (pf[:, 2:3, None]
                                      * sel.to(torch.int32)[:, None, :]))
        # 7. hist blend + frag reduce
        hb = torch.clamp(pf[:, 5], 0, hist.shape[-1] - 1)
        hist.add_(((h_iota[None, :] == hb[:, None])
                   & (~placed & ~is_del)[:, None]).to(torch.int32))
        mn = torch.argmax((hist > 0).to(torch.int32), dim=-1)
        frag = torch.where((gmil > 0) & (gmil < mn[:, None, None]),
                           gmil, 0).sum((1, 2), dtype=torch.int32)
        # 8. slot blend: one fused pass writing ev_t + aux
        newt = torch.where(placed, t + pf[:, 6], INF)
        newa = torch.where(placed, (wn.to(torch.int32) << 8) | nbits, -1)
        m = q_iota[None, :] == s[:, None]
        torch.where(m, newt[:, None], ev_t, out=ev_t)
        torch.where(m, newa[:, None] + (frag[:, None] & 0), aux, out=aux)

    def init():
        kt = torch.randint(1, 1 << 24, (lanes, Q), generator=gen,
                           dtype=torch.int32).to(device)
        return (kt, torch.full((lanes, Q), -1, dtype=torch.int32,
                               device=device),
                torch.full((lanes, N), 64000, dtype=torch.int32,
                           device=device),
                torch.full((lanes, N), 256000, dtype=torch.int32,
                           device=device),
                torch.full((lanes, N, G), 1000, dtype=torch.int32,
                           device=device),
                torch.zeros((lanes, 1001), dtype=torch.int32,
                            device=device))

    return body, init


def part_c(steps: int, device, log=print) -> List[Tuple[int, str, float]]:
    """``[(lanes, column, us per step)]`` of the sweep step, each row
    logged in fks_tpu's format (with its projected evals/s over the
    default trace's 32,608 steps)."""
    log("== C: composite sweep-step prototype ==")
    out = []
    for lanes in SWEEP_LANES:
        body, init = make_sweep_step(lanes, 8192, device)
        sec = time_steps(body, init(), steps)
        out.append((lanes, "while", sec * 1e6))
        log(f"lanes={lanes:4d} while    {sec * 1e6:8.2f} us/step"
            f"  -> {lanes / (sec * 32608):7.1f} evals/s proj")
        for u in SWEEP_UNROLLS:
            sec = time_steps(body, init(), steps, per_graph=u)
            out.append((lanes, f"scan/u{u}", sec * 1e6))
            log(f"lanes={lanes:4d} scan/u{u}  {sec * 1e6:8.2f}"
                f" us/step  -> {lanes / (sec * 32608):7.1f}"
                " evals/s proj")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fks_tpu_torch.tools.probe_floor",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--parts", type=str, default="abc")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (eager steps, host clock); "
                         "default: the card, raising without one")
    args = ap.parse_args(argv)
    from fks_tpu_torch.device import resolve_device
    from fks_tpu_torch.tools.profile_step import device_name

    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device_name(dev)}; steps={args.steps}",
          file=sys.stderr)

    def log(s):
        print(s, flush=True)

    if "a" in args.parts or "b" in args.parts:
        part_a_b(args.steps, dev, log)
    if "c" in args.parts:
        part_c(args.steps, dev, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
