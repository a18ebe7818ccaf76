"""What every cell shares: finding its files by name, the process clock,
the profiler's timeline, the metric readers and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
``configs/<config>.json`` and ``traffic/<mix>.json`` are data; the mix
names the loop (``loops/<loop>.py``) that reads it, and each metric
is read by ``metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files and entries and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
DATA = BENCH / "data"
#: top-level module names the measured process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "fks_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time of the
    process, so interpreter start and imports count)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def loop(mix: dict):
    return importlib.import_module(f"portbench.loops.{mix['loop']}")


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: every metric without a ``workloads`` list, and those that list
    the cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, rec: dict) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(rec)``: a number, or None when the
    run holds nothing to read it from."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not hold,
    compared as whole names (``fks_tpu_torch`` is not ``fks_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# ----------------------------------------------------------- the timeline

def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


class Timeline:
    """A ``torch.profiler`` trace reduced to what the metrics read: the
    device's operations (kernels, copies, fills) as intervals, the host's
    operations, and the traced window's length on the host clock."""

    def __init__(self, prof, window_s: float):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self.window_s = float(window_s)
        self.device: List[tuple] = []  # (start_ns, end_ns, name)
        self.host: List[tuple] = []
        for ev in prof.profiler.kineto_results.events():
            start = _ns(ev, "start")
            item = (start, start + _ns(ev, "duration"), ev.name())
            (self.device if ev.device_type() == cuda
             else self.host).append(item)
        self.device.sort()
        self._merged = self._merge()

    def _merge(self) -> List[list]:
        out: List[list] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._merged) / 1e9

    def durations(self, substring: str) -> List[float]:
        """Seconds of each device operation whose name holds
        ``substring``."""
        return [(e - s) / 1e9 for s, e, n in self.device if substring in n]

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for s, e, n in self.device:
            tot[n[:160]] = tot.get(n[:160], 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(tot.items(),
                                          key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest gaps between device operations, each named by
        the innermost host operation open at its middle (or by the device
        operation it follows, where the host was not traced)."""
        gaps = []
        for (_, e0), (s1, _) in zip(self._merged, self._merged[1:]):
            gaps.append((s1 - e0, e0, s1))
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:k]:
            mid = (s + e) // 2
            inner = [(he - hs, n) for hs, he, n in self.host
                     if hs <= mid <= he]
            if inner:
                label = "host: " + min(inner)[1][:120]
            else:
                before = [n for ds, de, n in self.device if de <= s]
                label = "after " + (before[-1][:120] if before else "start")
            out.append([label, length / 1e9])
        return out

    def summary(self) -> dict:
        return {"busy_s": self.busy_s, "window_s": self.window_s,
                "device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def profile():
    """A ``torch.profiler`` session over the host's and the card's
    operations."""
    from torch.profiler import ProfilerActivity, profile as _profile

    return _profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA])


def run_cell(root: Path, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             overrides: Optional[dict] = None):
    """Run cell ``name`` of ``root/BENCHMARK.json``: its loop sets up,
    measures and checks; its metrics are read from the loop's record.
    Returns (result line without ``device``'s card fields, record)."""
    bench = load_benchmark(root)
    cell = find_cell(bench, name)
    cfg = load_json("configs", cell["config"])
    mix = load_json("traffic", cell["traffic"])
    kw = {} if overrides is None else {"overrides": overrides}
    rec = loop(mix).run(cell, cfg, mix, seed, seconds, trace,
                          device=device, **kw)
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"memory_peak_bytes": rec["memory_peak_bytes"]}
    if trace:
        dev.update(busy_s=rec["timeline"]["busy_s"],
                   window_s=rec["timeline"]["window_s"])
    return result_line(rec, metrics, dev, rec["checks"]), rec


def result_line(rec: dict, metrics: Dict[str, dict], device: dict,
                checks: List[list]) -> dict:
    """The run's last stdout line; ``checks`` (each compared number
    beside its limit) comes last."""
    line = {"correct": bool(rec["correct"]), "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics, "device": device}
    if rec.get("timeline") is not None:
        tl = rec["timeline"]
        line["breakdown"] = {"device_ops": tl["device_ops"],
                             "idle_gaps": tl["idle_gaps"]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    return line


def now() -> float:
    return time.perf_counter()
