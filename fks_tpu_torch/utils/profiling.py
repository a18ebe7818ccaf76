"""Wall-clock timing that waits for the device work it times, device
traces and throughput counters.

Port of fks_tpu.utils.profiling. CUDA calls return before the card
finishes, so a plain clock delta measures the enqueue: a value
registered with ``Timing.sync`` (or passed as ``sync=``) makes the clock
stop only after ``torch.cuda.synchronize`` on every CUDA device the
value's tensors live on. CPU tensors are ready when the call returns.
``device_trace`` records a ``torch.profiler`` trace (fks_tpu's is an
XLA profile), and ``ThroughputMeter`` sums (count, seconds) batches into
a rate.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Set

import torch


def _cuda_devices(value: Any, out: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of every tensor inside ``value`` (tensors, tuples,
    lists, dicts, NamedTuples and dataclasses, nested)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)
    return out


def block_until_ready(value: Any) -> Any:
    """Wait until the device work behind ``value`` is done; returns it."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)
    return value


@dataclass
class Timing:
    """Result of a ``timed`` block. ``seconds`` is valid after the block."""

    label: str = ""
    seconds: float = 0.0
    _sync: Any = None

    def sync(self, value):
        """Register a value (tensors, or a structure of them) produced
        inside the block; the clock stops only after its device work is
        done. Returns the value for inline use."""
        self._sync = value
        return value


@contextlib.contextmanager
def timed(label: str = "", sync: Any = None,
          on_exit: Any = None) -> Iterator[Timing]:
    """Measure a block's wall time. For device work, register the block's
    output via ``t.sync(...)`` so the clock includes the compute;
    ``sync=`` covers values that already exist at entry. ``on_exit``
    (``Callable[[Timing], None]``) fires after the clock stops (fks_tpu's
    spans record their events through it; ``obs.spans.span`` keeps its
    own clock)."""
    out = Timing(label=label, _sync=sync)
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if out._sync is not None:
            block_until_ready(out._sync)
        out.seconds = time.perf_counter() - t0
        if on_exit is not None:
            on_exit(out)


def block_timed(fn, *args, **kwargs):
    """Call ``fn`` and return (result, seconds) with the result's device
    work done."""
    t0 = time.perf_counter()
    result = block_until_ready(fn(*args, **kwargs))
    return result, time.perf_counter() - t0


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels when CUDA is available) and write it into ``logdir`` as
    a Chrome trace (``trace.json``; chrome://tracing or Perfetto). fks_tpu
    writes an XLA profile for TensorBoard here instead."""
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(tp.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tp.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class ThroughputMeter:
    """Accumulate (count, seconds) batches; report rates.

    ``rate`` is total count over total seconds (not a mean of rates,
    which would overweight small batches).
    """

    counts: List[float] = field(default_factory=list)
    seconds: List[float] = field(default_factory=list)

    def add(self, count: float, seconds: float) -> None:
        self.counts.append(float(count))
        self.seconds.append(float(seconds))

    @property
    def total_count(self) -> float:
        return sum(self.counts)

    @property
    def total_seconds(self) -> float:
        return sum(self.seconds)

    @property
    def rate(self) -> Optional[float]:
        """Items per second over everything recorded; None if no time."""
        if self.total_seconds <= 0:
            return None
        return self.total_count / self.total_seconds

    def summary(self) -> str:
        r = self.rate
        return (f"{self.total_count:.0f} in {self.total_seconds:.2f}s"
                + (f" = {r:.1f}/s" if r is not None else ""))
