"""The metric arithmetic: a rate over the whole window, and the device
timeline."""
from types import SimpleNamespace

import pytest
import torch

from portbench import harness


def read(name, rec):
    return harness.read_metric(name, rec)


@pytest.mark.parametrize("name", ["cand_evals_per_s",
                                  "cand_evals_per_s.flat"])
def test_rate_is_all_work_over_all_the_window(name):
    rec = {"candidates": 3 * 256, "window_s": 0.25}
    assert read(name, rec) == pytest.approx(3072.0)


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)


def _timeline(events, window_s):
    res = SimpleNamespace(events=lambda: events)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))
    return harness.Timeline(prof, window_s)


def test_timeline_busy_time_gaps_and_kernels():
    ev = [_Event("k1", 0, 100, True), _Event("k2", 50, 100, True),
          _Event("k1", 400, 100, True), _Event("host_op", 150, 300, False)]
    tl = _timeline(ev, 1e-6)
    assert tl.busy_s == pytest.approx(250e-9)  # [0, 150] and [400, 500]
    assert tl.durations("k1") == pytest.approx([100e-9, 100e-9])
    assert tl.top_ops()[0] == ["k1", pytest.approx(200e-9)]
    assert tl.idle_gaps() == [["host: host_op", pytest.approx(250e-9)]]
    s = tl.summary()
    rec = {"timeline": s, "candidates": 10, "generations": 2,
           "trace_whole_window": True}
    assert read("device.idle_pct.eval", rec) == pytest.approx(75.0)
    assert read("search.host_ms_per_gen", rec) == \
        pytest.approx(1e3 * 750e-9 / 2)


def test_flat_step_time_from_replays():
    rec = {"timeline": {"busy_s": 0.32, "window_s": 1.0}, "engine": "flat",
           "trace_replays": 50, "steps_per_replay": 16}
    assert read("flat.step_us", rec) == pytest.approx(400.0)
    rec["engine"] = "fused"
    assert read("flat.step_us", rec) is None
