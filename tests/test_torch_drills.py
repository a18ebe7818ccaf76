"""The drill matrix of the port (``pipeline.run_drills``: 11 promotion
drills and the 7 of ``resilience.RESILIENCE_DRILLS``) on the CPU.

Each drill runs as one case on a module-scoped ``DrillStack(device=
"cpu")``: it must be ok, and its detail must carry fks_tpu's keys
(``FKS_TPU_DETAIL_KEYS``, the keys of fks_tpu's drill results). The slow
case runs fks_tpu's whole matrix beside the port's and holds every
drill's verdict and keys to fks_tpu's live, which also checks the pins.

The drills run fks_tpu's default 2x p99 gate. Each controller module
reads a pinned clock here (``ReplayClock``: every replayed query times
1 ms plus the pad that ``FaultPlan`` injects), so a verdict does not
hang on the host's load; ``chip_smoke.py`` phase 14 runs the matrix on
the card's own clock.
"""
import threading
import time

import pytest

import fks_tpu_torch.pipeline.controller as pt_controller
from fks_tpu_torch.pipeline import drills as pt_drills

FKS_TPU_DETAIL_KEYS = {
    "corrupt_champion": {"action", "reason"},
    "device_eval_error": {"action", "reason"},
    "p99_regression_rejected": {"action", "reason"},
    "kill_pending": {"killed_after", "recovered"},
    "kill_shadow": {"killed_after", "recovered"},
    "kill_promoted": {"killed_after", "recovered"},
    "rollback_on_burn": {"promoted", "then"},
    "zero_recompile_swap": {"action", "recompiles", "swap_ms"},
    "vm_double_swap": {"first", "then", "recompiles", "vm_swaps",
                       "swap_ms"},
    "portfolio_slot_promotion": {"verdict", "recompiles", "slot_swaps",
                                 "bystander_drift"},
    "llm_outage": {"halted_at_generation", "llm_calls"},
    "deadline_storm": {"typed_failures", "shed", "expired"},
    "queue_overload": {"retry_after_s", "completed"},
    "device_loss_mid_batch": {"state", "flips", "parity_drift"},
    "device_loss_sharded_serve": {"state", "flips", "parity_drift",
                                  "mesh_devices", "follow_up_answers",
                                  "served", "complete", "retried",
                                  "traces_ok"},
    "degrade_then_recover": {"state", "recoveries",
                             "post_recovery_recompiles", "parity_drift",
                             "served", "complete", "retried", "traces_ok"},
    "sigterm_drain": {"drained_pending", "completed", "shed",
                      "replay_persisted"},
    "wal_resume_mid_generation": {"resume_llm_calls", "replayed_codes",
                                  "replayed_evals",
                                  "resume_device_programs"},
}


class ReplayClock:
    """A controller module's ``time`` with a pinned ``perf_counter``: each
    reading is 1 ms after the last, so an interval read around one call
    is 1 ms on any host. Everything else is the real ``time``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._now = 0.0

    def perf_counter(self):
        with self._lock:
            self._now += 1e-3
            return self._now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture(autouse=True)
def replay_clock(monkeypatch):
    monkeypatch.setattr(pt_controller, "time", ReplayClock())


def detail_keys(result):
    return set(result) - {"drill", "ok"}


@pytest.fixture(scope="module")
def stack():
    return pt_drills.DrillStack(device="cpu")


def test_matrix_is_fks_tpus():
    assert list(pt_drills.drills()) == list(FKS_TPU_DETAIL_KEYS)
    assert len(FKS_TPU_DETAIL_KEYS) == 18


@pytest.mark.parametrize("name", list(FKS_TPU_DETAIL_KEYS))
def test_drill_on_cpu(stack, name):
    result = pt_drills.run_drill(stack, name)
    assert result["drill"] == name
    assert result["ok"], result
    assert detail_keys(result) == FKS_TPU_DETAIL_KEYS[name]


def test_run_drills_only_and_crash_is_a_failed_drill(stack, monkeypatch):
    """``only`` selects by substring; a drill that raises is reported as
    a failed drill with its error, and the matrix goes on."""
    def crash(_stack):
        raise RuntimeError("boom")

    table = dict(pt_drills.drills())
    table["queue_overload"] = crash
    monkeypatch.setattr(pt_drills, "drills", lambda: table)
    lines = []
    out = pt_drills.run_drills(log=lines.append, only="queue,deadline",
                               device="cpu")
    assert [r["drill"] for r in out] == ["deadline_storm", "queue_overload"]
    assert out[0]["ok"] and not out[1]["ok"]
    assert out[1]["error"] == "RuntimeError: boom"
    assert lines[1].startswith("drill queue_overload: FAIL")


@pytest.mark.slow
def test_full_matrix_verdicts_equal_fks_tpu(monkeypatch):
    import fks_tpu.pipeline.controller as fk_controller
    from fks_tpu.pipeline import run_drills as fk_run_drills

    monkeypatch.setattr(fk_controller, "time", ReplayClock())

    theirs = fk_run_drills(log=lambda _m: None)
    ours = pt_drills.run_drills(log=lambda _m: None, device="cpu")
    assert [r["drill"] for r in ours] == [r["drill"] for r in theirs]
    for a, b in zip(ours, theirs):
        assert a["ok"] == b["ok"], (a, b)
        assert detail_keys(a) == detail_keys(b), (a, b)
        assert detail_keys(b) == FKS_TPU_DETAIL_KEYS[b["drill"]]
    assert all(r["ok"] for r in ours)
