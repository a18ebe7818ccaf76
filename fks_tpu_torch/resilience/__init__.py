"""Resilience: the evolve loop's generation write-ahead log and the serve
tier's deadlines, admission control and degraded mode.

Port of fks_tpu.resilience, all host-side control plane: ``deadline`` /
``admission`` (per-request budgets, a bounded queue that sheds with a
typed ``ShedError``), ``degrade`` (device-fault classification and the
opt-in flip to an exact fallback engine) and ``wal``. The SIGTERM drain
(``drain.py``) and the drills wait for the control-plane slice (ROADMAP
queue 1 item 5).
"""
from fks_tpu_torch.resilience.admission import (
    AdmissionConfig, AdmissionController,
)
from fks_tpu_torch.resilience.deadline import (
    Deadline, DeadlineExceeded, ResilienceError, ShedError,
)
from fks_tpu_torch.resilience.degrade import (
    DegradeConfig, DegradedModeManager, DeviceFault, EngineBuildError,
    NaNFlood, classify_fault, exact_fallback_factory,
)
from fks_tpu_torch.resilience.wal import GenerationWAL

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "Deadline",
    "DeadlineExceeded",
    "DegradeConfig",
    "DegradedModeManager",
    "DeviceFault",
    "EngineBuildError",
    "GenerationWAL",
    "NaNFlood",
    "ResilienceError",
    "ShedError",
    "classify_fault",
    "exact_fallback_factory",
]
