"""Resilience: the evolve loop's generation write-ahead log and the serve
tier's deadlines, admission control, degraded mode and SIGTERM drain.

Port of fks_tpu.resilience, all host-side control plane: ``deadline`` /
``admission`` (per-request budgets, a bounded queue that sheds with a
typed ``ShedError``), ``degrade`` (device-fault classification and the
opt-in flip to an exact fallback engine), ``drain`` (the SIGTERM
coordinator and the persisted serve state), ``wal``, and ``drills``
(``RESILIENCE_DRILLS``, the resilience half of ``pipeline.run_drills``,
which import the serve stack inside each drill).
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
from fks_tpu_torch.resilience.drain import (
    DrainCoordinator, load_serve_state, persist_serve_state,
)
from fks_tpu_torch.resilience.drills import RESILIENCE_DRILLS
from fks_tpu_torch.resilience.wal import GenerationWAL

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "Deadline",
    "DeadlineExceeded",
    "DegradeConfig",
    "DegradedModeManager",
    "DeviceFault",
    "DrainCoordinator",
    "EngineBuildError",
    "GenerationWAL",
    "NaNFlood",
    "RESILIENCE_DRILLS",
    "ResilienceError",
    "ShedError",
    "classify_fault",
    "exact_fallback_factory",
    "load_serve_state",
    "persist_serve_state",
]
