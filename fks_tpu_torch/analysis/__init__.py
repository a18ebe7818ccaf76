"""Static analysis: the candidate pre-flight and the repo linter.

Port of fks_tpu.analysis. ``candidate`` is imported eagerly (pure stdlib
plus the funsearch tables); ``lint`` (the capture-invariant lint behind
``cli lint``) is imported on its own, as fks_tpu's is.
"""
from fks_tpu_torch.analysis.candidate import (
    REJECT_TAXONOMY, CostEstimate, PreflightReport, fingerprint,
    preflight_check,
)

__all__ = [
    "REJECT_TAXONOMY", "CostEstimate", "PreflightReport", "fingerprint",
    "preflight_check",
]
