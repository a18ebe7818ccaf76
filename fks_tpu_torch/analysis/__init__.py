"""Static analysis: the candidate pre-flight.

Port of fks_tpu.analysis's ``candidate`` module. Its repo linter
(``analysis/lint.py``) checks JAX lowerings and waits for the rest of
``obs/`` (ROADMAP queue 1 item 6).
"""
from fks_tpu_torch.analysis.candidate import (
    REJECT_TAXONOMY, CostEstimate, PreflightReport, fingerprint,
    preflight_check,
)

__all__ = [
    "REJECT_TAXONOMY", "CostEstimate", "PreflightReport", "fingerprint",
    "preflight_check",
]
