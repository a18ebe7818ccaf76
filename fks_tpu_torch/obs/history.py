"""Run history: the serve tier's service-level objectives.

Port of the SLO part of fks_tpu.obs.history (``SLOConfig``, ``slo_burn``,
``record_slo_burn``; fks_tpu/obs/history.py:367-425), pure stdlib. The
run-directory history (``RunHistory``) needs ``obs/compare.py`` and waits
for ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from fks_tpu_torch.obs.recorder import get_recorder


# -------------------------------------------------------------------- SLOs


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Serve-tier service-level objectives. ``p99_ms``: target warm tail
    latency (the SLI is the fraction of requests slower than it;
    ``error_budget`` of them are allowed). ``qps``: target sustained
    throughput (the SLI is the relative shortfall against it). 0 leaves
    an objective unset."""

    p99_ms: float = 0.0
    qps: float = 0.0
    error_budget: float = 0.01

    @property
    def enabled(self) -> bool:
        return bool(self.p99_ms or self.qps)


def slo_burn(slo: SLOConfig, latencies_ms: List[float],
             elapsed_s: float) -> List[Dict[str, Any]]:
    """Price an observation window against the SLOs: one record per set
    objective — ``{"slo", "target", "observed", "burn_rate", ...}`` —
    where burn_rate is the multiple of the error budget the window is
    consuming (>1 = violating; the alerting threshold everywhere)."""
    records: List[Dict[str, Any]] = []
    n = len(latencies_ms)
    if slo.p99_ms and n:
        over = sum(1 for v in latencies_ms if v > slo.p99_ms) / n
        srt = sorted(latencies_ms)
        p99 = srt[min(n - 1, int(0.99 * n))]
        records.append({
            "slo": "p99_ms", "target": float(slo.p99_ms),
            "observed": round(float(p99), 3),
            "over_fraction": round(over, 4),
            "burn_rate": round(over / slo.error_budget, 3),
            "requests": n,
        })
    if slo.qps and elapsed_s > 0 and n:
        observed = n / elapsed_s
        shortfall = max(0.0, 1.0 - observed / slo.qps)
        records.append({
            "slo": "qps", "target": float(slo.qps),
            "observed": round(observed, 3),
            "over_fraction": round(shortfall, 4),
            "burn_rate": round(shortfall / slo.error_budget, 3),
            "requests": n,
        })
    return records


def record_slo_burn(slo: SLOConfig, latencies_ms: List[float],
                    elapsed_s: float, recorder=None) -> List[Dict[str, Any]]:
    """``slo_burn`` metrics onto ``recorder`` for each set objective;
    returns the records."""
    rec = recorder if recorder is not None else get_recorder()
    records = slo_burn(slo, latencies_ms, elapsed_s)
    for r in records:
        rec.metric("slo_burn", dict(r))
    return records
