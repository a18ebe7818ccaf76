"""Multi-tenant champion-portfolio serving.

Port of fks_tpu.portfolio: one set of warm graphs, N resident policies.
``PortfolioEngine`` stacks N ``VMProgram`` champions into one slot table
that every lane of its graphs indexes with its own slot, ``Router`` maps
requests to slots (tenant pin / workload-class affinity / weighted A-B /
coverage fallback), and ``PortfolioService`` threads the slot index
through the request batcher, and ``FleetController`` extends the
promotion pipeline (``pipeline.PromotionController``) to one slot.
"""
from fks_tpu_torch.portfolio.engine import (
    PortfolioEngine, PortfolioParams, portfolio_selftest,
)
from fks_tpu_torch.portfolio.fleet import FleetController
from fks_tpu_torch.portfolio.router import (
    FALLBACK, ROUTE_REASONS, Router, vm_coverage_split,
)
from fks_tpu_torch.portfolio.service import PortfolioService

__all__ = [
    "FALLBACK",
    "FleetController",
    "PortfolioEngine",
    "PortfolioParams",
    "PortfolioService",
    "ROUTE_REASONS",
    "Router",
    "portfolio_selftest",
    "vm_coverage_split",
]
