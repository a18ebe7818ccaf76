"""Namespaced logging: ``get_logger``, a one-function copy of
fks_tpu.utils.logging's. ``MetricsWriter`` waits for the rest of
``utils/`` (ROADMAP queue 1)."""
from __future__ import annotations

import logging
import os

_CONFIGURED = False


def get_logger(name: str = "fks_tpu_torch") -> logging.Logger:
    """A logger under ``fks_tpu_torch``; configures that root once, level
    from ``FKS_LOG_LEVEL`` (default INFO)."""
    global _CONFIGURED
    root = logging.getLogger("fks_tpu_torch")
    if not _CONFIGURED:
        level = os.environ.get("FKS_LOG_LEVEL", "INFO").upper()
        root.setLevel(getattr(logging, level, logging.INFO))
        if not root.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname).1s %(message)s",
                datefmt="%H:%M:%S"))
            root.addHandler(h)
        root.propagate = False
        _CONFIGURED = True
    if name == "fks_tpu_torch" or name.startswith("fks_tpu_torch."):
        return logging.getLogger(name)
    return logging.getLogger(f"fks_tpu_torch.{name}")
