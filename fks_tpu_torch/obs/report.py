"""Run-directory reading.

Port of ``read_jsonl`` from fks_tpu.obs.report, with its torn-tail rule:
a flight recorder flushes whole lines, so only the LAST line of a file
may be torn (a killed writer); a bad line anywhere else is corruption.
The rendered report (``cli report``) waits for the rest of ``obs/``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL file line by line; raises ValueError naming the line
    on a corrupt record other than a torn final line, which is skipped."""
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines):  # torn final write from a killed run
                continue
            raise ValueError(f"{path}:{i}: unparseable JSONL line") from None
    return rows
