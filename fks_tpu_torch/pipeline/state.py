"""Crash-safe promotion ledger: the append-only ``promotion.jsonl``
state machine.

Every promotion attempt is a sequence of single-line JSON records,
``PENDING -> SHADOW -> PROMOTED/REJECTED`` plus ``PROMOTED ->
ROLLED_BACK``. The file is the ONLY durable state the pipeline owns:

- every append is flushed AND fsync'd before the caller proceeds, so a
  ``kill -9`` immediately after a transition still finds that record on
  restart — the in-memory flip always happens after its log record;
- a kill mid-append leaves at most one torn trailing line; the reader
  skips (and counts) any unparsable line instead of raising, and the
  next append repairs the missing newline so the file stays valid JSONL;
- the latest record per attempt wins; interrupted attempts (last state
  PENDING or SHADOW) are re-runnable — the transition map allows
  re-entering PENDING/SHADOW so a restarted controller replays the
  attempt from the top;
- terminal states (REJECTED, ROLLED_BACK) are closed: no transition
  leaves them, so a rejected champion is never retried by accident.

Port of fks_tpu.pipeline.state: the same file format, read and written
by either package. Pure host code, importable anywhere (``cli pipeline``
status stays cheap).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

STATES = ("PENDING", "SHADOW", "PROMOTED", "REJECTED", "ROLLED_BACK")
TERMINAL = frozenset({"REJECTED", "ROLLED_BACK"})

# current-state -> states an append may move the attempt to. PENDING and
# SHADOW admit re-entry (an interrupted attempt restarts from the top);
# PROMOTED only ever rolls back; terminal states admit nothing.
_ALLOWED: Dict[Optional[str], frozenset] = {
    None: frozenset({"PENDING"}),
    "PENDING": frozenset({"PENDING", "SHADOW", "REJECTED"}),
    "SHADOW": frozenset({"PENDING", "SHADOW", "PROMOTED", "REJECTED"}),
    "PROMOTED": frozenset({"ROLLED_BACK"}),
    "REJECTED": frozenset(),
    "ROLLED_BACK": frozenset(),
}


class PromotionLog:
    """Append-only promotion.jsonl with transition validation on write
    and torn-tail tolerance on read."""

    def __init__(self, path: str) -> None:
        self.path = os.fspath(path)
        self.records: List[Dict[str, Any]] = []
        self.skipped_lines = 0
        self._state: Dict[str, str] = {}
        self._needs_newline = False
        self._load()

    # ------------------------------------------------------------- read

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        if not raw:
            return
        self._needs_newline = not raw.endswith(b"\n")
        for line in raw.decode("utf-8", errors="replace").splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                aid, state = rec["attempt"], rec["state"]
            except (json.JSONDecodeError, KeyError, TypeError):
                # torn line from a kill mid-write — count, don't raise
                self.skipped_lines += 1
                continue
            if state not in STATES:
                self.skipped_lines += 1
                continue
            self.records.append(rec)
            self._state[str(aid)] = state

    # ------------------------------------------------------------ write

    def append(self, attempt: str, state: str, **detail) -> Dict[str, Any]:
        """Validate the transition, then durably append one record
        (write + flush + fsync). Raises ValueError on an illegal move."""
        if state not in STATES:
            raise ValueError(f"unknown promotion state {state!r} "
                             f"(expected one of {STATES})")
        current = self._state.get(attempt)
        if state not in _ALLOWED[current]:
            raise ValueError(
                f"illegal promotion transition for attempt {attempt}: "
                f"{current or '<new>'} -> {state}")
        rec = {"ts": round(time.time(), 3), "attempt": attempt,
               "state": state, **detail}
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "a") as f:
            # a torn tail has no newline; repair it so this record stays
            # its own parseable line
            f.write(("\n" if self._needs_newline else "")
                    + json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._needs_newline = False
        self.records.append(rec)
        self._state[attempt] = state
        return rec

    # ------------------------------------------------------------ views

    def states(self) -> Dict[str, str]:
        """attempt id -> latest state."""
        return dict(self._state)

    def state_of(self, attempt: str) -> Optional[str]:
        return self._state.get(attempt)

    def interrupted(self) -> List[str]:
        """Attempts whose last record is PENDING or SHADOW — a controller
        died mid-attempt; they are safe to replay from the top."""
        return [a for a, s in self._state.items()
                if s in ("PENDING", "SHADOW")]

    def active(self) -> Optional[Dict[str, Any]]:
        """The latest PROMOTED record whose attempt was not since rolled
        back — what a restarted server should be serving."""
        for rec in reversed(self.records):
            if (rec["state"] == "PROMOTED"
                    and self._state.get(rec["attempt"]) == "PROMOTED"):
                return rec
        return None

    def summary(self) -> Dict[str, Any]:
        """Status payload for ``cli pipeline``: per-attempt states, the
        active promotion, interrupted attempts, torn-line count."""
        return {
            "path": self.path,
            "records": len(self.records),
            "skipped_lines": self.skipped_lines,
            "attempts": self.states(),
            "interrupted": self.interrupted(),
            "active": self.active(),
        }
