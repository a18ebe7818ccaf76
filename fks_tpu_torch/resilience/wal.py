"""Generation-level write-ahead log for the evolve loop.

The expensive, non-reproducible spend in one generation is (a) the LLM
calls that draft candidates and (b) the device evaluations that score
them. A kill -9 mid-generation loses both today: the checkpoint only
lands at run end. The WAL makes that spend durable at the moment it
happens, with the ``pipeline/state.py`` durability idiom — every append
is write + flush + fsync, a torn trailing line is skipped (and counted)
on read, and the next append repairs the missing newline.

Record kinds (one JSON object per line):

- ``{"kind": "codes", "generation": g, "codes": [...]}`` — the drafted
  candidate sources, appended right after ``generate_many`` returns and
  BEFORE any evaluation. A resume of generation ``g`` replays these and
  issues ZERO LLM calls.
- ``{"kind": "eval", "generation": g, "key": ..., "score": ..., ...}``
  — one per evaluated candidate (keyed by code sha1). A resume skips
  the device eval for every candidate already recorded.
- ``{"kind": "commit", "generation": g}`` — the generation is fully
  committed (ledger + checkpoint); its records are dead weight, never
  replayed.

The driver (``FunSearch``) checkpoints at every generation boundary when
a WAL is attached, so the pending window is always exactly one
generation: restore the checkpoint, replay the WAL, lose nothing.

Port of fks_tpu.resilience.wal, unchanged: the record format is
byte-identical, so a WAL written by either package replays in the other.
Pure host code, importable anywhere.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional


class GenerationWAL:
    """Append-only, fsync'd, torn-tail-tolerant generation log."""

    def __init__(self, path: str) -> None:
        self.path = os.fspath(path)
        self.records: List[Dict[str, Any]] = []
        self.skipped_lines = 0
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
                kind, gen = rec["kind"], int(rec["generation"])
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                # torn line from a kill mid-write — count, don't raise
                self.skipped_lines += 1
                continue
            if kind not in ("codes", "eval", "commit"):
                self.skipped_lines += 1
                continue
            del gen
            self.records.append(rec)

    # ------------------------------------------------------------ write

    def _append(self, rec: Dict[str, Any]) -> None:
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

    @staticmethod
    def code_key(code: str) -> str:
        return hashlib.sha1(code.encode("utf-8")).hexdigest()

    def record_codes(self, generation: int, codes: List[str]) -> None:
        """Durably persist the drafted candidates BEFORE evaluation — the
        LLM spend is safe from this point on."""
        self._append({"kind": "codes", "generation": int(generation),
                      "codes": list(codes)})

    def record_eval(self, generation: int, record: Any) -> None:
        """Durably persist one candidate's evaluation outcome (an
        ``EvalRecord``-shaped object: code/score/error/scenario_scores/
        aggregation/budget_rung)."""
        self._append({
            "kind": "eval", "generation": int(generation),
            "key": self.code_key(record.code),
            "score": float(record.score),
            "error": record.error,
            "scenario_scores": record.scenario_scores,
            "aggregation": record.aggregation,
            "budget_rung": record.budget_rung,
        })

    def commit(self, generation: int) -> None:
        """The generation is fully committed (ledger + checkpoint landed);
        resumes will never replay it."""
        self._append({"kind": "commit", "generation": int(generation)})

    # ------------------------------------------------------------ views

    def committed(self, generation: int) -> bool:
        g = int(generation)
        return any(r["kind"] == "commit" and r["generation"] == g
                   for r in self.records)

    def pending_codes(self, generation: int) -> Optional[List[str]]:
        """The drafted codes for an UNCOMMITTED generation, or None when
        the generation has no codes record (or was already committed)."""
        if self.committed(generation):
            return None
        g = int(generation)
        for rec in reversed(self.records):
            if rec["kind"] == "codes" and rec["generation"] == g:
                return list(rec["codes"])
        return None

    def cached_evals(self, generation: int) -> Dict[str, Dict[str, Any]]:
        """code-key -> eval record for an uncommitted generation (empty
        when committed: nothing to replay)."""
        if self.committed(generation):
            return {}
        g = int(generation)
        out: Dict[str, Dict[str, Any]] = {}
        for rec in self.records:
            if rec["kind"] == "eval" and rec["generation"] == g:
                out[rec["key"]] = rec
        return out

    def summary(self) -> Dict[str, Any]:
        gens = sorted({r["generation"] for r in self.records})
        return {"path": self.path, "records": len(self.records),
                "skipped_lines": self.skipped_lines,
                "generations": gens,
                "committed": [g for g in gens if self.committed(g)]}
