"""Fault-injection primitives for the promotion pipeline.

Port of fks_tpu.pipeline.faults. A ``FaultPlan`` is threaded through
``PromotionController`` and injects failures at the seams production
would break at: the LLM endpoint, the shadow build on the device, the
champion JSON handoff, and the process itself (kill mid-promotion).
Every injection is deterministic — the drill matrix
(``pipeline.drills``) asserts the precise degraded behaviour, not a
probability of it.

``KillSwitch`` models ``kill -9``: it is raised right AFTER a state
record has been durably appended to promotion.jsonl, the worst honest
moment to die — the log says one thing, the in-memory engines may say
another. Recovery must resolve the difference from the log alone.

Pure host code.
"""
from __future__ import annotations

import dataclasses
import json
import os


class KillSwitch(RuntimeError):
    """Simulated ``kill -9`` right after a durable log append."""


class FaultInjected(RuntimeError):
    """A deliberately injected failure (device eval, LLM outage)."""


@dataclasses.dataclass
class FaultPlan:
    """Which failures to inject, and where.

    - ``device_eval_error``: the shadow-engine build raises (a device
      eval exception) — the attempt must degrade to REJECTED.
    - ``kill_after_state``: raise KillSwitch right after the named state
      (PENDING/SHADOW/PROMOTED/ROLLED_BACK) is appended to the log.
    - ``shadow_latency_ms``: pad every shadow-engine answer by this much
      — a deterministic p99 regression the latency/SLO gates must catch.
    """
    device_eval_error: bool = False
    kill_after_state: str = ""
    shadow_latency_ms: float = 0.0

    def maybe_kill(self, state: str) -> None:
        if self.kill_after_state and state == self.kill_after_state:
            raise KillSwitch(f"injected kill -9 after {state} was logged")

    def maybe_eval_error(self) -> None:
        if self.device_eval_error:
            raise FaultInjected("injected device-eval exception")

    def shadow_delay_s(self) -> float:
        return self.shadow_latency_ms / 1e3


NO_FAULTS = FaultPlan()


class OutageBackend:
    """An LLM backend whose every call fails — the total-outage drill for
    the evolve loop's llm_outage circuit breaker."""

    def __init__(self) -> None:
        self.calls = 0

    def complete(self, prompt: str) -> str:
        self.calls += 1
        raise FaultInjected("injected LLM outage")


class FlakyEngineProxy:
    """A serve engine that loses its device for the first ``failures``
    batches (raising ``resilience.degrade.DeviceFault``, which
    ``classify_fault`` reads as a device fault), then recovers — the
    device-loss-mid-batch drill. Everything else delegates to the real
    warm engine, so parity assertions run against the same graphs."""

    def __init__(self, inner, failures: int = 1) -> None:
        self._inner = inner
        self._failures_left = failures
        self.faults_raised = 0

    def __getattr__(self, name):  # envelope, base_pods, reference_answer…
        return getattr(self._inner, name)

    def answer_batch(self, pod_lists):
        if self._failures_left > 0:
            self._failures_left -= 1
            self.faults_raised += 1
            from fks_tpu_torch.resilience.degrade import DeviceFault
            raise DeviceFault("injected device loss mid-batch")
        return self._inner.answer_batch(pod_lists)


class CountingBackend:
    """A FakeLLM wrapper that counts ``complete`` calls — the WAL-resume
    drill's zero-LLM-calls assertion."""

    def __init__(self, seed: int = 0) -> None:
        from fks_tpu_torch.funsearch import llm as llm_mod

        self._inner = llm_mod.FakeLLM(seed=seed)
        self.calls = 0

    def complete(self, prompt: str) -> str:
        self.calls += 1
        return self._inner.complete(prompt)

    def getstate(self):
        return self._inner.getstate()

    def setstate(self, state) -> None:
        self._inner.setstate(state)


def write_champion(directory: str, code: str, score: float,
                   name: str = "drill", generation: int = 1) -> str:
    """Write a well-formed champion JSON the way the evolve loop does
    (atomic tmp + rename), named so ``latest_champion`` can rank it."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory,
                        f"funsearch_{name}_score{score:.4f}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"code": code, "score": score, "generation": generation,
                   "timestamp": "drill"}, f)
    os.replace(tmp, path)
    return path


def write_corrupt_champion(directory: str, name: str = "corrupt") -> str:
    """A champion JSON torn mid-write — an evolve worker that dumped
    straight to the final path and died. Valid filename, invalid body."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"funsearch_{name}_score9.9999.json")
    with open(path, "w") as f:
        f.write('{"code": "def priority_function(pod, node):\\n  ')
    return path
