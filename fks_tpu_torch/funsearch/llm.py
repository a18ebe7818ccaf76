"""LLM code generation: OpenAI-compatible client + hermetic fake backend.

Port of fks_tpu.funsearch.llm (host code, a copy): ``FakeLLM`` draws from
Python's ``random.Random`` exactly as fks_tpu's does, so the same seed
gives the same candidates in both packages.

Counterpart of the reference generator (reference:
funsearch/safe_execution.py:273-328 ``LLMCodeGenerator`` — an OpenAI-SDK
chat.completions call against OpenRouter, template fill, validate, None on
any failure) and its thread-pool fan-out (reference:
funsearch/funsearch_integration.py:461-525). Codegen is host-side I/O and
stays off the device exactly as the reference keeps it outside its hot path
(SURVEY.md §3.2); concurrency is a ThreadPoolExecutor because the work is
network-bound.

The ``FakeLLM`` backend closes a testability gap called out in SURVEY.md §4:
the reference has no fake LLM, so its evolution loop is untestable without a
live API key. Here the fake draws deterministic mutations from a small
grammar of scoring ideas, seeded per call, so evolution tests are hermetic
and reproducible.
"""
from __future__ import annotations

import concurrent.futures
import random
import threading
from typing import Callable, List, Optional, Protocol, Sequence, Tuple

from fks_tpu_torch.funsearch import sandbox, template, transpiler

Parent = Tuple[str, float]  # (candidate source, fitness)


def _retry_after_seconds(headers) -> Optional[float]:
    """Parse a ``Retry-After`` response header: either delta-seconds or
    an HTTP-date (RFC 9110 §10.2.3). None when absent or unparsable —
    the caller falls back to its own backoff ladder."""
    value = headers.get("Retry-After") if headers is not None else None
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    import email.utils  # noqa: PLC0415 — keep module imports light
    import time

    try:
        when = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    return max(0.0, when.timestamp() - time.time())


class TextBackend(Protocol):
    """Something that turns a prompt into a raw logic block."""

    def complete(self, prompt: str) -> str: ...


class OpenAIBackend:
    """OpenAI-compatible chat/completions client, self-contained over
    stdlib HTTP (reference: safe_execution.py:283-303 does the same call
    through the ``openai`` SDK against OpenRouter).

    Dropping the SDK is deliberate: the request is one POST with a JSON
    body and the response is one JSON object — a dependency-free client
    keeps the framework runnable (and this path hermetically testable,
    tests/test_torch_llm.py) in images without the SDK. Unlike the
    reference, timeout and retry policy are explicit: the SDK's 600 s
    default timeout stalls a whole generation's thread-pool slot on one
    hung request.

    Wire behavior: POST ``{base_url}/chat/completions`` with
    ``{model, messages, max_tokens, temperature}`` and a Bearer key;
    transient failures (connect/read errors, HTTP 429/5xx) retry up to
    ``max_retries`` times with linear backoff; anything else raises —
    ``CandidateGenerator.generate`` maps every raise to None, matching the
    reference's None-on-any-failure contract (safe_execution.py:315-317).
    """

    def __init__(self, api_key: str, base_url: str, model: str,
                 max_tokens: int = 500, temperature: float = 0.7,
                 timeout: float = 60.0, max_retries: int = 2,
                 deadline: Optional[float] = None):
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.timeout = timeout
        self.max_retries = max_retries
        # ``timeout`` is PER ATTEMPT; the overall bound on one complete()
        # call is this deadline, enforced across retries + backoff so one
        # hung endpoint holds a generation thread-pool slot for at most
        # this long (default: the old worst case, attempts x timeout + the
        # backoff sum, now explicit instead of implied)
        self.deadline = deadline if deadline is not None else (
            (max_retries + 1) * timeout
            + sum(0.5 * (a + 1) for a in range(max_retries)))

    def complete(self, prompt: str) -> str:
        import json  # noqa: PLC0415 — keep module imports light
        import time
        import urllib.error
        import urllib.request

        body = json.dumps({
            "model": self.model,
            "messages": [{"role": "user", "content": prompt}],
            "max_tokens": self.max_tokens,
            "temperature": self.temperature,
        }).encode()
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions", data=body,
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        last: Exception = TimeoutError(
            f"deadline ({self.deadline:g}s) exhausted before any attempt")
        t_end = time.monotonic() + self.deadline
        retry_after: Optional[float] = None
        for attempt in range(self.max_retries + 1):
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break  # overall deadline exhausted mid-retry
            try:
                with urllib.request.urlopen(
                        req, timeout=min(self.timeout, remaining)) as r:
                    # chunked read with deadline checks: urlopen's timeout
                    # is per-socket-operation, so a drip-feeding endpoint
                    # resets it with every byte. read1 issues at most ONE
                    # underlying recv (read(n) would loop recvs until n
                    # bytes arrive, deferring the check indefinitely), so
                    # t_end is re-checked per recv and the overall bound
                    # is ~deadline + one socket timeout.
                    chunks = []
                    while True:
                        if time.monotonic() >= t_end:
                            raise TimeoutError(
                                "deadline exhausted mid-response")
                        chunk = r.read1(65536)
                        if not chunk:
                            break
                        chunks.append(chunk)
                    resp = json.loads(b"".join(chunks).decode())
                return (resp["choices"][0]["message"]["content"] or "").strip()
            except urllib.error.HTTPError as e:
                last = e
                if e.code not in (429, 500, 502, 503, 504):
                    raise
                # rate-limit / overload responses usually say when to come
                # back; honoring it beats hammering a throttling endpoint
                # with the fixed-ladder backoff
                if e.code in (429, 503):
                    retry_after = _retry_after_seconds(e.headers)
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                last = e
            if attempt < self.max_retries:
                delay = (retry_after if retry_after is not None
                         else 0.5 * (attempt + 1))
                # always capped by the overall deadline: a server asking
                # for an hour gets whatever budget is actually left
                time.sleep(min(delay, max(0.0, t_end - time.monotonic())))
            retry_after = None
        raise last


class FakeLLM:
    """Deterministic offline "LLM": emits logic blocks from a grammar of
    scheduling heuristics (packing pressure, fragmentation avoidance,
    balance, GPU tightness), occasionally emitting junk to exercise the
    validate/reject path the way real LLM output does."""

    _TERMS = (
        "(node.cpu_milli_left - pod.cpu_milli) / max(1, node.cpu_milli_total)",
        "(node.memory_mib_left - pod.memory_mib) / max(1, node.memory_mib_total)",
        "(node.gpu_left - pod.num_gpu) / max(1, len(node.gpus))",
        "node.cpu_milli_left / max(1, node.cpu_milli_total)",
        "node.memory_mib_left / max(1, node.memory_mib_total)",
        "sum(gpu.gpu_milli_left for gpu in node.gpus) / max(1, 1000 * len(node.gpus))",
        "sum(1 for gpu in node.gpus if gpu.gpu_milli_left >= pod.gpu_milli)"
        " / max(1, len(node.gpus))",
    )
    _JUNK = (
        "score = untrusted_helper(pod)",
        "import os\n    score = 1",
        "while node.gpu_left > 0:\n        score = 1",
    )

    def __init__(self, seed: int = 0, junk_rate: float = 0.1):
        self._rng = random.Random(seed)
        self._junk_rate = junk_rate
        self._lock = threading.Lock()

    def getstate(self):
        """Serializable generator state (checkpointed by the evolution
        driver so hermetic runs resume bit-identically)."""
        kind, internal, gauss = self._rng.getstate()
        return [kind, list(internal), gauss]

    def setstate(self, obj) -> None:
        kind, internal, gauss = obj
        self._rng.setstate((kind, tuple(internal), gauss))

    def complete(self, prompt: str) -> str:  # noqa: ARG002 — prompt unused
        with self._lock:
            rng = self._rng
            if rng.random() < self._junk_rate:
                return rng.choice(self._JUNK)
            n = rng.randint(1, 3)
            terms = rng.sample(self._TERMS, n)
            coeffs = [round(rng.uniform(-2.0, 2.0), 3) for _ in terms]
            expr = " + ".join(f"({c}) * ({t})" for c, t in zip(coeffs, terms))
            lines = [f"score = 10000 * (1.0 + {expr})"]
            if rng.random() < 0.5:
                lines.append("if pod.num_gpu > 0:")
                lines.append(f"        score = score * {round(rng.uniform(0.8, 1.2), 3)}")
            return "\n    ".join(lines)


class CandidateGenerator:
    """Backend + template + validation = candidate factory (reference:
    safe_execution.py:283-317 ``generate_policy``): returns a full validated
    candidate source, or None on any failure."""

    def __init__(self, backend: TextBackend, smoke: bool = True):
        self.backend = backend
        self.smoke = smoke

    def generate(self, parents: Sequence[Parent], feedback: str = "") -> Optional[str]:
        try:
            logic = self.backend.complete(template.build_prompt(parents, feedback))
        except Exception:  # noqa: BLE001 — network/API errors -> skip
            return None
        if not logic:
            return None
        code = template.fill_template(_strip_fences(logic))
        if not sandbox.validate(code):
            return None
        try:
            transpiler.transpile(code)  # the third validation stage
        except transpiler.TranspileError:
            return None
        if self.smoke and sandbox.smoke_test(code) is not None:
            return None
        return code


def _strip_fences(text: str) -> str:
    """Real LLMs wrap output in ``` fences despite instructions; unwrap."""
    t = text.strip()
    if t.startswith("```"):
        lines = t.splitlines()
        lines = lines[1:]
        if lines and lines[-1].strip().startswith("```"):
            lines = lines[:-1]
        t = "\n".join(lines).strip()
    return t


def generate_many(gen: CandidateGenerator, n: int,
                  sample_parents: Callable[[], Sequence[Parent]],
                  feedback: str = "", max_workers: int = 8) -> List[str]:
    """Thread-pool fan-out of n generation attempts (reference:
    funsearch_integration.py:512-525); failures are dropped, so the result
    may be shorter than n."""
    out: List[str] = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = [ex.submit(gen.generate, sample_parents(), feedback)
                for _ in range(n)]
        # collect in submission order (not as_completed): result order — and
        # therefore population order and dedup outcomes — stays deterministic
        for f in futs:
            code = f.result()
            if code is not None:
                out.append(code)
    return out
