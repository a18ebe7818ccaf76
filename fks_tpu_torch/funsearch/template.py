"""Policy template and LLM prompt construction.

Port of fks_tpu.funsearch.template (a copy: the template, the prompt and
the seed logic are byte-identical). The LLM fills only the scoring logic
inside a fixed ``priority_function(pod, node)`` skeleton whose prologue
performs the canonical feasibility gate and whose epilogue clamps to
``max(1, int(score))`` — so a feasible node can never be refused and an
infeasible node always scores 0 (the engines' strict-argmax ``> 0`` gate
depends on this, reference: simulator/main.py:104-111; template:
funsearch/safe_execution.py:171-270 ``PolicyTemplate``).

Generated logic must stay in the transpilable subset — straight-line math
and ``if``/``else`` only — because it is compiled to a branchless
masked-blend tensor program (``funsearch.transpiler``), not interpreted
per (pod, node) pair.
"""
from __future__ import annotations

from typing import Sequence, Tuple

LOGIC_PLACEHOLDER = "{evolved_logic}"

TEMPLATE = '''\
def priority_function(pod, node):
    """Score placing `pod` on `node`; higher is better, 0 refuses.

    Fields available (all integers):
      pod.cpu_milli      CPU request, thousandths of a core
      pod.memory_mib     memory request, MiB
      pod.num_gpu        number of whole GPUs required
      pod.gpu_milli      compute required on EACH requested GPU (0..1000)
      node.cpu_milli_left / node.cpu_milli_total
      node.memory_mib_left / node.memory_mib_total
      node.gpu_left      count of GPUs not yet assigned to any pod
      node.gpus          list of GPU objects on this node, each with
                         gpu.gpu_milli_left / gpu.gpu_milli_total
    """
    if pod.cpu_milli > node.cpu_milli_left:
        return 0
    if pod.memory_mib > node.memory_mib_left:
        return 0
    if pod.num_gpu > node.gpu_left:
        return 0
    if pod.num_gpu > 0:
        fitting_gpus = 0
        for gpu in node.gpus:
            if gpu.gpu_milli_left >= pod.gpu_milli:
                fitting_gpus = fitting_gpus + 1
        if fitting_gpus < pod.num_gpu:
            return 0

    score = 0.0

    {evolved_logic}

    return max(1, int(score))
'''


def fill_template(evolved_logic: str) -> str:
    """Insert the LLM-generated block at 4-space indentation (reference:
    safe_execution.py:267-270).

    The reference splices the stripped block verbatim, so continuation
    lines must already carry their own 4-space base indent (the prompt
    demands it). LLMs routinely emit the block at column 0 instead, which
    the verbatim splice turns into a SyntaxError and a wasted candidate —
    so when the verbatim fill does not parse, retry with every line after
    the first shifted to the template's 4-space base. Contract-compliant
    blocks are spliced byte-identically to the reference."""
    import ast

    logic = evolved_logic.strip()
    code = TEMPLATE.replace(LOGIC_PLACEHOLDER, logic)
    lines = logic.splitlines()
    if len(lines) == 1:
        return code
    try:
        ast.parse(code)
        return code
    except SyntaxError:
        pass
    shifted = "\n".join([lines[0]] + ["    " + l if l.strip() else l
                                      for l in lines[1:]])
    reindented = TEMPLATE.replace(LOGIC_PLACEHOLDER, shifted)
    try:
        ast.parse(reindented)
        return reindented
    except SyntaxError:
        return code  # let validation report the original form


_PREFIX, _SUFFIX = TEMPLATE.split(LOGIC_PLACEHOLDER)


def logic_of(code: str) -> str:
    """Extract the evolved block back out of a filled candidate; returns the
    whole source for non-template code. Used by near-duplicate suppression:
    comparing full candidates is meaningless when ~90% of every string is
    the shared template boilerplate (difflib ratio would exceed any sane
    threshold for ALL pairs)."""
    if code.startswith(_PREFIX) and code.endswith(_SUFFIX):
        return code[len(_PREFIX):len(code) - len(_SUFFIX)]
    return code


def _format_parents(parents: Sequence[Tuple[str, float]]) -> str:
    if not parents:
        return "(no prior policies yet)"
    out = []
    for i, (code, score) in enumerate(parents):
        out.append(f"--- parent {i + 1} (fitness {score:.4f}) ---\n{code}")
    return "\n".join(out)


def build_prompt(parents: Sequence[Tuple[str, float]],
                 feedback: str = "") -> str:
    """The codegen prompt (reference: safe_execution.py:227-254), with the
    transpilable-subset constraints spelled out."""
    return f"""\
You are evolving the scoring logic of a Kubernetes pod-scheduling policy.
The policy decides which cluster node a pod is placed on: every node is
scored and the pod goes to the highest strictly-positive score.

You must produce ONLY the logic that replaces {LOGIC_PLACEHOLDER} in the
template below. Hard constraints:
- Assign the final value to the variable `score` (a number).
- Use only: + - * / // % ** abs() min() max() sum() int() float() round(),
  math.sqrt/log/exp/pow/sin/cos/tan, comparisons, and if/else statements.
- You may loop ONLY with `for gpu in node.gpus:` to aggregate per-GPU
  statistics; no other loops, no imports, no function definitions, no
  strings, no lists, no while, no lambda.
- Guard every division so the denominator cannot be zero
  (e.g. `/ max(1, x)`).
- Indent every line with 4 spaces (8 inside an if, 12 nested, ...), because
  your block is pasted inside the function body.
- Output the raw code block only: no backticks, no prose, no blank template.

Template your block is inserted into:
{TEMPLATE}

Prior policies, best first — improve on them rather than repeating them:
{_format_parents(parents)}

Performance feedback: {feedback or "(none)"}
"""


# ------------------------------------------------------------- seed logic

#: Seed logic blocks for population initialization — the spirit of the
#: reference's active baseline factories (reference:
#: funsearch/funsearch_integration.py:217-269 first-fit + best-fit seeds),
#: expressed in the template's evolved-logic slot.
SEED_LOGIC = {
    "first_fit": "score = 1000",
    "best_fit": (
        "cpu_after = (node.cpu_milli_left - pod.cpu_milli) / max(1, node.cpu_milli_total)\n"
        "    mem_after = (node.memory_mib_left - pod.memory_mib) / max(1, node.memory_mib_total)\n"
        "    gpu_after = (node.gpu_left - pod.num_gpu) / max(1, len(node.gpus))\n"
        "    score = (1.0 - (cpu_after * 0.33 + mem_after * 0.33 + gpu_after * 0.34)) * 10000"
    ),
}


def seed_policies() -> dict:
    """name -> full candidate source for the initial population."""
    return {name: fill_template(logic) for name, logic in SEED_LOGIC.items()}
