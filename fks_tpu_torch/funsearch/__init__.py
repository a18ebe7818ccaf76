"""Policy search: the FunSearch evolution loop and its parts — the
sandbox, the template, the transpiler, the VM, the LLM backends, the
code-candidate evaluator, the eval-budget rungs and device-resident
parametric evolution. Port of fks_tpu.funsearch, the same public names.
"""
from fks_tpu_torch.funsearch.backend import CodeEvaluator, EvalRecord
from fks_tpu_torch.funsearch.budget import (
    BudgetConfig, BudgetedSuiteEval, probe_sim_config,
)
from fks_tpu_torch.funsearch.device_evolution import (
    DeviceGenStats, ParametricEvolution,
)
from fks_tpu_torch.funsearch.evolution import (
    EvolutionConfig, FunSearch, GenerationStats, LLMSettings, run,
)
from fks_tpu_torch.funsearch.llm import (
    CandidateGenerator, FakeLLM, OpenAIBackend, generate_many,
)
from fks_tpu_torch.funsearch.sandbox import (
    ScalarGPU, ScalarNode, ScalarPod, execute_scalar, smoke_test, validate,
)
from fks_tpu_torch.funsearch.template import (
    build_prompt, fill_template, seed_policies,
)
from fks_tpu_torch.funsearch.transpiler import (
    TranspileError, canonical_key, transpile,
)

__all__ = [
    "BudgetConfig", "BudgetedSuiteEval",
    "CandidateGenerator", "CodeEvaluator", "DeviceGenStats", "EvalRecord",
    "EvolutionConfig", "probe_sim_config",
    "FakeLLM", "FunSearch", "GenerationStats", "LLMSettings", "OpenAIBackend",
    "ParametricEvolution",
    "ScalarGPU", "ScalarNode", "ScalarPod", "TranspileError", "build_prompt",
    "canonical_key", "execute_scalar", "fill_template", "generate_many",
    "run", "seed_policies", "smoke_test", "transpile", "validate",
]
