"""Parametric scheduling policies: a fixed feature basis + weight vector.

Port of fks_tpu.models.parametric. A candidate is a weight vector over 16
placement features; a population is ``params[L, 16]``, one row per lane.
The score contract is the reference template's: infeasible nodes score 0,
feasible nodes ``max(1, int(f @ w * SCORE_SCALE))``.

Bit-exactness notes (integer placements hang on ``trunc``, so one flipped
float snowballs through a run):

- every feature is computed in the order of operations XLA's CPU backend
  gives fks_tpu's ``features`` when the node state arrives as run-time
  values (the engine's loop state) — the fused kernel,
  csrc/fused_sim.cu, repeats it:
  - divisions by node totals are IEEE divisions, by a tensor (PyTorch's
    CUDA ``x / c`` with a Python scalar c multiplies by 1/c instead);
  - ``x / 1000.0`` becomes ``x * float32(1/1000)`` (XLA's rewrite of a
    division by a literal);
  - ``best_fit`` is ``1 - fma(rem_gpu, 0.34, fma(rem_cpu, 0.33,
    rem_mem * 0.33))`` (LLVM contracts the chain into two fused
    multiply-adds);
- the 16-term sum follows the order XLA's CPU dot uses for ``f @ w`` in
  float32 — eight accumulator lanes (lane j holds product j, then adds
  product j + 8 with one fused multiply-add), then an adjacent-pairs tree
  over the lanes.

In float64 the same expressions run without the fused steps (fks_tpu's
float64 scores agree to ~1e-13 relative, not bit for bit). When fks_tpu
jit-compiles a workload as a constant, XLA also turns the divisions by
node totals into multiplications by their reciprocals; those features
then differ from the run-time-value form by an ulp (ROADMAP queue 3).

``render_code`` turns a weight vector into candidate source for the code
tier (``funsearch.transpiler``, ``funsearch.vm``).
"""
from __future__ import annotations

import torch

from fks_tpu_torch.ops.numerics import fma_f32, trunc_to_int32
from fks_tpu_torch.sim.types import NodeView, PodView

#: Names of the feature basis, in order (append-only: checkpoints store
#: weights positionally).
FEATURE_NAMES = (
    "bias",
    "rem_cpu_frac",      # (cpu_left - pod.cpu) / cpu_total
    "rem_mem_frac",      # (mem_left - pod.mem) / mem_total
    "rem_gpu_frac",      # (gpu_left - pod.ngpu) / num_gpus
    "cpu_util",          # used fraction before placement
    "mem_util",
    "gpu_count_util",
    "gpu_milli_util",    # node-level milli used fraction
    "balance",           # 1 - |cpu_util - mem_util|
    "frag_mod",          # (free_milli % pod.gpu_milli) / 1000, gpu pods only
    "eligible_frac",     # eligible GPUs / num_gpus for this pod
    "pod_is_gpu",
    "node_has_gpu",
    "best_fit",          # 1 - weighted normalized remaining
    "gpu_imbalance",     # (max - min free milli) / 1000
    "headroom",          # 1 if node has > 2x the pod's cpu AND mem free
)

NUM_FEATURES = len(FEATURE_NAMES)

#: Raw dot product is scaled by this before int truncation.
SCORE_SCALE = 10_000.0

SEED_NAMES = ("first_fit", "best_fit", "worst_fit", "packing")

# float32 constants as exact Python floats: 0.33 and 0.34 (best_fit's
# fma_f32 operands) and float32(1/1000) (what XLA multiplies by for / 1000)
_K33 = float(torch.tensor(0.33, dtype=torch.float32))
_K34 = float(torch.tensor(0.34, dtype=torch.float32))
_INV1000 = float(torch.tensor(1.0) / torch.tensor(1000.0))


def _basis(pod: PodView, nodes: NodeView, dtype):
    """(features 0-7, features 8-15, feasible): f[L, N, 8] twice and
    bool[L, N]. The int-over-int ratios are converted and divided as one
    stacked tensor (the same elementwise operations as one at a time, in
    far fewer PyTorch calls)."""
    d = dtype
    gm = nodes.gpu_mask
    gml = nodes.gpu_milli_left
    cl, ml, gl = (nodes.cpu_milli_left, nodes.memory_mib_left,
                  nodes.gpu_left)
    ngpus = nodes.num_gpus.clamp(min=1)
    i32 = torch.int32  # int sums stay int32 (torch widens to int64)
    masked = torch.where(gm, gml, 0)
    free_milli = masked.sum(dim=-1, dtype=i32)
    gmax = masked.amax(dim=-1)
    gmin = torch.where(gm, gml, 2**30).amin(dim=-1)
    eligible = (gm & (gml >= pod.gpu_milli[..., None])).sum(dim=-1,
                                                             dtype=i32)
    num = torch.stack([cl - pod.cpu_milli, ml - pod.memory_mib,
                       gl - pod.num_gpu, cl, ml, gl, free_milli, eligible,
                       torch.remainder(free_milli,
                                       pod.gpu_milli.clamp(min=1)),
                       gmax - torch.minimum(gmin, gmax)], dim=-1).to(d)
    milli_tot = torch.where(gm, nodes.gpu_milli_total, 0).sum(
        dim=-1, dtype=i32).clamp(min=1)
    den = torch.stack([nodes.cpu_milli_total.clamp(min=1),
                       nodes.memory_mib_total.clamp(min=1), ngpus,
                       milli_tot], dim=-1).to(d)
    # denominators cpu, mem, gpus, cpu, mem, gpus, milli, gpus (slices, not
    # an index list: a host-made index cannot enter a captured CUDA graph)
    q = num[..., :8] / torch.cat([den[..., 0:3], den[..., 0:3],
                                  den[..., 3:4], den[..., 2:3]],
                                 dim=-1)  # [L, N, 8]
    # x / 1000.0 -> x * float32(1/1000), as XLA compiles it
    milli = num[..., 8:] * (_INV1000 if d == torch.float32 else 1 / 1000)
    rem_cpu, rem_mem, rem_gpu = q[..., 0], q[..., 1], q[..., 2]
    util = 1 - q[..., 3:7]  # cpu, mem, gpu count, gpu milli
    pod_gpu = pod.num_gpu > 0  # [L, 1]
    has_gpu = nodes.num_gpus > 0  # [N]
    if d == torch.float32:
        best_fit = 1 - fma_f32(rem_gpu, _K34, fma_f32(rem_cpu, _K33,
                                                      rem_mem * _K33))
    else:
        best_fit = 1 - (rem_cpu * 0.33 + rem_mem * 0.33 + rem_gpu * 0.34)
    flags = torch.stack([
        pod_gpu.expand_as(cl), has_gpu.expand_as(cl),
        (cl > pod.cpu_milli * 2) & (ml > pod.memory_mib * 2)],
        dim=-1).to(d)  # pod_is_gpu, node_has_gpu, headroom
    lo = torch.cat([torch.ones_like(q[..., :1]), q[..., 0:3], util], dim=-1)
    hi = torch.stack([
        1 - (util[..., 0] - util[..., 1]).abs(),  # balance
        milli[..., 0] * flags[..., 0],  # frag_mod (>= 0: x * 0 == 0.0)
        q[..., 7],  # eligible_frac
        flags[..., 0], flags[..., 1], best_fit,
        milli[..., 1] * flags[..., 1],  # gpu_imbalance (>= 0)
        flags[..., 2]], dim=-1)
    feasible = (nodes.node_mask & (pod.cpu_milli <= cl)
                & (pod.memory_mib <= ml) & (pod.num_gpu <= gl)
                & (~pod_gpu | (eligible >= pod.num_gpu)))
    return lo, hi, feasible


def features(pod: PodView, nodes: NodeView,
             dtype=torch.float32) -> torch.Tensor:
    """Feature tensor f[L, N, F] for each lane's pod against all nodes."""
    lo, hi, _ = _basis(pod, nodes, dtype)
    return torch.cat([lo, hi], dim=-1)


def _dot(lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum of ``[lo, hi] * w`` over the 16 features in XLA's CPU order
    (module docstring); lo, hi f[..., 8], w [..., 16] broadcastable."""
    acc = lo * w[..., :8]
    if lo.dtype == torch.float32:
        acc = fma_f32(hi, w[..., 8:], acc)
    else:
        acc = acc + hi * w[..., 8:]
    acc = acc[..., 0::2] + acc[..., 1::2]
    acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0] + acc[..., 1]


def raw_score(params, pod: PodView, nodes: NodeView, dtype=torch.float32):
    """``f @ w * SCORE_SCALE`` before truncation, f[L, N]. ``params`` is
    [L, F] (one weight row per lane) or [F] (shared)."""
    lo, hi, _ = _basis(pod, nodes, dtype)
    return _dot(lo, hi, params.to(dtype)[..., None, :]) * SCORE_SCALE


def score_plain(params, pod: PodView, nodes: NodeView,
                dtype=torch.float32):
    """The plain PyTorch version of ``score`` (and of its kernel,
    csrc/param_score.cu): ``max(1, int(f @ w * SCALE))`` under
    feasibility (zoo.feasible_mask), i32[L, N]."""
    lo, hi, feasible = _basis(pod, nodes, dtype)
    raw = _dot(lo, hi, params.to(dtype)[..., None, :]) * SCORE_SCALE
    return torch.where(feasible, trunc_to_int32(raw).clamp(min=1), 0)


#: the views the kernel reads, in its argument order (param_score.cu
#: ``Field``): pod fields [L, 1], node fields [L, N], GPU fields [L, N, G]
_POD_FIELDS = ("cpu_milli", "memory_mib", "num_gpu", "gpu_milli")
_NODE_FIELDS = ("cpu_milli_left", "cpu_milli_total", "memory_mib_left",
                "memory_mib_total", "gpu_left", "num_gpus", "node_mask")
_GPU_FIELDS = ("gpu_milli_left", "gpu_milli_total", "gpu_mask")
_MASKS = ("node_mask", "gpu_mask")
#: GPUs per node the kernel takes (its mask bits are one 32-bit word)
KERNEL_MAX_GPUS = 32


def _kernel_views(params, pod: PodView, nodes: NodeView, dtype):
    """The kernel's inputs as strided views of the caller's tensors, every
    one expanded to the lane count L (a shared ``[N]`` field keeps lane
    stride 0): ``(views, weights, L, N, G)``. Nothing is copied but the
    weights' cast to ``dtype`` (a no-op for float32 weights in float32).
    Raises ``ValueError`` on what the kernel does not take."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"param_score computes float32 or float64, not "
                         f"{dtype}")
    n = int(nodes.cpu_milli_left.shape[-1])
    g = int(nodes.gpu_milli_left.shape[-1])
    if g > KERNEL_MAX_GPUS:
        raise ValueError(f"param_score takes at most {KERNEL_MAX_GPUS} GPUs "
                         f"per node, got {g}")
    w = params.to(dtype)
    if w.dim() not in (1, 2) or w.shape[-1] != NUM_FEATURES:
        raise ValueError(f"params must be [L, {NUM_FEATURES}] or "
                         f"[{NUM_FEATURES}], got {tuple(w.shape)}")
    lead = [x.shape[0] for x in (*(getattr(pod, f) for f in _POD_FIELDS),
                                 nodes.cpu_milli_left, nodes.gpu_left)]
    if w.dim() == 2:
        lead.append(w.shape[0])
    lanes = max(lead)
    views = []
    for name in _POD_FIELDS:
        views.append((name, getattr(pod, name), (lanes, 1)))
    for name in _NODE_FIELDS:
        views.append((name, getattr(nodes, name), (lanes, n)))
    for name in _GPU_FIELDS:
        views.append((name, getattr(nodes, name), (lanes, n, g)))
    out = []
    for name, x, shape in views:
        want = torch.bool if name in _MASKS else torch.int32
        if x.dtype != want:
            raise ValueError(f"param_score reads {name} as {want}, got "
                             f"{x.dtype}")
        if x.dim() > len(shape) or x.dim() < len(shape) - 1:
            raise ValueError(f"param_score: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        out.append(x.expand(shape))
    return out, w.expand(lanes, NUM_FEATURES), lanes, n, g


def _launch_score(params, pod: PodView, nodes: NodeView, dtype):
    """``csrc/param_score.cu`` on the current stream: i32[L, N]."""
    import ctypes

    from fks_tpu_torch.ops import _ext

    views, w, lanes, n, g = _kernel_views(params, pod, nodes, dtype)
    dev = pod.cpu_milli.device
    for x in (*views, w):
        if x.device != dev:
            raise ValueError(f"param_score views span devices ({x.device}, "
                             f"{dev})")
    out = torch.empty((lanes, n), dtype=torch.int32, device=dev)

    def strides(x):
        s = list(x.stride()) + [0] * (3 - x.dim())
        return s[:3]

    block = [x.data_ptr() for x in (*views, w, out)]
    for x in (*views, w, out):
        block += strides(x)
    block += [lanes, n, g]
    lib = _ext.param_score_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fks_param_score((ctypes.c_longlong * len(block))(*block),
                                  w.element_size(), stream)
    if err != 0:
        raise RuntimeError(
            f"param_score kernel launch failed: CUDA error {err} "
            f"({lib.fks_cuda_error_string(err).decode()})")
    score.launches += 1
    return out


def score(params, pod: PodView, nodes: NodeView, dtype=torch.float32):
    """Parametric policy: ``max(1, int(f @ w * SCALE))`` under
    feasibility (zoo.feasible_mask), i32[L, N]. On CUDA tensors one
    launch of ``csrc/param_score.cu`` (counted in ``score.launches``),
    which raises rather than fall back; on CPU tensors the plain version,
    ``score_plain``."""
    if pod.cpu_milli.is_cuda:
        return _launch_score(params, pod, nodes, dtype)
    return score_plain(params, pod, nodes, dtype)


score.launches = 0  # kernel launches (CUDA only), reset by callers


# ----------------------------------------------------------- seed weights

def seed_weights(name: str) -> torch.Tensor:
    """Hand-picked weight vectors in the spirit of the reference baselines
    (funsearch_integration.py:217-269). f32[F] on the CPU."""
    w = {n: 0.0 for n in FEATURE_NAMES}
    if name == "first_fit":
        w["bias"] = 0.1  # constant 1000 for every feasible node
    elif name == "best_fit":
        w["best_fit"] = 1.0
    elif name == "worst_fit":
        w["best_fit"] = -1.0
        w["bias"] = 1.0
    elif name == "packing":
        w["best_fit"] = 0.6
        w["gpu_milli_util"] = 0.3
        w["frag_mod"] = -0.2
        w["balance"] = 0.1
    else:
        raise KeyError(name)
    return torch.tensor([w[n] for n in FEATURE_NAMES], dtype=torch.float32)


def population_from_normal(z: torch.Tensor, noise: float = 0.1):
    """Seeds + ``noise * z`` jitter for standard-normal draws z[P, F]: the
    first four rows stay the pure seeds. ``init_population`` draws z from
    a generator; tests pass fixed draws."""
    seeds = torch.stack([seed_weights(n) for n in SEED_NAMES]).to(z.device)
    pop = z.shape[0]
    reps = (pop + seeds.shape[0] - 1) // seeds.shape[0]
    base = seeds.repeat(reps, 1)[:pop]
    keep = torch.arange(pop, device=z.device) < seeds.shape[0]
    return torch.where(keep[:, None], base, base + noise * z)


def init_population(generator: torch.Generator, pop_size: int,
                    noise: float = 0.1) -> torch.Tensor:
    """The t=0 population for parametric evolution, f32[pop, F] on the
    generator's device."""
    z = torch.randn((pop_size, NUM_FEATURES), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return population_from_normal(z, noise)


def mutate_from(parents: torch.Tensor, idx: torch.Tensor, z: torch.Tensor,
                noise: float = 0.05) -> torch.Tensor:
    """Offspring ``parents[idx] + noise * z`` for explicit parent indices
    and standard-normal draws (the deterministic half of ``mutate``)."""
    return parents[idx] + noise * z


def mutate(generator: torch.Generator, parents: torch.Tensor, pop_size: int,
           noise: float = 0.05) -> torch.Tensor:
    """Offspring = random parent + Gaussian noise (gradient-free step)."""
    idx = torch.randint(0, parents.shape[0], (pop_size,),
                        generator=generator, device=generator.device)
    z = torch.randn((pop_size, parents.shape[1]), generator=generator,
                    device=generator.device, dtype=parents.dtype)
    return mutate_from(parents, idx.to(parents.device), z.to(parents.device),
                       noise)


# ------------------------------------------------- weights -> candidate code

#: Restricted-Python rendering of each feature, in FEATURE_NAMES order.
#: The expressions use only the transpilable subset (and the reference's
#: whitelisted builtins, safe_execution.py:19-27), so a rendered candidate
#: flows through the normal code path: sandbox -> transpiler -> engine.
_FEATURE_EXPRS = (
    "1.0",
    "(node.cpu_milli_left - pod.cpu_milli) / max(1, node.cpu_milli_total)",
    "(node.memory_mib_left - pod.memory_mib) / max(1, node.memory_mib_total)",
    "(node.gpu_left - pod.num_gpu) / max(1, len(node.gpus))",
    "1.0 - node.cpu_milli_left / max(1, node.cpu_milli_total)",
    "1.0 - node.memory_mib_left / max(1, node.memory_mib_total)",
    "1.0 - node.gpu_left / max(1, len(node.gpus))",
    "1.0 - free_milli / max(1, total_milli)",
    "1.0 - abs(node.cpu_milli_left / max(1, node.cpu_milli_total)"
    " - node.memory_mib_left / max(1, node.memory_mib_total))",
    "((free_milli % max(1, pod.gpu_milli)) / 1000.0) if pod.num_gpu > 0 else 0.0",
    "sum(1 for gpu in node.gpus if gpu.gpu_milli_left >= pod.gpu_milli)"
    " / max(1, len(node.gpus))",
    "1.0 if pod.num_gpu > 0 else 0.0",
    "1.0 if len(node.gpus) > 0 else 0.0",
    "1.0 - (0.33 * (node.cpu_milli_left - pod.cpu_milli) / max(1, node.cpu_milli_total)"
    " + 0.33 * (node.memory_mib_left - pod.memory_mib) / max(1, node.memory_mib_total)"
    " + 0.34 * (node.gpu_left - pod.num_gpu) / max(1, len(node.gpus)))",
    "((max(gpu.gpu_milli_left for gpu in node.gpus)"
    " - min(gpu.gpu_milli_left for gpu in node.gpus)) / 1000.0)"
    " if len(node.gpus) > 0 else 0.0",
    "1.0 if (node.cpu_milli_left > 2 * pod.cpu_milli"
    " and node.memory_mib_left > 2 * pod.memory_mib) else 0.0",
)

#: features whose expression reads the free/total gpu_milli prologue vars
_NEEDS_MILLI = {"gpu_milli_util", "frag_mod"}


def render_code(params, threshold: float = 1e-4) -> str:
    """Render a weight vector as a reference-style candidate source
    (fks_tpu.models.parametric.render_code, the same string): the bridge
    from the parametric search back into the code population. The
    rendered candidate re-enters through the sandbox and transpiler and is
    re-scored there, so rendering need not be bit-exact to the float32
    parametric arithmetic (and is not). Near-zero weights are dropped."""
    from fks_tpu_torch.funsearch import template

    w = torch.as_tensor(params).to(torch.float64).cpu().tolist()
    terms = []
    needs_milli = False
    for name, expr, wi in zip(FEATURE_NAMES, _FEATURE_EXPRS, w):
        if abs(wi) < threshold:
            continue
        terms.append(f"({wi:.6g}) * ({expr})")
        if name in _NEEDS_MILLI:
            needs_milli = True
    if not terms:
        terms = ["0.0"]
    lines = []
    if needs_milli:
        lines.append("free_milli = sum(gpu.gpu_milli_left for gpu in node.gpus)")
        lines.append(
            "total_milli = sum(gpu.gpu_milli_total for gpu in node.gpus)")
    body = "\n    + ".join(terms)
    lines.append(f"score = {SCORE_SCALE:.1f} * ({body})")
    return template.fill_template("\n".join("    " + l if i else l
                                            for i, l in enumerate(lines)))
