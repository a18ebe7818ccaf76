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

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fks_tpu_torch.ops.numerics import fma_f32, trunc_to_int32
from fks_tpu_torch.sim.types import NodeView, PodView, PolicyFn

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


#: the kernel's fields in its argument order: the views, weights, output
_FIELDS = _POD_FIELDS + _NODE_FIELDS + _GPU_FIELDS + ("weights", "out")
#: a block's threads and shared bytes at most (param_score.cu kMaxThreads,
#: kMaxSmem: the default dynamic shared-memory limit, so the launch sets no
#: attribute)
KERNEL_MAX_THREADS = 256
KERNEL_SMEM_BYTES = 48 * 1024
#: lane x node cells a block scores (one warp per lane and 16 nodes)
_BLOCK_CELLS = KERNEL_MAX_THREADS // 2
#: the kernel's offsets are 32-bit
_MAX_OFFSET = 2**31


class ScoreGeometry(NamedTuple):
    """How ``csrc/param_score.cu`` covers ``[L, N]``: a grid of (node
    tile, lane tile) blocks with two threads per (lane, node) cell of a
    block's tile (in the load round the first half load the cells' node
    fields, the second half their GPU rows; then one warp scores each lane
    and 16 nodes), and the block's shared memory, which holds every input
    of the tile (``offsets``: each field's staged tile, in bytes)."""

    grid: Tuple[int, int]  # (node tiles, lane tiles)
    threads: int
    lanes_per_block: int
    node_tile: int
    gpu_cols: int  # staged GPU columns: G as a power of two, at least 8
    row_stride: int  # staged int GPU row, in words (gpu_cols + 4)
    shared: int  # bit f: field f is staged once for the block's lanes
    offsets: Tuple[int, ...]  # per field of _FIELDS
    smem_bytes: int


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


@functools.lru_cache(maxsize=256)
def launch_geometry(lanes: int, n: int, g: int, weight_bytes: int = 4,
                    shared: int = 0) -> ScoreGeometry:
    """The kernel's launch for ``lanes`` x ``n`` nodes of ``g`` GPUs, with
    the fields whose bits are set in ``shared`` (lane stride 0) staged
    once per block. A block scores up to 128 lane x node cells with two
    threads each: 8 lanes x 16 nodes when ``n <= 16`` (the main path: the
    lanes share the cluster's totals), else up to 4 lanes x 32 nodes,
    fewer lanes widening the node tile (one lane: 128 nodes)."""
    if n <= 16:
        node_tile, lpb = 16, min(_pow2(lanes), 8)
    else:
        lpb = min(_pow2(lanes), 4)
        node_tile = min(_pow2(n), _BLOCK_CELLS // lpb)
    cols = max(8, _pow2(g))
    row = cols + 4
    sizes = []
    for f, name in enumerate(_FIELDS):
        rows = 1 if (shared >> f) & 1 else lpb
        if f == 0:
            size = 16 * lpb  # the four pod fields, [LB][4] int32
        elif name in _POD_FIELDS or name == "out":
            size = 0
        elif name == "weights":
            size = 16 * lpb * weight_bytes
        elif name == "node_mask":
            size = rows * node_tile
        elif name in _NODE_FIELDS:
            size = 4 * rows * node_tile
        elif name == "gpu_mask":
            size = rows * node_tile * cols
        else:
            size = 4 * rows * node_tile * row
        sizes.append(size)
    offsets, end = [], 0
    for size in sizes:
        offsets.append(end if size else 0)
        end += -(-size // 16) * 16
    return ScoreGeometry(
        grid=(-(-n // node_tile), -(-lanes // lpb)),
        threads=2 * lpb * node_tile, lanes_per_block=lpb,
        node_tile=node_tile, gpu_cols=cols, row_stride=row, shared=shared,
        offsets=tuple(offsets), smem_bytes=end)


def _strides(x: torch.Tensor):
    """The kernel's (lane, node, GPU) element strides of view x; a
    dimension of size 1 gets stride 0, so a one-lane field is shared."""
    s = [st if sz > 1 else 0 for sz, st in zip(x.shape, x.stride())]
    return (s + [0, 0, 0])[:3]


def _check_extents(named) -> None:
    """Raise ``ValueError`` naming every view the kernel's 32-bit offsets
    cannot reach: its last element lies 2**31 elements or more past its
    first."""
    wide = [name for name, x in named
            if x.numel() and sum((sz - 1) * st for sz, st in
                                 zip(x.shape, x.stride())) >= _MAX_OFFSET]
    if wide:
        raise ValueError(f"param_score: {', '.join(wide)} span 2**31 "
                         f"elements or more; the kernel's offsets are "
                         f"32-bit")


def _vector_fields(named, g: int) -> int:
    """Bits of the GPU fields whose rows the kernel loads 4 elements at a
    time: G a staged column count (8, 16 or 32), contiguous GPU columns,
    the lane and node strides multiples of 4, and the address aligned to
    the load (16 bytes for int32, 4 for the mask's bytes)."""
    bits = 0
    for f, (name, x) in enumerate(named):
        if name not in _GPU_FIELDS:
            continue
        s = _strides(x)
        align = 4 * x.element_size()
        if (g in (8, 16, 32) and s[2] == 1 and s[1] % 4 == 0
                and s[0] % 4 == 0 and x.data_ptr() % align == 0):
            bits |= 1 << f
    return bits


def _score_block(params, pod: PodView, nodes: NodeView, dtype):
    """``(block, geometry, out)``: the kernel's argument block for these
    views (csrc/param_score.cu, ``fks_param_score``), its geometry and the
    new i32[L, N] output it writes. Raises ``ValueError`` on what the
    kernel does not take."""
    views, w, lanes, n, g = _kernel_views(params, pod, nodes, dtype)
    dev = pod.cpu_milli.device
    for x in (*views, w):
        if x.device != dev:
            raise ValueError(f"param_score views span devices ({x.device}, "
                             f"{dev})")
    out = torch.empty((lanes, n), dtype=torch.int32, device=dev)
    named = list(zip(_FIELDS, (*views, w, out)))
    _check_extents(named)
    if lanes * n >= _MAX_OFFSET:
        raise ValueError(f"param_score: {lanes} lanes x {n} nodes reach "
                         f"2**31 scores")
    shared = sum(1 << f for f, (name, x) in enumerate(named)
                 if name != "out" and _strides(x)[0] == 0)
    geo = launch_geometry(lanes, n, g, w.element_size(), shared)
    if geo.grid[1] > 65535:
        raise ValueError(f"param_score: {geo.grid[1]} lane tiles exceed "
                         f"the grid's 65,535")
    block = [x.data_ptr() for _, x in named]
    for _, x in named:
        block += _strides(x)
    block += [lanes, n, g, *geo.grid, geo.threads,
              geo.lanes_per_block.bit_length() - 1,
              geo.node_tile.bit_length() - 1, geo.gpu_cols.bit_length() - 1,
              geo.row_stride, geo.smem_bytes, shared,
              _vector_fields(named, g), *geo.offsets]
    return block, geo, out


def _launch_score(params, pod: PodView, nodes: NodeView, dtype):
    """``csrc/param_score.cu`` on the current stream: i32[L, N]."""
    import ctypes

    from fks_tpu_torch.ops import _ext

    block, _, out = _score_block(params, pod, nodes, dtype)
    lib = _ext.param_score_library()
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fks_param_score((ctypes.c_longlong * len(block))(*block),
                                  torch.finfo(dtype).bits // 8, stream)
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


def as_policy(params, dtype=torch.float32) -> PolicyFn:
    """Close over a concrete weight vector: a zoo-compatible PolicyFn
    (fks_tpu.models.parametric.as_policy). ``params`` is a tensor, a
    numpy array or a list of floats (kept in its own precision until
    ``score`` casts it to ``dtype``). The weights are copied to a device
    once, at the policy's first call there: a step's first run is eager
    (``sim.engine.GraphedChunk`` warms up before it captures), so no
    copy lands in a captured graph."""
    w = (params if isinstance(params, torch.Tensor)
         else torch.as_tensor(np.asarray(params)))
    placed = {}

    def policy(pod: PodView, nodes: NodeView) -> torch.Tensor:
        dev = pod.cpu_milli.device
        if dev not in placed:
            placed[dev] = w.to(dev)
        return score(placed[dev], pod, nodes, dtype)

    return policy


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
