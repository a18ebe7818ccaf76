"""The parametric policy's node scores, in plain NumPy.

A candidate is a weight vector over 16 placement features; a node that
cannot take the pod scores 0 and one that can scores
``max(1, trunc(sum_f feature_f * w_f * 10000))``. The features and their
order of operations are the ones the configuration states for float32
(``FEATURES`` below): divisions by node totals are IEEE divisions, ``x /
1000`` is ``x * float32(1 / 1000)``, ``best_fit`` is two fused
multiply-adds, and the 16-term sum takes eight products, adds the other
eight by fused multiply-adds and then sums adjacent pairs.

``precision="bfloat16"`` rounds the weights, every feature and every
intermediate result to bfloat16 instead: the benchmark's control, the
reference one precision below the configuration's.
"""
from __future__ import annotations

import math

import numpy as np

FEATURES = ("bias", "rem_cpu_frac", "rem_mem_frac", "rem_gpu_frac",
            "cpu_util", "mem_util", "gpu_count_util", "gpu_milli_util",
            "balance", "frag_mod", "eligible_frac", "pod_is_gpu",
            "node_has_gpu", "best_fit", "gpu_imbalance", "headroom")
SCALE = 10_000.0
F32 = np.float32
K33, K34 = float(F32(0.33)), float(F32(0.34))
INV1000 = float(F32(1.0) / F32(1000.0))
I32_MAX_F32 = 2147483520.0  # the largest float32 below 2**31
_LOW29, _HALF29 = (1 << 29) - 1, 1 << 28


def fma_f32(a, b, c):
    """Correctly rounded float32 ``a * b + c``. The product of two float32
    values is exact in float64, so the float64 sum has one rounding;
    rounding it to float32 again goes wrong only where it sits exactly
    halfway between two float32 values while the exact sum does not.
    There the sum's exact error (TwoSum) says which way the exact sum
    lies, and the sum moves one float64 step toward it."""
    p = np.multiply(a, b, dtype=np.float64)
    cd = np.asarray(c, np.float64)
    s = p + cd
    tie = (s.view(np.int64) & _LOW29) == _HALF29
    if tie.any():
        bb = s - p
        err = (p - (s - bb)) + (cd - bb)
        tie &= err != 0
        s = np.where(tie, np.nextafter(s, np.copysign(math.inf, err)), s)
    return s.astype(F32)


def to_bf16(x):
    """Round float32 values to the nearest bfloat16 (ties to even), kept
    in float32 storage."""
    x = np.asarray(x, F32)
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


class Arith:
    """Float arithmetic of one precision: float32, or bfloat16 carried in
    float32 with a rounding after every operation."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.r = to_bf16 if precision == "bfloat16" else (
            lambda x: np.asarray(x, F32))

    def f(self, x):
        return self.r(np.asarray(x).astype(F32))

    def fma(self, a, b, c):
        return self.r(fma_f32(a, b, c))

    def __call__(self, x):
        return self.r(x)


class Scorer:
    """Node scores for fixed weights and a fixed cluster: what depends on
    neither the pod nor the cluster's state is worked out once."""

    def __init__(self, w, node_total, gmt, gm, ar: Arith):
        ct, mt, ngpus = (np.asarray(x) for x in node_total)
        milli_tot = np.maximum(np.where(gm, gmt, 0).sum(axis=-1), 1)
        ct1, mt1, ng1 = (np.maximum(x, 1) for x in (ct, mt, ngpus))
        self.ar, self.gm = ar, gm
        self.den = ar.f(np.stack([ct1, mt1, ng1, ct1, mt1, ng1, milli_tot,
                                  ng1]))  # [8, N]
        self.has_gpu = ar.f(ngpus > 0)
        self.k33, self.k34 = ar.f(F32(K33)), ar.f(F32(K34))
        self.inv1000, self.scale = ar.f(F32(INV1000)), ar.f(F32(SCALE))
        w = np.asarray(w, F32).reshape(-1, len(FEATURES))
        self.w = ar.f(w).T  # [16, L]

    def __call__(self, rows, pod, cl, ml, gl, gml):
        """Scores of every node for the pods of lanes ``rows``:
        int64[len(rows), N]. ``pod`` = (cpu, mem, num_gpu, gpu_milli),
        each int[R, 1]; ``cl``, ``ml``, ``gl`` the nodes' free CPU, memory
        and GPU count [R, N]; ``gml`` the free milli of each GPU slot [R,
        N, G]. A node that cannot take the pod scores 0 whatever its
        features, so the features are computed for the (lane, node) pairs
        that can, each element by the float32 (or bfloat16) operation the
        module docstring names."""
        pcpu, pmem, pngpu, pmilli = pod
        ar, r, gm = self.ar, self.ar, self.gm
        eligible = (gm & (gml >= pmilli[..., None])).sum(axis=-1)
        pod_gpu = pngpu > 0
        feasible = ((pcpu <= cl) & (pmem <= ml) & (pngpu <= gl)
                    & (~pod_gpu | (eligible >= pngpu)))
        out = np.zeros(cl.shape, np.int64)
        li, ni = np.nonzero(feasible)
        if li.size == 0:
            return out
        c_cl, c_ml, c_gl = cl[li, ni], ml[li, ni], gl[li, ni]
        p_cpu, p_mem = pcpu[li, 0], pmem[li, 0]
        p_ngpu, p_milli = pngpu[li, 0], pmilli[li, 0]
        g_ok, g_left = gm[ni], gml[li, ni]  # [K, G]
        masked = np.where(g_ok, g_left, 0)
        free = masked.sum(axis=-1)
        gmax = masked.max(axis=-1)
        gmin = np.where(g_ok, g_left, 2 ** 30).min(axis=-1)
        # rem_cpu, rem_mem, rem_gpu, then the used fractions' complements
        # and the eligible share, each over its node total
        q = r(ar.f(np.stack([c_cl - p_cpu, c_ml - p_mem, c_gl - p_ngpu,
                             c_cl, c_ml, c_gl, free, eligible[li, ni]]))
              / self.den[:, ni])
        util = r(1 - q[3:7])
        milli = r(ar.f(np.stack([free % np.maximum(p_milli, 1),
                                 gmax - np.minimum(gmin, gmax)]))
                  * self.inv1000)
        f_pod = ar.f(p_ngpu > 0)
        f_has = self.has_gpu[ni]
        f_head = ar.f((c_cl > p_cpu * 2) & (c_ml > p_mem * 2))
        best_fit = r(1 - ar.fma(q[2], self.k34, ar.fma(
            q[0], self.k33, r(q[1] * self.k33))))
        lo = np.concatenate([ar.f(np.ones((1,) + li.shape)), q[0:3], util])
        hi = np.stack([r(1 - np.abs(r(util[0] - util[1]))),
                       r(milli[0] * f_pod), q[7], f_pod, f_has, best_fit,
                       r(milli[1] * f_has), f_head])
        w = self.w[:, rows][:, li]  # [16, K]
        acc = ar.fma(hi, w[8:], r(lo * w[:8]))
        acc = r(acc[0::2] + acc[1::2])
        acc = r(acc[0::2] + acc[1::2])
        raw = r(r(acc[0] + acc[1]) * self.scale)
        val = np.clip(raw, -(2.0 ** 31), I32_MAX_F32).astype(np.int64)
        out[li, ni] = np.maximum(val, 1)
        return out
