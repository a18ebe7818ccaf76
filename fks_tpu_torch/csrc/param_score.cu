// The parametric policy's score, one launch per policy call, for Hopper
// (sm_90a).
//
// fks_tpu runs models/parametric.py::score as plain XLA, which fuses the
// feasibility mask, the 16 features, the dot product and the truncation
// into a few kernels. The port's plain PyTorch version of it
// (fks_tpu_torch/models/parametric.py::score_plain) is about 130 small
// dependent kernels on the card (its float32 fused multiply-add
// emulation), which is what priced the policy above the auto-prefilter's
// threshold. This kernel computes the same i32[L, N] scores in one launch,
// through node_score.cuh, the device code the fused simulation kernel
// (csrc/fused_sim.cu) scores nodes with.
//
// Layout: one warp per (lane, group of 16 nodes), four warps per block.
// Lanes j and j + 16 of a warp score node 16 g + j together (the
// node_score split of the features). The warp first stages its 16 nodes'
// GPU rows (free milli) into shared memory at the fused kernel's row
// stride, so node_gpu_stats reads them as the fused kernel does.
//
// Inputs are the views the engines hand a policy, read in place through
// their strides: pod fields [L, 1], node fields [L, N] or [N] (lane stride
// 0), GPU fields [L, N, G] or [N, G], weights [L, 16] or [16], as int32,
// bool (one byte) and the score dtype. Nothing is copied, so the launch
// captures inside a CUDA graph and reads whatever the step last wrote.
//
// Bound: the bytes it must move — each view read once, the scores written
// once — over the card's memory rate is a few microseconds at N = 1,000;
// below that a launch's own latency (a few microseconds) is the floor.
// The kernel does about 60 float operations per node, far below the
// card's rates: it is bound by launch latency and the warp's dependent
// chain (16 integer divisions' worth of IEEE division, two shuffles).

#include <cuda_runtime.h>
#include <stdint.h>

#include "node_score.cuh"

namespace {

using namespace fks_score;

// the view fields, in the order of the argument block
enum Field {
  kPodCpu, kPodMem, kPodNgpu, kPodMilli,          // [L, 1]
  kCpuLeft, kCpuTotal, kMemLeft, kMemTotal,       // [L, N]
  kGpuLeft, kNumGpus, kNodeMask,                  // [L, N] (mask: bool)
  kGpuMilliLeft, kGpuMilliTotal, kGpuMask,        // [L, N, G] (mask: bool)
  kWeights,                                       // [L, 16], the score dtype
  kOut,                                           // i32[L, N], contiguous
  kFields
};

constexpr int kWarps = 4;
// GPUs a node may have: the mask bits are one 32-bit word
constexpr int kMaxGpus = 32;
constexpr int kMaxRow = kMaxGpus + 1;

struct Args {
  const void* ptr[kFields];
  long long stride[kFields][3];  // lane, node, GPU strides in elements
  int L, N, G;
};

template <typename V>
__device__ __forceinline__ V at(const Args& a, int f, int l, int n = 0,
                                int k = 0) {
  const long long i = l * a.stride[f][0] + n * a.stride[f][1] +
                      k * a.stride[f][2];
  return static_cast<const V*>(a.ptr[f])[i];
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) param_score_kernel(Args a) {
  __shared__ int rows[kWarps][16 * kMaxRow];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (a.N + 15) / 16;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(a.L) * groups) return;  // whole warp
  const int l = static_cast<int>(task / groups);
  const int base = static_cast<int>(task % groups) * 16;
  const int j = lane & 15;
  const bool hi = lane >= 16;
  const bool valid = base + j < a.N;
  const int n = min(base + j, a.N - 1);
  const int G = a.G, gs = ((G + 7) & ~7) + 1;

  // the warp's 16 GPU rows, at the fused kernel's row stride
  int* row = rows[warp];
  for (int i = lane; i < 16 * gs; i += 32) {
    const int r = i / gs, k = i - r * gs;
    row[i] = k < G ? at<int>(a, kGpuMilliLeft, l, min(base + r, a.N - 1), k)
                   : 0;
  }
  const int pcpu = at<int>(a, kPodCpu, l), pmem = at<int>(a, kPodMem, l);
  const int pngpu = at<int>(a, kPodNgpu, l);
  const int pmilli = at<int>(a, kPodMilli, l);
  unsigned on = 0;
  int milli_tot = 0;
  for (int k = 0; k < G; ++k) {
    if (at<unsigned char>(a, kGpuMask, l, n, k)) {
      on |= 1u << k;
      milli_tot += at<int>(a, kGpuMilliTotal, l, n, k);
    }
  }
  __syncwarp();

  NodeStat st;
  st.n = j;
  st.cl = at<int>(a, kCpuLeft, l, n);
  st.ml = at<int>(a, kMemLeft, l, n);
  st.gl = at<int>(a, kGpuLeft, l, n);
  st.on = on;
  node_gpu_stats(st, G, gs, pmilli, row);
  st.feasible = valid && at<unsigned char>(a, kNodeMask, l, n) &&
                pcpu <= st.cl && pmem <= st.ml && pngpu <= st.gl &&
                (pngpu <= 0 || st.eligible >= pngpu);
  const int4 tv = make_int4(at<int>(a, kCpuTotal, l, n),
                            at<int>(a, kMemTotal, l, n),
                            at<int>(a, kNumGpus, l, n), milli_tot);
  T wl[4], wh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wl[i] = at<T>(a, kWeights, l, (hi ? 4 : 0) + i);
    wh[i] = at<T>(a, kWeights, l, 8 + (hi ? 4 : 0) + i);
  }
  const int s = node_score<T>(st, tv, hi, pcpu, pmem, pngpu, pmilli, wl, wh);
  if (!hi && valid)
    static_cast<int*>(const_cast<void*>(a.ptr[kOut]))
        [static_cast<long long>(l) * a.N + n] = s;
}

}  // namespace

extern "C" {

// Score L lanes' pods against their N nodes on `stream`. `block` holds
// kFields device addresses, then kFields x 3 strides (lane, node, GPU; in
// elements), then L, N, G, all as 64-bit integers. `dtype` is 4 (float32
// weights and arithmetic) or 8 (float64). Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not
// take. Does not synchronise.
int fks_param_score(const long long* block, int dtype, void* stream) {
  Args a;
  for (int f = 0; f < kFields; ++f)
    a.ptr[f] = reinterpret_cast<const void*>(block[f]);
  for (int f = 0; f < kFields; ++f)
    for (int d = 0; d < 3; ++d) a.stride[f][d] = block[kFields + 3 * f + d];
  const long long* dims = block + 4 * kFields;
  if (dims[0] < 0 || dims[1] < 1 || dims[2] < 0 || dims[2] > kMaxGpus ||
      dims[0] > (1LL << 30) || dims[1] > (1LL << 30) ||
      (dtype != 4 && dtype != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  a.L = static_cast<int>(dims[0]);
  a.N = static_cast<int>(dims[1]);
  a.G = static_cast<int>(dims[2]);
  const long long warps = static_cast<long long>(a.L) * ((a.N + 15) / 16);
  if (warps > 0) {
    const unsigned blocks =
        static_cast<unsigned>((warps + kWarps - 1) / kWarps);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 4)
      param_score_kernel<float><<<blocks, 32 * kWarps, 0, s>>>(a);
    else
      param_score_kernel<double><<<blocks, 32 * kWarps, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
