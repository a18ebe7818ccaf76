// The parametric policy's score, one launch per policy call, for Hopper
// (sm_90a).
//
// fks_tpu runs models/parametric.py::score as plain XLA, which fuses the
// feasibility mask, the 16 features, the dot product and the truncation
// into a few kernels. The port's plain PyTorch version of it
// (fks_tpu_torch/models/parametric.py::score_plain) is about 130 small
// dependent kernels on the card (its float32 fused multiply-add
// emulation). This kernel computes the same i32[L, N] scores in one launch,
// through node_score.cuh, the device code the fused simulation kernel
// (csrc/fused_sim.cu) scores nodes with.
//
// Inputs are the views the engines hand a policy, read in place through
// their strides: pod fields [L, 1], node fields [L, N] or [N] (lane stride
// 0), GPU fields [L, N, G] or [N, G], weights [L, 16] or [16], as int32,
// bool (one byte) and the score dtype. Nothing is copied, so the launch
// captures inside a CUDA graph and reads whatever the step last wrote.
//
// Bound: at the main path's shape (256 lanes x 16 nodes x 8 GPUs) the
// bytes are a few hundred kilobytes and the work about 60 float operations
// per score, so the floor is the launch plus the round trips a launch
// cannot avoid: the argument block (its constant bank is new on every
// launch), the inputs, the barrier, and node_score's dependent chain. At
// 256 x 1,000 it is the bytes, 12 MB of per-lane GPU rows and remnants
// over the memory rate (about 3.7 us). The design:
//
// - One block scores a tile of lanes x nodes (parametric.launch_geometry
//   picks it on the host: 8 lanes x 16 nodes when N <= 16, the main path;
//   4 lanes x 32 nodes for large N), blockIdx.x the node tile and
//   blockIdx.y the lane tile. It has two threads per (lane, node) cell.
// - One load round: the first half of the block loads the cells' node
//   fields, the second half their GPU rows and the tile's weights and pod
//   fields. Every load of a thread is issued into registers before any of
//   them is stored into shared memory; no load depends on data or waits
//   on a branch. Then one barrier, and the scores read on-chip data only.
//   (cp.async into shared memory measured slower: on sm_90 each copy
//   carries issue padding, and the plain loads of a thread already overlap
//   in flight.)
// - Each input element is read once per block: the pod fields and weights
//   once per lane, the node fields and GPU rows once per (lane, node), and
//   a field the lanes share (lane stride 0: the cluster's totals and
//   masks) once per node for all of the block's lanes.
// - GPU rows are loaded 16 bytes (4 int32) or 4 bytes (4 mask bytes) at a
//   time where the host found them contiguous and aligned with G = 8, 16
//   or 32 (Args::vec), else one element at a time through the strides. The
//   staged row width GS is a template parameter, so the row loads and sums
//   unroll. Staged int rows are padded to GS + 4 words so the two halves'
//   int4 reads are free of bank conflicts; columns past G are zero.
// - Warps score: one warp per (lane, 16 nodes), lanes j and j + 16 on node
//   j (the node_score split of the features). The two lanes of a node each
//   sum half the GPU row (free milli, eligible GPUs, max and min free
//   milli, total milli of the GPUs in the mask) and swap halves with five
//   shuffles.
//
// Offsets are 32-bit: the host refuses views whose extent reaches 2**31
// elements (parametric._check_extents).

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

// GPUs a node may have
constexpr int kMaxGpus = 32;
// a block's threads and shared memory (the default dynamic limit, so the
// launch sets no attribute); parametric.KERNEL_* mirror these
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 48 * 1024;

struct Args {
  const void* ptr[kFields];
  int stride[kFields][3];  // lane, node, GPU strides in elements
  int off[kFields];        // byte offset of the field's staged tile
  int L, N, G;
  int lb_log2;             // lanes per block
  int nb_log2;             // nodes per block (at least 16)
  int rs;                  // staged int GPU row stride in words (GS + 4)
  unsigned shared;         // bit f: field f has lane stride 0 (one row)
  unsigned vec;            // bit f: GPU field f is loaded 4 elements at once
};

template <typename E>
__device__ __forceinline__ E* staged(const Args& a, unsigned char* smem,
                                     int f) {
  return reinterpret_cast<E*>(smem + a.off[f]);
}

// Field F's staged slot for cell (r, nb): its lane row's, or for a field
// the lanes share (bit F of `shared`), row 0's, which alone stages it.
template <int F>
__device__ __forceinline__ int slot(unsigned shared, int cell, int nb) {
  return ((shared >> F) & 1u) ? nb : cell;
}

// Field F's staged element (or, with row > 1, row) of a cell
template <int F, typename E = int>
__device__ __forceinline__ E* staged_at(const Args& a, unsigned char* smem,
                                        unsigned shared, int cell, int nb,
                                        int row = 1) {
  return staged<E>(a, smem, F) + slot<F>(shared, cell, nb) * row;
}

// Node field F of lane l, node n, or 0 unless `load`
template <int F, typename E = int>
__device__ __forceinline__ E load_node(const Args& a, int l, int n,
                                       bool load) {
  return load ? static_cast<const E*>(a.ptr[F])[l * a.stride[F][0] +
                                                 n * a.stride[F][1]]
              : E(0);
}

// GPU field F's row of lane l, node n, 4 columns a load from a contiguous,
// aligned row (V: int4 for int32, unsigned for 4 mask bytes), or zeros
// unless `load`
template <int F, typename V, int GS>
__device__ __forceinline__ void load_row(const Args& a, int l, int n,
                                         bool load, V (&v)[GS / 4]) {
  const V* src = reinterpret_cast<const V*>(
      static_cast<const unsigned char*>(a.ptr[F]) +
      (l * a.stride[F][0] + n * a.stride[F][1]) * (sizeof(V) / 4));
#pragma unroll
  for (int c = 0; c < GS / 4; ++c) v[c] = load ? src[c] : V{};
}

// The staged GPU row's sums over columns [k0, k0 + LEN) (LEN a multiple
// of 4): the row sums of node_gpu_stats, and the total milli of the GPUs in
// the mask. The mask bytes are 0 or 1; padding columns are 0.
struct RowSums {
  int free_milli, eligible, gmax, gmin, milli_total;
};

template <int LEN>
__device__ __forceinline__ RowSums row_sums(const int* gml, const int* gmt,
                                            const unsigned char* gmask,
                                            int k0, int pmilli) {
  RowSums s = {0, 0, 0, 1 << 30, 0};
#pragma unroll
  for (int kb = k0; kb < k0 + LEN; kb += 4) {
    const int4 m4 = *reinterpret_cast<const int4*>(gml + kb);
    const int4 t4 = *reinterpret_cast<const int4*>(gmt + kb);
    const unsigned bits = *reinterpret_cast<const unsigned*>(gmask + kb);
    const int m[4] = {m4.x, m4.y, m4.z, m4.w};
    const int t[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool use = (bits >> (8 * i)) & 0xffu;
      s.free_milli += use ? m[i] : 0;
      s.gmax = use ? max(s.gmax, m[i]) : s.gmax;
      s.gmin = use ? min(s.gmin, m[i]) : s.gmin;
      s.eligible += (use && m[i] >= pmilli) ? 1 : 0;
      s.milli_total += use ? t[i] : 0;
    }
  }
  return s;
}

// This thread's cell of the block's tile for the load round. The block
// has two threads per cell (lane row cr, node cnb): the first half load
// the cells' node fields and, by cell order, the pod fields, the second
// half the cells' GPU rows and, by cell order, the weights.
struct Cell {
  int l0, nb0;  // the tile's first lane and node
  bool gpu_half;
  int cell, cr, cnb;
  int l, n;         // the cell's lane and node; (0, 0) outside the views
  unsigned stages;  // bit f: this cell's row stages field f
  unsigned loads;   // bit f: ... and the cell lies inside the views
};

__device__ __forceinline__ Cell cell_of(const Args& a) {
  Cell c;
  c.l0 = blockIdx.y << a.lb_log2;
  c.nb0 = blockIdx.x << a.nb_log2;
  const int cells_log2 = a.lb_log2 + a.nb_log2;
  c.gpu_half = threadIdx.x >= (1u << cells_log2);
  c.cell = threadIdx.x & ((1 << cells_log2) - 1);
  c.cr = c.cell >> a.nb_log2;
  c.cnb = c.cell & ((1 << a.nb_log2) - 1);
  const bool in = c.l0 + c.cr < a.L && c.nb0 + c.cnb < a.N;
  c.l = in ? c.l0 + c.cr : 0;
  c.n = in ? c.nb0 + c.cnb : 0;
  c.stages = c.cr == 0 ? ~0u : ~a.shared;
  c.loads = in ? c.stages : 0u;
  return c;
}

template <int F>
__device__ __forceinline__ bool has(unsigned bits) {
  return (bits >> F) & 1u;
}

// Field F's GPU row of the cell through its strides, one element at a time,
// in the store phase (views that are not contiguous or aligned; zeros past
// G or outside the views)
template <int F, typename E, int GS>
__device__ __forceinline__ void copy_row(const Args& a, unsigned char* smem,
                                         const Cell& c, int row) {
  if (!has<F>(c.stages)) return;
  E* dst = staged_at<F, E>(a, smem, a.shared, c.cell, c.cnb, row);
  const E* src = static_cast<const E*>(a.ptr[F]) + c.l * a.stride[F][0] +
                 c.n * a.stride[F][1];
  const bool load = has<F>(c.loads);
  for (int k = 0; k < GS; ++k)
    dst[k] = load && k < a.G ? src[k * a.stride[F][2]] : E(0);
}

// A loaded value into its staged slot, if this cell's row stages field F
// (the address is formed first, so the store is predicated, not branched)
template <int F, typename E>
__device__ __forceinline__ void put(const Args& a, unsigned char* smem,
                                    const Cell& c, E v) {
  E* dst = staged_at<F, E>(a, smem, a.shared, c.cell, c.cnb);
  if (has<F>(c.stages)) *dst = v;
}

template <int F, typename V, int GS>
__device__ __forceinline__ void store_row(const Args& a, unsigned char* smem,
                                          const Cell& c, int row,
                                          const V (&v)[GS / 4]) {
  V* dst = reinterpret_cast<V*>(staged_at<F, unsigned char>(
      a, smem, a.shared, c.cell, c.cnb, row * sizeof(V) / 4));
  if (!has<F>(c.stages)) return;
#pragma unroll
  for (int i = 0; i < GS / 4; ++i) dst[i] = v[i];
}

// One thread's loads of its cell, held in registers from the load round
// until they are stored into shared memory.
template <typename T, int GS>
struct CellLoads {
  int4 milli_left[GS / 4], milli_total[GS / 4];  // the GPU rows
  unsigned gpu_mask[GS / 4];
  int node[6];  // cpu, mem, gpu left; cpu, mem totals; GPU count
  unsigned char node_mask;
  T weight;    // weight t of the tile (cell t < 16 LB)
  int pod[4];  // lane row t's pod fields (cell t < LB)
};

// four contiguous, 16-byte aligned weights from shared memory in one
// (float) or two (double) vector reads
__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void load4(const double* p, double (&w)[4]) {
  const double2 u = reinterpret_cast<const double2*>(p)[0];
  const double2 v = reinterpret_cast<const double2*>(p)[1];
  w[0] = u.x;
  w[1] = u.y;
  w[2] = v.x;
  w[3] = v.y;
}

constexpr unsigned kRowBits =
    (1u << kGpuMilliLeft) | (1u << kGpuMilliTotal) | (1u << kGpuMask);

// 1. the load round: every load of the cell issued, no arithmetic on data
// and no wait (the GPU rows of views that are not contiguous and aligned
// are copied in store_cell instead)
template <typename T, int GS>
__device__ __forceinline__ void load_cell(const Args& a, const Cell& c,
                                          CellLoads<T, GS>& v) {
  if (!c.gpu_half) {
    v.node[0] = load_node<kCpuLeft>(a, c.l, c.n, has<kCpuLeft>(c.loads));
    v.node[1] = load_node<kMemLeft>(a, c.l, c.n, has<kMemLeft>(c.loads));
    v.node[2] = load_node<kGpuLeft>(a, c.l, c.n, has<kGpuLeft>(c.loads));
    v.node[3] = load_node<kCpuTotal>(a, c.l, c.n, has<kCpuTotal>(c.loads));
    v.node[4] = load_node<kMemTotal>(a, c.l, c.n, has<kMemTotal>(c.loads));
    v.node[5] = load_node<kNumGpus>(a, c.l, c.n, has<kNumGpus>(c.loads));
    v.node_mask = load_node<kNodeMask, unsigned char>(
        a, c.l, c.n, has<kNodeMask>(c.loads));
    // the pod fields [LB][4], by the cells' order
    const int t = c.cell;
    const bool pod = t < (1 << a.lb_log2) && c.l0 + t < a.L;
    const int pl = pod ? c.l0 + t : 0;
    v.pod[0] = load_node<kPodCpu>(a, pl, 0, pod);
    v.pod[1] = load_node<kPodMem>(a, pl, 0, pod);
    v.pod[2] = load_node<kPodNgpu>(a, pl, 0, pod);
    v.pod[3] = load_node<kPodMilli>(a, pl, 0, pod);
    return;
  }
  if ((a.vec & kRowBits) == kRowBits) {
    load_row<kGpuMilliLeft, int4, GS>(a, c.l, c.n,
                                      has<kGpuMilliLeft>(c.loads),
                                      v.milli_left);
    load_row<kGpuMilliTotal, int4, GS>(a, c.l, c.n,
                                       has<kGpuMilliTotal>(c.loads),
                                       v.milli_total);
    load_row<kGpuMask, unsigned, GS>(a, c.l, c.n, has<kGpuMask>(c.loads),
                                     v.gpu_mask);
  }
  // the weights [LB][16], by the cells' order
  const int t = c.cell;
  const bool weight = t < (16 << a.lb_log2) && c.l0 + (t >> 4) < a.L;
  const int wl = weight ? c.l0 + (t >> 4) : 0;
  v.weight = weight ? static_cast<const T*>(a.ptr[kWeights])
                          [wl * a.stride[kWeights][0] +
                           (t & 15) * a.stride[kWeights][1]]
                    : T(0);
}

template <typename T, int GS>
__device__ __forceinline__ void store_cell(const Args& a, unsigned char* smem,
                                           const Cell& c,
                                           const CellLoads<T, GS>& v) {
  if (!c.gpu_half) {
    put<kCpuLeft>(a, smem, c, v.node[0]);
    put<kMemLeft>(a, smem, c, v.node[1]);
    put<kGpuLeft>(a, smem, c, v.node[2]);
    put<kCpuTotal>(a, smem, c, v.node[3]);
    put<kMemTotal>(a, smem, c, v.node[4]);
    put<kNumGpus>(a, smem, c, v.node[5]);
    put<kNodeMask>(a, smem, c, v.node_mask);
    const int t = c.cell;
    if (t < (1 << a.lb_log2))
      staged<int4>(a, smem, kPodCpu)[t] =
          make_int4(v.pod[0], v.pod[1], v.pod[2], v.pod[3]);
    return;
  }
  if ((a.vec & kRowBits) == kRowBits) {
    store_row<kGpuMilliLeft, int4, GS>(a, smem, c, a.rs, v.milli_left);
    store_row<kGpuMilliTotal, int4, GS>(a, smem, c, a.rs, v.milli_total);
    store_row<kGpuMask, unsigned, GS>(a, smem, c, GS, v.gpu_mask);
  } else {
    copy_row<kGpuMilliLeft, int, GS>(a, smem, c, a.rs);
    copy_row<kGpuMilliTotal, int, GS>(a, smem, c, a.rs);
    copy_row<kGpuMask, unsigned char, GS>(a, smem, c, GS);
  }
  const int t = c.cell;
  if (t < (16 << a.lb_log2)) staged<T>(a, smem, kWeights)[t] = v.weight;
}

// 2. the tile's scores, from shared memory: one warp per (lane row, 16
// nodes), lanes j and j + 16 on node j
template <typename T, int GS>
__device__ __forceinline__ void score_tile(const Args& a, unsigned char* smem,
                                           int l0, int nb0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups_log2 = a.nb_log2 - 4;  // 16-node groups per lane row
  const int r = warp >> groups_log2, l = l0 + r;
  if (l >= a.L) return;  // the whole warp
  const int j = lane & 15;
  const bool hi = lane >= 16;
  const int nb = ((warp & ((1 << groups_log2) - 1)) << 4) + j;
  const int n = nb0 + nb;
  const bool valid = n < a.N;
  const int own = (r << a.nb_log2) + nb;  // this node's cell
  const unsigned sh = a.shared;

  const int4 pod = staged<const int4>(a, smem, kPodCpu)[r];
  const int pcpu = pod.x, pmem = pod.y, pngpu = pod.z, pmilli = pod.w;
  // this half's weights w[4h .. 4h + 3] and w[8 + 4h .. 8 + 4h + 3]
  const T* w = staged<const T>(a, smem, kWeights) + 16 * r + (hi ? 4 : 0);
  T wl[4], wh[4];
  load4(w, wl);
  load4(w + 8, wh);

  NodeStat st;
  st.n = j;
  st.cl = *staged_at<kCpuLeft>(a, smem, sh, own, nb);
  st.ml = *staged_at<kMemLeft>(a, smem, sh, own, nb);
  st.gl = *staged_at<kGpuLeft>(a, smem, sh, own, nb);
  st.on = 0;  // the mask bits live in the staged row
  const bool node_up =
      *staged_at<kNodeMask, unsigned char>(a, smem, sh, own, nb);
  int4 tv = make_int4(*staged_at<kCpuTotal>(a, smem, sh, own, nb),
                      *staged_at<kMemTotal>(a, smem, sh, own, nb),
                      *staged_at<kNumGpus>(a, smem, sh, own, nb), 0);

  // each lane of the node sums half the row, then the two swap halves
  RowSums s = row_sums<GS / 2>(
      staged_at<kGpuMilliLeft>(a, smem, sh, own, nb, a.rs),
      staged_at<kGpuMilliTotal>(a, smem, sh, own, nb, a.rs),
      staged_at<kGpuMask, unsigned char>(a, smem, sh, own, nb, GS),
      hi ? GS / 2 : 0, pmilli);
  s.free_milli += __shfl_xor_sync(kFull, s.free_milli, 16);
  s.eligible += __shfl_xor_sync(kFull, s.eligible, 16);
  s.gmax = max(s.gmax, __shfl_xor_sync(kFull, s.gmax, 16));
  s.gmin = min(s.gmin, __shfl_xor_sync(kFull, s.gmin, 16));
  s.milli_total += __shfl_xor_sync(kFull, s.milli_total, 16);
  st.free_milli = s.free_milli;
  st.eligible = s.eligible;
  st.gmax = s.gmax;
  st.gmin = s.gmin;
  tv.w = s.milli_total;
  // the fit test without branches
  st.feasible = valid & node_up & (pcpu <= st.cl) & (pmem <= st.ml) &
                (pngpu <= st.gl) & ((pngpu <= 0) | (st.eligible >= pngpu));
  const int score =
      node_score<T>(st, tv, hi, pcpu, pmem, pngpu, pmilli, wl, wh);
  if (!hi && valid)
    static_cast<int*>(const_cast<void*>(a.ptr[kOut]))[l * a.N + n] = score;
}

// GS: the staged GPU columns (8, 16 or 32), a compile-time constant so the
// row loads and sums unroll. One block per tile: blockIdx.x the node
// tile, blockIdx.y the lane tile.
template <typename T, int GS>
__global__ void __launch_bounds__(kMaxThreads) param_score_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Cell c = cell_of(a);
  CellLoads<T, GS> v;
  load_cell(a, c, v);
  store_cell(a, smem, c, v);
  __syncthreads();
  score_tile<T, GS>(a, smem, c.l0, c.nb0);
}

// the launch floor: a kernel that does nothing, for phase 4b's timings
__global__ void floor_kernel() {}

constexpr int kHeader = 4 * kFields + 3;  // pointers, strides, L, N, G

template <typename T, int GS>
void launch(const Args& a, dim3 grid, unsigned threads, size_t smem,
            cudaStream_t s, bool empty) {
  if (empty)
    floor_kernel<<<grid, threads, smem, s>>>();
  else
    param_score_kernel<T, GS><<<grid, threads, smem, s>>>(a);
}

// Check the argument block and launch (or, with empty, launch the floor
// kernel at the same geometry).
int run(const long long* block, int dtype, void* stream, bool empty) {
  const long long* dims = block + 4 * kFields;
  const long long* geo = block + kHeader;
  const long long gx = geo[0], gy = geo[1], threads = geo[2];
  const long long lb = geo[3], nb = geo[4], gsl = geo[5], rs = geo[6];
  const long long smem = geo[7];
  bool ok = dims[0] >= 0 && dims[1] >= 1 && dims[2] >= 0 &&
            dims[2] <= kMaxGpus && dims[0] * dims[1] < (1LL << 31) &&
            (dtype == 4 || dtype == 8) && lb >= 0 && nb >= 4 &&
            gsl >= 3 && gsl <= 5 && rs >= (1LL << gsl) && rs % 4 == 0 &&
            threads == (2LL << (lb + nb)) && threads <= kMaxThreads &&
            smem > 0 && smem <= kMaxSmem &&
            gx == (dims[1] + (1LL << nb) - 1) >> nb &&
            gy == (dims[0] + (1LL << lb) - 1) >> lb &&
            gy <= 65535;
  for (int f = 0; f < kFields && ok; ++f) {
    for (int d = 0; d < 3; ++d) {
      const long long st = block[kFields + 3 * f + d];
      ok = ok && st >= 0 && st < (1LL << 31);
    }
    // the staged tiles' layout is the host's (launch_geometry, held by the
    // CPU tests); here only that each offset is aligned and inside smem
    const long long off = geo[10 + f];
    ok = ok && off >= 0 && off % 16 == 0 && off < smem;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (gy == 0) return 0;  // no lanes
  Args a;
  for (int f = 0; f < kFields; ++f) {
    a.ptr[f] = reinterpret_cast<const void*>(block[f]);
    for (int d = 0; d < 3; ++d)
      a.stride[f][d] = static_cast<int>(block[kFields + 3 * f + d]);
    a.off[f] = static_cast<int>(geo[10 + f]);
  }
  a.L = static_cast<int>(dims[0]);
  a.N = static_cast<int>(dims[1]);
  a.G = static_cast<int>(dims[2]);
  a.lb_log2 = static_cast<int>(lb);
  a.nb_log2 = static_cast<int>(nb);
  a.rs = static_cast<int>(rs);
  a.shared = static_cast<unsigned>(geo[8]);
  a.vec = static_cast<unsigned>(geo[9]);
  const dim3 g(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const unsigned t = static_cast<unsigned>(threads);
  const size_t bytes = static_cast<size_t>(smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 4 && gsl == 3) launch<float, 8>(a, g, t, bytes, s, empty);
  if (dtype == 4 && gsl == 4) launch<float, 16>(a, g, t, bytes, s, empty);
  if (dtype == 4 && gsl == 5) launch<float, 32>(a, g, t, bytes, s, empty);
  if (dtype == 8 && gsl == 3) launch<double, 8>(a, g, t, bytes, s, empty);
  if (dtype == 8 && gsl == 4) launch<double, 16>(a, g, t, bytes, s, empty);
  if (dtype == 8 && gsl == 5) launch<double, 32>(a, g, t, bytes, s, empty);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Score L lanes' pods against their N nodes on `stream`. `block` holds, as
// 64-bit integers: kFields device addresses; kFields x 3 strides (lane,
// node, GPU; in elements); L, N, G; then the launch geometry that
// parametric.launch_geometry computes: node tiles, lane tiles, threads,
// log2 lanes per block, log2 nodes per block, log2 staged GPU columns, the
// int row stride, shared bytes, the shared-field bits, the vector-load
// bits and kFields byte offsets of the staged tiles. `dtype` is 4 (float32
// weights and arithmetic) or 8 (float64). Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape or geometry the kernel
// does not take. Does not synchronise.
int fks_param_score(const long long* block, int dtype, void* stream) {
  return run(block, dtype, stream, false);
}

// The same launch of an empty kernel: the floor a score launch of that
// geometry cannot go below.
int fks_param_score_floor(const long long* block, int dtype, void* stream) {
  return run(block, dtype, stream, true);
}

const char* fks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
