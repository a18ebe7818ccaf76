// The flat engine's step around its policy call, for Hopper (sm_90a): two
// kernels, flat_pop before the policy and flat_commit after it.
//
// fks_tpu has no TPU kernel for this: it runs the flat step
// (fks_tpu/sim/flat.py, build_step) as plain XLA, which fuses it into a
// few kernels. The port's PyTorch step (fks_tpu_torch/sim/flat.py,
// build_torch_step) is about 200 small kernels on the card, each over [L,
// Q] or [L, N(, G)], and on CUDA it runs every branch in every lane,
// because asking whether any lane needs one is a host sync. These two
// kernels are that step's body for the configurations that
// sim.flat.kernel_step_blocker admits (packed aux, no faults, one
// workload, no trace, audit, watchdog, prefilter or packed state); the
// policy call between them stays the caller's own launch, reading the
// pod columns flat_pop writes (sim/flat_step.py, pod_view) and the node
// state in place. Their plain versions are sim/flat_step.py's pop_plain
// and commit_plain; the PyTorch step is what both are held to.
//
// Bound: the work is a lane's short chain of dependent steps. flat_pop
// reads a lane's queue, ev_time and aux (8 bytes a slot: 64 KB a lane at
// Q = 8,152), flat_commit a lane's scores and node remnants (about 25 KB
// at N = 1,213) and, at a snapshot or a failed placement, its GPU
// remnants (39 KB). At 32 lanes that is 2.1 MB and 0.8 MB a step, all of
// it resident in the 50 MB L2 (the lanes' whole state is about 3.8 MB):
// under a microsecond each at the L2's rate. The practical floor is a
// launch inside a graph plus each kernel's chain of round trips.
//
// Design:
// - One block per lane (blockIdx.x): flat_pop up to 1,024 threads, 8
//   slots a thread; flat_commit up to 512, 4 nodes a thread (the host
//   picks the count: sim/flat_step.py, threads). A lane that does not
//   need a branch does not run it: the branch is uniform across the
//   block, so this costs no divergence.
// - flat_pop: one pass over the lane's queue, 4 slots a load where the
//   rows are 16-byte aligned, folds the lexicographic (time, slot)
//   minimum as one 64-bit key (the first slot wins among equal times, as
//   torch.min does) and the earliest pending DELETE (aux >= 0) into one
//   block reduction. Warp 0 then gathers the pod row, applies the DELETE
//   refund in place (a GPU of the held node a thread) and writes the
//   lane's scratch row.
// - flat_commit: one pass, issued before the scratch row is back, folds
//   the active-node count, the masked score's first-index argmax (a
//   64-bit key) over the nodes and, over the waiting histogram, the first
//   waiting bucket other than the pod's own, so the bucket's own update
//   needs no second scan. Every thread then knows the placement's node,
//   whether it scores and whether the lane needs a second pass. Warp 0
//   picks the GPUs (a GPU a thread, ranks by shuffles, the allocator's
//   tie rule) and thread 0 writes the placement, the histogram, the slot
//   and the counters, the active count corrected for the placed node. Only
//   a snapshot or a failed placement's fragmentation score reads the
//   lane again, after those writes: the used resources or the free milli,
//   summed as int64 and divided once in the score's type, as the PyTorch
//   step does. (A retry storm makes failed placements most of a long
//   lane's steps.)
// - The step is a chain of round trips to L2, so every thread that reads
//   and writes the state issues its loads together before its stores
//   (nothing tells the compiler that the state's arrays do not alias).
// - Both kernels are launched as programmatic dependents (sm_90): a
//   kernel's blocks may start before the kernel ahead of it ends and wait
//   for its writes, and flat_commit lets the next step's flat_pop start
//   at once, which hides that launch behind it (about 6% more candidates
//   a second in the benchmark's flat cell on an H100).
// - Integer arithmetic wraps as PyTorch's int32 does.
//
// Offsets are 64-bit: no extent limit beyond the tensors' own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7fffffff;  // sim.flat.INF: an empty slot
constexpr int kAuxWaiting = -2;   // sim.flat.AUX_WAITING
constexpr int kBig = 1 << 30;     // ops.allocator._BIG
constexpr int kMaxThreads = 1024;  // flat_pop's block at most
constexpr int kMaxGpus = 32;      // one 32-bit ballot a node's GPUs

// the scratch row of a lane (sim/flat_step.py, SCRATCH)
enum Col {
  kT, kCol, kAux, kCpu, kMem, kNgpu, kMilli, kDur, kAct, kNextDel, kCols
};

// the pod table's columns (sim.flat.pod_table)
constexpr int kFeat = 5;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// Programmatic dependent launch (sm_90): each kernel is launched so that
// its blocks may start before the kernel ahead of it on the stream ends;
// it waits for that kernel's completion and its writes before it reads
// anything.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next_kernel_start() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

template <typename Kernel, typename Args>
void launch_dependent(Kernel kernel, dim3 grid, unsigned threads,
                      cudaStream_t stream, const Args& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, args);
}

// ------------------------------------------------------------- flat_pop

struct PopArgs {
  const int* ev_time;          // [L, Q]
  const int* aux;              // [L, Q]
  const int* feat;             // [Q, 5]
  const int* pending;          // [L]
  const unsigned char* failed; // [L]
  const int* steps;            // [L]
  int* cpu_left;               // [L, N]
  int* mem_left;               // [L, N]
  int* gpu_left;               // [L, N]
  int* gml;                    // [L, N, G]
  int* scratch;                // [L, kCols]
  int q, n, g, max_steps;
};

// the (time, slot) key: times in order as unsigned, then the slot
__device__ __forceinline__ unsigned long long slot_key(int t, int i) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(t) ^
                                          0x80000000u) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ void fold_slot(int t, int x, int i,
                                          unsigned long long& best,
                                          int& next_del) {
  best = min(best, slot_key(t, i));
  if (x >= 0) next_del = min(next_del, t);
}

template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
flat_pop_kernel(PopArgs a) {
  __shared__ unsigned long long s_best[32];
  __shared__ int s_del[32];
  wait_for_previous_kernel();
  const int l = blockIdx.x;
  const size_t row = static_cast<size_t>(l) * a.q;
  const int* ev = a.ev_time + row;
  const int* aux = a.aux + row;
  // warp 0's, read before the scan so the loads overlap it
  bool act = false;
  if (threadIdx.x < 32)
    act = (a.pending[l] > 0) & !a.failed[l] & (a.steps[l] < a.max_steps);
  unsigned long long best = ~0ull;
  int next_del = kInf;
  if (VEC) {
    // two rows of 4 slots a thread, both loaded before either is folded
    const int4* ev4 = reinterpret_cast<const int4*>(ev);
    const int4* aux4 = reinterpret_cast<const int4*>(aux);
    const int n4 = a.q / 4;
    for (int base = threadIdx.x; base < n4; base += 2 * blockDim.x) {
      int4 t[2], x[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = base + k * blockDim.x;
        t[k] = i < n4 ? ev4[i] : make_int4(kInf, kInf, kInf, kInf);
        x[k] = i < n4 ? aux4[i] : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = base + k * blockDim.x;
        if (i >= n4) continue;
        fold_slot(t[k].x, x[k].x, 4 * i, best, next_del);
        fold_slot(t[k].y, x[k].y, 4 * i + 1, best, next_del);
        fold_slot(t[k].z, x[k].z, 4 * i + 2, best, next_del);
        fold_slot(t[k].w, x[k].w, 4 * i + 3, best, next_del);
      }
    }
  } else {
    for (int i = threadIdx.x; i < a.q; i += blockDim.x)
      fold_slot(ev[i], aux[i], i, best, next_del);
  }
  best = warp_min(best);
  next_del = warp_min(next_del);
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  if (wl == 0) {
    s_best[warp] = best;
    s_del[warp] = next_del;
  }
  __syncthreads();
  if (warp != 0) return;
  const int warps = blockDim.x >> 5;
  best = warp_min(wl < warps ? s_best[wl] : ~0ull);
  next_del = warp_min(wl < warps ? s_del[wl] : kInf);

  // warp 0: every lane holds the popped slot; its loads are issued
  // together, then its stores (one GPU of the held node a lane)
  const int col = static_cast<int>(best & 0xffffffffu);
  const int t = static_cast<int>(static_cast<unsigned>(best >> 32) ^
                                 0x80000000u);
  const int x = aux[col];
  const int* f = a.feat + static_cast<size_t>(col) * kFeat;
  const int pcpu = f[0], pmem = f[1], pngpu = f[2], pmilli = f[3],
            pdur = f[4];
  const int held = x >> a.g;
  const bool refund = act && x >= 0 && held < a.n;  // a DELETE
  const size_t node = static_cast<size_t>(l) * a.n + (refund ? held : 0);
  const bool mine = refund && wl < a.g && ((x >> wl) & 1);
  int* m = a.gml + node * a.g + wl;
  const int milli = mine ? *m : 0;
  int cpu = 0, mem = 0, gpu = 0;
  if (refund && wl == 0) {
    cpu = a.cpu_left[node];
    mem = a.mem_left[node];
    gpu = a.gpu_left[node];
  }
  if (mine) *m = wrap_add(milli, pmilli);
  if (wl != 0) return;
  if (refund) {
    a.cpu_left[node] = wrap_add(cpu, pcpu);
    a.mem_left[node] = wrap_add(mem, pmem);
    a.gpu_left[node] = wrap_add(gpu, pngpu);
  }
  int* sc = a.scratch + static_cast<size_t>(l) * kCols;
  sc[kT] = t;
  sc[kCol] = col;
  sc[kAux] = x;
  sc[kCpu] = pcpu;
  sc[kMem] = pmem;
  sc[kNgpu] = pngpu;
  sc[kMilli] = pmilli;
  sc[kDur] = pdur;
  sc[kAct] = act;
  sc[kNextDel] = next_del;
}

// ---------------------------------------------------------- flat_commit

template <typename F>
struct CommitArgs {
  int* ev_time;                  // [L, Q]
  int* aux;                      // [L, Q]
  int* pod_ctime;                // [L, Q], read only with track_ctime
  int* pending;                  // [L]
  int* cpu_left;                 // [L, N]
  int* mem_left;                 // [L, N]
  int* gpu_left;                 // [L, N]
  int* gml;                      // [L, N, G]
  int* wait_hist;                // [L, H]
  int* events;                   // [L]
  int* snap_idx;                 // [L]
  F* snap_sums;                  // [L, 4]
  F* frag_sum;                   // [L]
  int* frag_count;               // [L]
  int* max_nodes;                // [L]
  unsigned char* failed;         // [L]
  int* steps;                    // [L]
  const int* scratch;            // [L, kCols]
  const int* raw;                // the policy's [L, N] scores, strided
  long long raw_ls, raw_ns;      // their lane and node strides
  const unsigned char* node_mask;  // [N]
  const int* cpu_total;          // [N]
  const int* mem_total;          // [N]
  const int* num_gpus;           // [N]
  const unsigned char* gpu_mask;   // [N, G]
  const long long* totals;       // [4]
  const F* denom;                // [4]
  const int* ktable;             // [K]
  int q, n, g, h, k;
  bool first_fit, track_ctime;
};

// nodes (and waiting buckets) a commit thread loads at once: every load of
// the first pass is issued before any of it is used
constexpr int kPer = 4;
constexpr int kCommitThreads = 512;
// rows of 4 GPUs a commit thread loads at once in the second pass
constexpr int kVec = 8;

// is node i active (holds some pod) at these remnants?
__device__ __forceinline__ bool node_active(bool mask, int cpu, int mem,
                                            int gpu, int cpu_total,
                                            int mem_total, int num_gpus) {
  return mask && (cpu < cpu_total || mem < mem_total || gpu < num_gpus);
}

template <typename F, bool VEC>
__global__ void __launch_bounds__(kCommitThreads)
flat_commit_kernel(CommitArgs<F> a) {
  __shared__ unsigned long long s_key[32];
  __shared__ int s_hist[32];
  __shared__ int s_active[32];
  __shared__ long long s_sum[5][32];
  wait_for_previous_kernel();
  let_next_kernel_start();
  const int l = blockIdx.x;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const size_t lane_n = static_cast<size_t>(l) * a.n;
  const int* sc = a.scratch + static_cast<size_t>(l) * kCols;
  const int* raw = a.raw + l * a.raw_ls;
  int* hist = a.wait_hist + static_cast<size_t>(l) * a.h;

  // ---- pass 1, issued before the scratch row is back: over the nodes the
  // active count (before this step's placement), the masked score's
  // first-index argmax (a 64-bit key) and, over the waiting histogram, its
  // first waiting bucket other than the pod's own (b)
  const int act = sc[kAct], t = sc[kT], col = sc[kCol], x = sc[kAux];
  const int pcpu = sc[kCpu], pmem = sc[kMem], pngpu = sc[kNgpu];
  const int pmilli = sc[kMilli], pdur = sc[kDur], next_del = sc[kNextDel];
  const int events = a.events[l], snap_idx = a.snap_idx[l];
  int active = 0;
  unsigned long long best = 0;
  int m_ex = a.h;
  const int b = min(max(pmilli, 0), a.h - 1);  // the pod's waiting bucket
  const int span = max(a.n, a.h);
  for (int base = threadIdx.x; base < span; base += kPer * blockDim.x) {
    int sv[kPer], cpu[kPer], mem[kPer], gpu[kPer], ct[kPer], mt[kPer],
        ng[kPer], hv[kPer];
    bool mask[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k * blockDim.x;
      const bool node = i < a.n;
      mask[k] = node && a.node_mask[i];
      sv[k] = node ? raw[i * a.raw_ns] : 0;
      cpu[k] = node ? a.cpu_left[lane_n + i] : 0;
      mem[k] = node ? a.mem_left[lane_n + i] : 0;
      gpu[k] = node ? a.gpu_left[lane_n + i] : 0;
      ct[k] = node ? a.cpu_total[i] : 0;
      mt[k] = node ? a.mem_total[i] : 0;
      ng[k] = node ? a.num_gpus[i] : 0;
      hv[k] = i < a.h ? hist[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k * blockDim.x;
      active += node_active(mask[k], cpu[k], mem[k], gpu[k], ct[k], mt[k],
                            ng[k]);
      if (i < a.n) {
        const int s = mask[k] ? sv[k] : 0;
        best = max(best, (static_cast<unsigned long long>(
                              static_cast<unsigned>(s) ^ 0x80000000u) << 32) |
                             (0xffffffffu - static_cast<unsigned>(i)));
      }
      if (i < a.h && i != b && hv[k] > 0) m_ex = min(m_ex, i);
    }
  }
  // read by every thread before thread 0 may write it
  const int hist_b = hist[b];
  if (!act) return;  // an inactive lane: the step is a no-op
  active = warp_sum(active);
  best = warp_max(best);
  m_ex = warp_min(m_ex);
  if (wl == 0) {
    s_active[warp] = active;
    s_key[warp] = best;
    s_hist[warp] = m_ex;
  }
  __syncthreads();
  active = warp_sum(wl < warps ? s_active[wl] : 0);
  best = warp_max(wl < warps ? s_key[wl] : 0ull);
  m_ex = warp_min(wl < warps ? s_hist[wl] : a.h);

  // ---- what every thread can decide: the placement's node, whether it
  // scores, and whether the lane needs a second pass (a snapshot that may
  // fire, or the fragmentation score of a failed placement)
  const bool create = x < 0;
  const int w = create ? static_cast<int>(
                             0xffffffffu -
                             static_cast<unsigned>(best & 0xffffffffu))
                       : 0;
  const bool placed = create &&
                      static_cast<int>(static_cast<unsigned>(best >> 32) ^
                                       0x80000000u) > 0;
  const bool failp = create && !placed;
  const bool was_waiting = x == kAuxWaiting;
  const bool gpu_pod = pngpu > 0;
  const int grow = failp && !was_waiting && gpu_pod;
  const int first = (wrap_add(hist_b, grow) > 0 && b < m_ex) ? b : m_ex;
  const bool has_w = first < a.h;
  const int min_needed = has_w ? first : 0;
  const bool frag = failp && has_w && a.totals[3] > 0;
  const bool may_fire = snap_idx < a.k &&
                        events + 1 >= a.ktable[min(snap_idx, a.k - 1)];
  const bool pass2 = may_fire || frag;
  if (warp != 0 && !pass2) return;

  // ---- warp 0: the GPUs of node w, a GPU a thread (ops.allocator), then
  // thread 0's writes
  bool alloc_fail = false;
  if (warp == 0) {
    const size_t node = lane_n + w;
    int* row_g = a.gml + node * a.g;
    bool eligible = false;
    int key = kBig, m = 0;
    if (placed && wl < a.g) {
      m = row_g[wl];
      eligible = a.gpu_mask[static_cast<size_t>(w) * a.g + wl] && m >= pmilli;
      key = eligible ? static_cast<int>(static_cast<unsigned>(m) *
                                            static_cast<unsigned>(a.g) +
                                        static_cast<unsigned>(wl))
                     : kBig;
    }
    int cpu = 0, mem = 0, gpu = 0, ct = 0, mt = 0, ng = 0;
    bool mask = false;
    if (placed && wl == 0) {
      cpu = a.cpu_left[node];
      mem = a.mem_left[node];
      gpu = a.gpu_left[node];
      ct = a.cpu_total[w];
      mt = a.mem_total[w];
      ng = a.num_gpus[w];
      mask = a.node_mask[w];
    }
    const unsigned elig = __ballot_sync(~0u, eligible);
    int rank = 0;
    if (a.first_fit) {
      rank = __popc(elig & static_cast<unsigned>((1ull << wl) - 1));
    } else {
      for (int j = 0; j < a.g; ++j)
        rank += __shfl_sync(~0u, key, j) < key;
    }
    const bool pick = eligible && rank < pngpu;
    const unsigned sel = __ballot_sync(~0u, pick);
    alloc_fail = placed && pngpu > 0 && __popc(elig) < pngpu;
    const bool pl = placed && !alloc_fail;
    if (pl && pick) row_g[wl] = wrap_sub(m, pmilli);
    if (wl == 0) {
      // the lane's scalars, loaded together
      const int pending = a.pending[l], frag_count = a.frag_count[l];
      const int max_nodes = a.max_nodes[l], steps = a.steps[l];
      const bool found = next_del < kInf;
      const bool retry = failp && found, dropped = failp && !found;
      const int rt = wrap_add(next_del, 1);
      const bool valid = !alloc_fail;
      if (pl) {
        a.cpu_left[node] = wrap_sub(cpu, pcpu);
        a.mem_left[node] = wrap_sub(mem, pmem);
        a.gpu_left[node] = wrap_sub(gpu, pngpu);
        // node w's part of the active count, before and after
        active += node_active(mask, wrap_sub(cpu, pcpu), wrap_sub(mem, pmem),
                              wrap_sub(gpu, pngpu), ct, mt, ng) -
                  node_active(mask, cpu, mem, gpu, ct, mt, ng);
      }
      const int delta = grow - (pl && was_waiting && gpu_pod);
      if (delta != 0) hist[b] = wrap_add(hist_b, delta);
      const size_t slot = static_cast<size_t>(l) * a.q + col;
      const int enc = (w << a.g) | static_cast<int>(
          sel & static_cast<unsigned>((1ull << a.g) - 1));
      a.ev_time[slot] = pl ? wrap_add(t, pdur) : retry ? rt : kInf;
      a.aux[slot] = pl ? enc : failp ? kAuxWaiting : x;
      if (a.track_ctime && retry) a.pod_ctime[slot] = rt;
      if (!create || dropped) a.pending[l] = pending - 1;
      a.events[l] = events + valid;
      if (failp) a.frag_count[l] = frag_count + 1;
      if (alloc_fail) a.failed[l] = 1;
      if (valid) a.max_nodes[l] = max(max_nodes, active);
      a.steps[l] = steps + 1;
    }
  }
  if (!pass2) return;

  // ---- pass 2, after this step's writes: the used resources of a
  // snapshot and the free milli of fragmented GPUs, summed as int64. A
  // retry storm makes a failed placement, and so this pass, most of a
  // long lane's steps: each thread issues all its loads at once
  F frag_sum = 0, snap[4] = {0, 0, 0, 0};
  F* snap_at = a.snap_sums + static_cast<size_t>(l) * 4;
  if (threadIdx.x == 0) {
    frag_sum = a.frag_sum[l];
    for (int r = 0; r < 4; ++r) snap[r] = snap_at[r];
  }
  __syncthreads();
  long long sum[5] = {0, 0, 0, 0, 0};  // CPU, memory, GPUs used, milli, frag
  if (may_fire) {
    for (int base = threadIdx.x; base < a.n; base += kPer * blockDim.x) {
      int cpu[kPer], mem[kPer], used[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = base + k * blockDim.x;
        cpu[k] = i < a.n ? a.cpu_left[lane_n + i] : 0;
        mem[k] = i < a.n ? a.mem_left[lane_n + i] : 0;
        used[k] = i < a.n ? wrap_sub(a.num_gpus[i], a.gpu_left[lane_n + i])
                          : 0;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        sum[0] += cpu[k];
        sum[1] += mem[k];
        sum[2] += used[k];
      }
    }
  }
  const int* gml = a.gml + lane_n * a.g;
  auto fold = [&](int m, bool gpu) {
    if (may_fire) sum[3] += m;
    if (frag && gpu && m > 0 && m < min_needed) sum[4] += m;
  };
  if (VEC) {  // 4 GPUs a load: N x G a multiple of 4, rows aligned
    const int4* g4 = reinterpret_cast<const int4*>(gml);
    const unsigned* m4 = reinterpret_cast<const unsigned*>(a.gpu_mask);
    const int n4 = a.n * a.g / 4;
    for (int base = threadIdx.x; base < n4; base += kVec * blockDim.x) {
      int4 v[kVec];
      unsigned mk[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = base + k * blockDim.x;
        v[k] = i < n4 ? g4[i] : make_int4(0, 0, 0, 0);
        mk[k] = i < n4 && frag ? m4[i] : 0u;
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        fold(v[k].x, mk[k] & 0xffu);
        fold(v[k].y, (mk[k] >> 8) & 0xffu);
        fold(v[k].z, (mk[k] >> 16) & 0xffu);
        fold(v[k].w, mk[k] >> 24);
      }
    }
  } else {
    for (int i = threadIdx.x; i < a.n * a.g; i += blockDim.x)
      fold(gml[i], frag && a.gpu_mask[i]);
  }
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    if (r < 4 ? may_fire : frag) {  // the sums this lane needs
      sum[r] = warp_sum(sum[r]);
      if (wl == 0) s_sum[r][warp] = sum[r];
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int r = 0; r < 5; ++r)
    if (r < 4 ? may_fire : frag)
      for (int i = 1; i < warps; ++i) sum[r] += s_sum[r][i];
  if (may_fire && !alloc_fail) {  // fires
    const long long used[4] = {a.totals[0] - sum[0], a.totals[1] - sum[1],
                               sum[2], a.totals[3] - sum[3]};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      snap_at[r] = snap[r] + (a.totals[r] <= 0
                                  ? F(0)
                                  : static_cast<F>(used[r]) / a.denom[r]);
    a.snap_idx[l] = snap_idx + 1;
  }
  if (frag) a.frag_sum[l] = frag_sum + static_cast<F>(sum[4]) / a.denom[3];
}

// ------------------------------------------------------------- the host

template <typename T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(v);
}

bool threads_ok(long long threads, int most) {
  return threads >= 32 && threads <= most && threads % 32 == 0;
}

// the pop block: 11 device addresses, then L, Q, N, G, max_steps, threads
constexpr int kPopPtrs = 11;

int pop(const long long* block, void* stream) {
  const long long* dims = block + kPopPtrs;
  const long long L = dims[0], q = dims[1], n = dims[2], g = dims[3];
  const long long threads = dims[5];
  if (!(L >= 0 && L < (1LL << 31) && q >= 1 && q < (1LL << 31) && n >= 1 &&
        n < (1LL << 31) && g >= 0 && g <= kMaxGpus &&
        threads_ok(threads, kMaxThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  PopArgs a;
  a.ev_time = ptr<const int>(block[0]);
  a.aux = ptr<const int>(block[1]);
  a.feat = ptr<const int>(block[2]);
  a.pending = ptr<const int>(block[3]);
  a.failed = ptr<const unsigned char>(block[4]);
  a.steps = ptr<const int>(block[5]);
  a.cpu_left = ptr<int>(block[6]);
  a.mem_left = ptr<int>(block[7]);
  a.gpu_left = ptr<int>(block[8]);
  a.gml = ptr<int>(block[9]);
  a.scratch = ptr<int>(block[10]);
  a.q = static_cast<int>(q);
  a.n = static_cast<int>(n);
  a.g = static_cast<int>(g);
  a.max_steps = static_cast<int>(dims[4]);
  // 4 slots a load: rows of a multiple of 4 slots from 16-byte aligned
  // bases
  const bool vec = q % 4 == 0 && block[0] % 16 == 0 && block[1] % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(L);
  const unsigned t = static_cast<unsigned>(threads);
  if (vec)
    launch_dependent(flat_pop_kernel<true>, grid, t, s, a);
  else
    launch_dependent(flat_pop_kernel<false>, grid, t, s, a);
  return static_cast<int>(cudaGetLastError());
}

// the commit block: 27 device addresses (raw's among them), raw's lane
// and node strides, then L, Q, N, G, H, K, first_fit, track_ctime, threads
constexpr int kCommitPtrs = 27;

template <typename F>
void commit_launch(const long long* block, cudaStream_t s) {
  const long long* v = block + kCommitPtrs;
  CommitArgs<F> a;
  a.ev_time = ptr<int>(block[0]);
  a.aux = ptr<int>(block[1]);
  a.pod_ctime = ptr<int>(block[2]);
  a.pending = ptr<int>(block[3]);
  a.cpu_left = ptr<int>(block[4]);
  a.mem_left = ptr<int>(block[5]);
  a.gpu_left = ptr<int>(block[6]);
  a.gml = ptr<int>(block[7]);
  a.wait_hist = ptr<int>(block[8]);
  a.events = ptr<int>(block[9]);
  a.snap_idx = ptr<int>(block[10]);
  a.snap_sums = ptr<F>(block[11]);
  a.frag_sum = ptr<F>(block[12]);
  a.frag_count = ptr<int>(block[13]);
  a.max_nodes = ptr<int>(block[14]);
  a.failed = ptr<unsigned char>(block[15]);
  a.steps = ptr<int>(block[16]);
  a.scratch = ptr<const int>(block[17]);
  a.raw = ptr<const int>(block[18]);
  a.node_mask = ptr<const unsigned char>(block[19]);
  a.cpu_total = ptr<const int>(block[20]);
  a.mem_total = ptr<const int>(block[21]);
  a.num_gpus = ptr<const int>(block[22]);
  a.gpu_mask = ptr<const unsigned char>(block[23]);
  a.totals = ptr<const long long>(block[24]);
  a.denom = ptr<const F>(block[25]);
  a.ktable = ptr<const int>(block[26]);
  a.raw_ls = v[0];
  a.raw_ns = v[1];
  a.q = static_cast<int>(v[3]);
  a.n = static_cast<int>(v[4]);
  a.g = static_cast<int>(v[5]);
  a.h = static_cast<int>(v[6]);
  a.k = static_cast<int>(v[7]);
  a.first_fit = v[8] != 0;
  a.track_ctime = v[9] != 0;
  const dim3 grid(static_cast<unsigned>(v[2]));
  const unsigned t = static_cast<unsigned>(v[10]);
  // the second pass's rows 4 GPUs a load: N x G a multiple of 4 from
  // aligned bases
  const bool vec = (a.n * a.g) % 4 == 0 && block[7] % 16 == 0 &&
                   block[23] % 4 == 0;
  if (vec)
    launch_dependent(flat_commit_kernel<F, true>, grid, t, s, a);
  else
    launch_dependent(flat_commit_kernel<F, false>, grid, t, s, a);
}

int commit(const long long* block, int dtype, void* stream) {
  const long long* v = block + kCommitPtrs;
  const long long L = v[2], q = v[3], n = v[4], g = v[5], h = v[6];
  const long long k = v[7];
  if (!(L >= 0 && L < (1LL << 31) && q >= 1 && q < (1LL << 31) && n >= 1 &&
        n < (1LL << 31) && g >= 0 && g <= kMaxGpus && h >= 1 &&
        h < (1LL << 31) && k >= 0 && k < (1LL << 31) &&
        n * (g > 0 ? g : 1) < (1LL << 31) && v[0] >= 0 && v[1] >= 0 &&
        (dtype == 4 || dtype == 8) && threads_ok(v[10], kCommitThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 4)
    commit_launch<float>(block, s);
  else
    commit_launch<double>(block, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// flat_pop on `stream` for every lane (sim/flat_step.py, _pop_block):
// `block` holds, as 64-bit integers, the device addresses of ev_time, aux,
// the pod table, pending, failed, steps, cpu_left, mem_left, gpu_left,
// gpu_milli_left and the scratch rows, then L, Q, N, G, max_steps and the
// block's threads. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take. Does not
// synchronise.
int fks_flat_pop(const long long* block, void* stream) {
  return pop(block, stream);
}

// flat_commit on `stream` (sim/flat_step.py, _commit_block): `dtype` is 4
// (float32 snapshot and fragmentation sums) or 8 (float64).
int fks_flat_commit(const long long* block, int dtype, void* stream) {
  return commit(block, dtype, stream);
}

const char* fks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
