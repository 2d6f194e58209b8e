// The whole recurrent stack of an LSTM autoencoder over a window, in one
// launch, on the paper's wavefront schedule (§3.2), for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs a stack either as one
// Pallas cell per (layer, timestep) (src/repro/kernels/lstm_cell.py::
// lstm_cell_pallas under the "fused" schedule, which the port's K1 follows)
// or as the temporal-parallel dataflow of src/repro/core/temporal.py
// (wavefront_forward, pipelined_forward) in XLA ops.  At a small batch the
// port's K1 chain is D x T dependent launches of about 4.5 us each; this
// kernel is the paper's dataflow pipeline mapped onto the card: each FPGA
// module becomes one thread block (CTA) of a cluster, each FIFO a ring in
// distributed shared memory.
//
// Computes, for each layer l and timestep t (x_0 = the window, x_{l+1} = h_l):
//   pre[g] = sum_k x_l[t][k]*wx[k, g*H+j] + sum_k h_l[t-1][k]*wh[k, g*H+j] + b[g*H+j]
//   c' = sig(pre_f)*c + sig(pre_i)*tanh(pre_g),  h' = sig(pre_o)*tanh(c')
// in f32 on FP32 FMAs (no TF32), with exact sigmoid/tanh (expf, tanhf) or
// the paper's piecewise-linear ones, as K1 does; h and c start at zero.  The
// weights are read in the core layout {wx (In, 4H), wh (H, 4H), b (4H)}.
// The output is the last layer's h over the window, (T, B, H_last).
//
// Bound on an H100 SXM: at a small batch the chain of T + D - 1 dependent
// wavefront steps (69 at lstm-ae-f64-d6, 65 at lstm-ae-f32-d2, against D x T
// = 384 and 128 cells for K1); the operations (8 x B x T x sum of
// H x (In + H) FLOP, 6.2 MFLOP a f64-d6 window) take about 0.1 us at
// 67 TFLOP/s.  So it is latency-bound: a step costs the widest layer's dot,
// two activations in a row, two block barriers, a cluster barrier and one
// hop of distributed shared memory, and the design keeps all of it on chip
// and issues as few instructions a step as it can.
//
// Design: one cluster of D CTAs (D = depth <= 8, the portable cluster size)
// per group of R rows; CTA l runs layer l.  Its weights live in registers
// for the whole launch: thread i owns output o = i / S of the layer's 4H
// (gate o / H of unit o % H, column o of the core layout) and a contiguous
// slice of kpt <= KMAX (32 or 96) of the In + H contraction, where S = 256 / 4H lanes
// share an output (1, 2, 4, 8 for H = 64, 32, 16, 8).  At wavefront step s,
// CTA l computes t = s - l when 0 <= t < T:
//   1. it waits for x_l[t] (layer 0: copied from global memory with 4-byte
//      cp.async three steps ahead; layer l > 0: written by layer l-1);
//   2. each thread sums its slice of [x_l[t] | h_l[t-1]] (shared memory,
//      float4 broadcast) on FP32 FMAs, the S lanes of an output reduce with
//      xor shuffles, and it applies its gate's activation (a warp holds one
//      gate: no divergence at H >= 8) into a gate buffer;
//   3. after a block barrier, thread (row, unit) keeps c in a register, takes
//      the four activated gates, and writes h_l[t] into its own h buffer and
//      with st.async into layer l+1's input ring, which counts the bytes on
//      an mbarrier there (the last layer writes y[t] to global memory).
// The step ends with a block barrier and a cluster barrier whose arrive is
// relaxed (it orders execution, which the rings' reuse needs; the data's
// visibility is the mbarrier's): a barrier.cluster with release semantics
// costs 0.6-0.7 us on an H100, the relaxed one 0.06-0.09 us.
//
// R (rows per cluster) grows 1, 2, 4, 8 as the batch outgrows the clusters
// the card can hold at once (cudaOccupancyMaxActiveClusters); beyond R x
// that the clusters run in waves.  Rows are independent, and a row's order
// of arithmetic does not depend on R or B.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDepth = 8;       // the portable cluster size
constexpr int kThreads = 256;      // 4H x S: one output of the widest layer (H = 64) a thread
constexpr int kSlots = 4;          // the input ring: layer 0 fetches kSlots - 1 steps ahead
constexpr int kMaxRows = 8;
constexpr int kMaxSlice = 96;      // weights a thread holds: f64-d6's widest layer (32 -> 64)
constexpr size_t kMaxSmem = 48 * 1024;
constexpr int kBarFloats = 2 * kSlots;   // the input ring's mbarriers, ahead of the buffers
constexpr int kCellIters = (kMaxRows * 64 + kThreads - 1) / kThreads;   // (row, unit) a thread

struct StackArgs {
  const float* xs;                  // (T, B, In_0)
  float* y;                         // (T, B, H_last)
  const float* wx[kMaxDepth];       // (In, 4H)
  const float* wh[kMaxDepth];       // (H, 4H)
  const float* b[kMaxDepth];        // (4H)
  int in_dim[kMaxDepth];
  int hidden[kMaxDepth];
  int depth, t_len, batch;
  int vstride;                      // row stride (floats) of the ring's [x | h] vectors
  int hstride;                      // row stride (floats) of the gate buffer
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// lanes that split one output's contraction (0: the layer does not fit)
__host__ __device__ __forceinline__ int split_of(int hidden) {
  return hidden <= 8 ? 8 : hidden <= 16 ? 4 : hidden <= 32 ? 2 : hidden <= 64 ? 1 : 0;
}

// weights a thread holds: its slice of the padded In + H contraction
__host__ __device__ __forceinline__ int kpt_of(int in_dim, int hidden) {
  const int s = split_of(hidden);
  return round4((round4(in_dim) + round4(hidden) + s - 1) / s);
}

// floats of shared memory a CTA uses at R rows
__host__ __device__ __forceinline__ int smem_floats(int rows, int vstride, int hstride) {
  return kBarFloats + rows * (kSlots * vstride + 4 * hstride);
}

template <bool PWL>
__device__ __forceinline__ float sigmoid_act(float v) {
  if constexpr (PWL) {
    return fminf(fmaxf(fmaf(0.25f, v, 0.5f), 0.0f), 1.0f);
  } else {
    return 1.0f / (1.0f + expf(-v));
  }
}

template <bool PWL>
__device__ __forceinline__ float tanh_act(float v) {
  if constexpr (PWL) {
    return fminf(fmaxf(v, -1.0f), 1.0f);
  } else {
    return tanhf(v);
  }
}

__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every thread of the cluster; what each wrote before (shared memory of any
// CTA of the cluster included) is seen by all after: the prologue's
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the step's cluster barrier, split: the arrive orders no memory
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the address of `local` (shared memory of this CTA) in CTA `rank`'s shared
// memory, as a shared::cluster address
__device__ __forceinline__ unsigned cluster_addr(const void* local, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"((unsigned)__cvta_generic_to_shared(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(count) : "memory");
}

// arrive on `bar` expecting `bytes` of asynchronous stores in its phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// 4 bytes into another CTA's shared memory, counted on its mbarrier `bar`
// (both shared::cluster addresses) when they land: no fence, no barrier
__device__ __forceinline__ void st_async(unsigned dst, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// acc[r] += the slice's N4 float4s of row r's [x | h] against w, four FMA
// chains a row; the words past the contraction are clamped to its last
// float4 (finite, against zero weights), so the loads carry no branch and
// all issue ahead of the FMAs
template <int N4, int R, int KMAX>
__device__ __forceinline__ void slice_dot(float (&acc)[R][4], const float* vin,
                                          const float (&w)[KMAX], int k0, int k_last, int vs) {
#pragma unroll
  for (int j4 = 0; j4 < N4; ++j4) {
    const float* src = vin + min(k0 + 4 * j4, k_last);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(src + r * vs);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(comp(v, i), w[4 * j4 + i], acc[r][i]);
    }
  }
}

template <bool PWL, int R, int KMAX>
__global__ void __launch_bounds__(kThreads, 1) lstm_stack_kernel(const __grid_constant__ StackArgs a) {
  // partial sums per row, one per float4 lane: four FMA chains in flight, and
  // a row's order of summation whatever R is, so a row's result does not
  // depend on the batch it came in (data shards equal the whole, bit for bit)
  constexpr int NP = 4;
  const int vs_ = a.vstride, hs_ = a.hstride;
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [kSlots]: x_l[t] has landed
  // [kSlots][R][vstride]: slot t % kSlots holds [x_l[t] | h_l[t-1]] of each
  // row, x from layer l-1 (or global memory), h from this CTA a step before
  float* ring = smem + kBarFloats;
  float* gates = ring + kSlots * R * vs_;             // [4][R][hstride]: the activated gates

  cg::cluster_group cluster = cg::this_cluster();
  const int l = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / a.depth) * R;
  const int in_dim = a.in_dim[l];
  const int hidden = a.hidden[l];
  const int in_p = round4(in_dim);
  const int k_p = in_p + round4(hidden);
  const int split = split_of(hidden);
  const int kpt = kpt_of(in_dim, hidden);

  const int tid = threadIdx.x;
  const int out = tid / split;                         // column of the core layout
  const int gate = out / hidden;
  const int unit = out - gate * hidden;
  const bool live = out < 4 * hidden;
  const bool warp_live = (tid & ~31) / split < 4 * hidden;
  const bool lead = live && tid % split == 0;          // writes the output's gate
  const int k0 = (tid % split) * kpt;
  const int k_last = k_p - 4;

  for (int e = tid; e < smem_floats(R, vs_, hs_) - kBarFloats; e += kThreads) ring[e] = 0.0f;
  // layer l > 0: each slot's phase completes when the R x In floats of its
  // timestep have landed from layer l-1
  const unsigned in_bytes = (unsigned)(sizeof(float) * R * in_dim);
  if (tid == 0 && l > 0) {
    for (int slot = 0; slot < kSlots; ++slot) {
      mbar_init(&full[slot], 1);
      mbar_expect(&full[slot], in_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float w[KMAX];
  {
    const float* wx = a.wx[l];
    const float* wh = a.wh[l];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const int k = k0 + j;
      float v = 0.0f;
      if (live && j < kpt && k < k_p) {
        if (k < in_p) {
          if (k < in_dim) v = __ldg(wx + (size_t)k * 4 * hidden + out);
        } else if (k - in_p < hidden) {
          v = __ldg(wh + (size_t)(k - in_p) * 4 * hidden + out);
        }
      }
      w[j] = v;
    }
  }
  const float bias = live ? __ldg(a.b[l] + out) : 0.0f;

  // layer 0: x_t of this cluster's rows into ring slot t % kSlots, one group
  auto fetch = [&](int t) {
    if (t < a.t_len) {
      float* dst = ring + (t % kSlots) * R * vs_;
      const float* src = a.xs + ((size_t)t * a.batch + row0) * in_dim;
      for (int k = tid; k < in_dim; k += kThreads) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (row0 + r < a.batch) cp_async4(dst + r * vs_ + k, src + (size_t)r * in_dim + k);
        }
      }
    }
    cp_async_commit();
  };

  __syncthreads();   // the buffers are zero before any copy lands in them
  if (l == 0) {
    for (int t = 0; t < kSlots - 1; ++t) fetch(t);
    cp_async_wait<kSlots - 2>();   // x_0
  }
  const bool last = l + 1 == a.depth;
  const unsigned next_ring = last ? 0u : cluster_addr(ring, l + 1);  // layer l+1's ring
  const unsigned next_full = last ? 0u : cluster_addr(full, l + 1);
  cluster_barrier();   // every CTA of the cluster runs, has zeroed its buffers and set its mbarriers

  float c[kCellIters] = {};   // c of the (row, unit) pairs this thread updates
  const int steps = a.t_len + a.depth - 1;
  for (int s = 0; s < steps; ++s) {
    const int t = s - l;
    const bool active = t >= 0 && t < a.t_len;
    const int slot = t % kSlots;
    if (active && l > 0) {
      mbar_wait(&full[slot], (unsigned)(t / kSlots) & 1u);
      if (tid == 0) mbar_expect(&full[slot], in_bytes);   // its next phase: t + kSlots
    }
    if (active && warp_live) {
      const float* vin = ring + slot * R * vs_;
      float acc[R][NP];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int p = 0; p < NP; ++p) acc[r][p] = 0.0f;
      }
      // the layer's slice length picks the loop (the same for the whole CTA)
      if constexpr (KMAX >= 96) {
        if (kpt <= KMAX / 4) {
          slice_dot<KMAX / 16>(acc, vin, w, k0, k_last, vs_);
        } else if (kpt <= KMAX / 2) {
          slice_dot<KMAX / 8>(acc, vin, w, k0, k_last, vs_);
        } else {
          slice_dot<KMAX / 4>(acc, vin, w, k0, k_last, vs_);
        }
      } else {
        slice_dot<KMAX / 4>(acc, vin, w, k0, k_last, vs_);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sum = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
        for (int m = 1; m < split; m <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
        sum += bias;
        const float act = gate == 2 ? tanh_act<PWL>(sum) : sigmoid_act<PWL>(sum);
        if (lead) gates[(gate * R + r) * hs_ + unit] = act;
      }
    }
    // this step's reads of the input ring are done: layer l-1 may write the
    // slot again kSlots - 1 steps on, after this barrier's wait
    cluster_arrive_relaxed();
    if (l == 0) fetch(s + kSlots - 1);   // x three steps ahead, into the slot read a step ago
    __syncthreads();   // the gates are seen by the threads that update c
    if (active) {
#pragma unroll
      for (int j = 0; j < kCellIters; ++j) {
        const int p = tid + j * kThreads;
        if (p < R * hidden) {
          const int r = p / hidden;
          const int u = p - r * hidden;
          const float* g = gates + r * hs_ + u;
          c[j] = g[R * hs_] * c[j] + g[0] * g[2 * R * hs_];
          const float h = g[3 * R * hs_] * tanh_act<PWL>(c[j]);
          ring[(((t + 1) % kSlots) * R + r) * vs_ + in_p + u] = h;
          if (!last) {
            const unsigned off = (unsigned)((slot * R + r) * vs_ + u);
            st_async(next_ring + 4u * off, h, next_full + 8u * (unsigned)slot);
          } else if (row0 + r < a.batch) {
            a.y[((size_t)t * a.batch + row0 + r) * hidden + u] = h;
          }
        }
      }
    }
    if (l == 0) cp_async_wait<kSlots - 2>();   // x_{t+1} has landed (this thread's copies)
    __syncthreads();   // h_l[t] and x_0[t+1] are seen by the whole CTA
    cluster_wait();
  }
  if (l == 0) cp_async_wait<0>();
}

template <bool PWL, int R, int KMAX>
cudaLaunchConfig_t config_of(const StackArgs& a, int clusters, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.depth * clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * (size_t)smem_floats(R, a.vstride, a.hstride);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)a.depth;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of this instantiation the card holds at once (1 when the query
// fails), cached by what the occupancy query reads: the device, the cluster
// size (depth) and the dynamic shared memory (the stack's widths)
template <bool PWL, int R, int KMAX>
int capacity(const StackArgs& a) {
  struct Entry {
    int device, depth;
    size_t smem;
    int clusters;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess) (void)cudaGetLastError();
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config_of<PWL, R, KMAX>(a, 1, nullptr, &attr);
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.device == device && e.depth == a.depth && e.smem == cfg.dynamicSmemBytes) {
      return e.clusters;
    }
  }
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, lstm_stack_kernel<PWL, R, KMAX>, &cfg) != cudaSuccess) {
    (void)cudaGetLastError();
    n = 1;
  }
  n = n > 0 ? n : 1;
  if (used < 64) cache[used++] = {device, a.depth, cfg.dynamicSmemBytes, n};
  return n;
}

template <bool PWL, int R, int KMAX>
cudaError_t launch(const StackArgs& a, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const int clusters = (a.batch + R - 1) / R;
  cudaLaunchConfig_t cfg = config_of<PWL, R, KMAX>(a, clusters, stream, &attr);
  return cudaLaunchKernelEx(&cfg, lstm_stack_kernel<PWL, R, KMAX>, a);
}

// R: the fewest rows a cluster whose clusters all fit on the card at once
template <bool PWL, int KMAX>
int rows_for(const StackArgs& a) {
  if (a.batch <= capacity<PWL, 1, KMAX>(a)) return 1;
  if ((a.batch + 1) / 2 <= capacity<PWL, 2, KMAX>(a)) return 2;
  if ((a.batch + 3) / 4 <= capacity<PWL, 4, KMAX>(a)) return 4;
  return kMaxRows;
}

template <bool PWL, int KMAX>
cudaError_t dispatch_rows(const StackArgs& a, int rows, cudaStream_t s) {
  switch (rows) {
    case 1: return launch<PWL, 1, KMAX>(a, s);
    case 2: return launch<PWL, 2, KMAX>(a, s);
    case 4: return launch<PWL, 4, KMAX>(a, s);
    default: return launch<PWL, kMaxRows, KMAX>(a, s);
  }
}

// 0 when the stack does not fit, else the smallest KMAX instantiated that
// holds every layer's slice
int kmax_of(int depth, const int* in_dims, const int* hiddens) {
  if (depth < 1 || depth > kMaxDepth) return 0;
  int kpt = 0, vs = 0, hs = 0;
  for (int l = 0; l < depth; ++l) {
    if (in_dims[l] < 1 || hiddens[l] < 1 || split_of(hiddens[l]) == 0) return 0;
    if (l > 0 && in_dims[l] != hiddens[l - 1]) return 0;
    kpt = kpt > kpt_of(in_dims[l], hiddens[l]) ? kpt : kpt_of(in_dims[l], hiddens[l]);
    vs = vs > round4(in_dims[l]) + round4(hiddens[l]) ? vs : round4(in_dims[l]) + round4(hiddens[l]);
    hs = hs > round4(hiddens[l]) ? hs : round4(hiddens[l]);
  }
  if (sizeof(float) * (size_t)smem_floats(kMaxRows, vs, hs) > kMaxSmem) return 0;
  return kpt <= 32 ? 32 : kpt <= kMaxSlice ? kMaxSlice : 0;
}

StackArgs args_of(const void* xs, void* y, const void* const* wx, const void* const* wh,
                  const void* const* b, const int* in_dims, const int* hiddens, int depth,
                  int t_len, int batch) {
  StackArgs a = {};
  a.xs = static_cast<const float*>(xs);
  a.y = static_cast<float*>(y);
  a.depth = depth;
  a.t_len = t_len;
  a.batch = batch;
  for (int l = 0; l < depth; ++l) {
    if (wx != nullptr) {
      a.wx[l] = static_cast<const float*>(wx[l]);
      a.wh[l] = static_cast<const float*>(wh[l]);
      a.b[l] = static_cast<const float*>(b[l]);
    }
    a.in_dim[l] = in_dims[l];
    a.hidden[l] = hiddens[l];
    const int v = round4(in_dims[l]) + round4(hiddens[l]);
    a.vstride = a.vstride > v ? a.vstride : v;
    a.hstride = a.hstride > round4(hiddens[l]) ? a.hstride : round4(hiddens[l]);
  }
  return a;
}

template <bool PWL>
int rows_of(const StackArgs& a, int kmax) {
  switch (kmax) {
    case 32: return rows_for<PWL, 32>(a);
    default: return rows_for<PWL, kMaxSlice>(a);
  }
}

template <bool PWL>
cudaError_t dispatch(const StackArgs& a, int kmax, int rows, cudaStream_t s) {
  switch (kmax) {
    case 32: return dispatch_rows<PWL, 32>(a, rows, s);
    default: return dispatch_rows<PWL, kMaxSlice>(a, rows, s);
  }
}

}  // namespace

// Whether a stack fits the kernel (1) or not (0): depth <= 8, each layer's
// In equal to the previous layer's H, H <= 64, each thread's slice of
// In + H at most 96 weights, and the buffers at 8 rows within 48 KB.  The
// wrapper's Python rule (kernels/lstm_stack.py::fits) is the same.
extern "C" int lstm_stack_fits(int depth, const int* in_dims, const int* hiddens) {
  return kmax_of(depth, in_dims, hiddens) != 0;
}

// The rows per cluster a launch at this batch takes (0: the stack does not
// fit).  Exposed so that callers can log it.
extern "C" int lstm_stack_rows(int depth, const int* in_dims, const int* hiddens, int t_len,
                               int batch, int pwl) {
  const int kmax = kmax_of(depth, in_dims, hiddens);
  if (kmax == 0 || batch < 1) return 0;
  const StackArgs a = args_of(nullptr, nullptr, nullptr, nullptr, nullptr, in_dims, hiddens,
                              depth, t_len, batch);
  return pwl ? rows_of<true>(a, kmax) : rows_of<false>(a, kmax);
}

// Plain C interface (loaded with ctypes).  Pointers are device pointers of
// contiguous row-major f32 tensors: xs (T, B, In_0), y (T, B, H_last); for
// each layer wx (In, 4H), wh (H, 4H), b (4H) (arrays of depth pointers on
// the host).  Launches on `stream` and does not synchronise.  Returns
// cudaErrorInvalidValue for a stack that does not fit, else the launch's
// error (0 on success).
extern "C" int lstm_stack_forward(const void* xs, void* y, const void* const* wx,
                                  const void* const* wh, const void* const* b,
                                  const int* in_dims, const int* hiddens, int depth,
                                  int t_len, int batch, int pwl, void* stream) {
  (void)cudaGetLastError();  // attribute only this launch's error
  const int kmax = kmax_of(depth, in_dims, hiddens);
  if (kmax == 0 || t_len <= 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  const StackArgs a = args_of(xs, y, wx, wh, b, in_dims, hiddens, depth, t_len, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = pwl ? rows_of<true>(a, kmax) : rows_of<false>(a, kmax);
  const cudaError_t err = pwl ? dispatch<true>(a, kmax, rows, s) : dispatch<false>(a, kmax, rows, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
