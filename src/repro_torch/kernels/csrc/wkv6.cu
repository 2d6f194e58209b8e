// RWKV-6 WKV recurrence for NVIDIA Hopper (sm_90a): each (batch, head) is
// one team of threads that runs the whole time loop with the head's state
// in registers, register-tiled so that three FP32 instructions serve each
// state element per step.
//
// Replaces: src/repro/kernels/wkv6.py::wkv6_pallas (body _wkv6_kernel).  As
// in the reference, the kernel is reached only through the public wrapper
// ops.wkv6_op; no model layer calls it (layers/rwkv.py runs its own scan).
//
// Computes, per (b, h) and t = 0 .. T-1, with S the (hd, hd) f32 state:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r, k, v are f32 or bf16 (widened to f32, as the reference casts them); w,
// u, s0 are f32; y and the final state S_T are written in f32.
//
// Bound on an H100 SXM: the least work is y = r.S + (r.(u*k)) v and
// S <- w*S + k^T v, 5*hd^2 FLOP per (b, h, t) on the FP32 cores (67 TFLOP/s),
// against the bytes of r, k, v, w, u, s0 read once and y, S_T written once
// at 3.35 TB/s.  At rwkv6-7b's heads (H = 64, hd = 64), T = 4096, B = 32:
// 1.7e11 FLOP (2.56 ms) against 10.8 GB (3.23 ms) in f32: bytes bound it.
// The kernel's own floor is its FP32 issue: three instructions per state
// element and step (3.44e10 elements there, 3.08 ms at 132 SMs x 128 lanes
// x 1.98 GHz), under the byte bound.
//
// Design.
// - The bonus term leaves the inner loop: y_t[j] = sum_i r_i S[i][j] +
//   a_t v_j with a_t = sum_i r_i u_i k_i, one scalar per (b, h, t) computed
//   when a chunk is staged.  Per element and step the loop issues FFMA for
//   y, FMUL for k_i v_j and FFMA for S = fma(w_i, S, k_i v_j), which rounds
//   S exactly as the one-column-per-thread kernel before it did; only y's
//   sum is reassociated (row groups, then a tree over them, then a_t v_j).
// - Register tiles: a thread holds R = hd / G rows x C columns of S (hd =
//   64: 16 x 4, 64 registers).  The G threads that share a column group
//   sit in one warp, L = 32 / G lanes apart; the L lanes of one row group
//   read the same rows, so each 128-bit shared load of four rows of r, k
//   or w is a broadcast and serves C columns.  The G partial y are summed
//   by a shuffle reduce-scatter (log2 C halving steps, then a butterfly
//   over the rest), after which each thread owns one column and a warp
//   stores 32 neighbouring floats.  Each thread's y is C chains of R.
// - Streams: r, k, v, w of kChunk steps per stage go to a kStages-deep ring
//   in shared memory by 16-byte cp.async (zeros past T); while chunk c is
//   computed, chunk c+1 is prepared (a_t, and bf16 rows widened to f32 into
//   a double buffer) and chunk c+2 is in flight.  One __syncthreads() per
//   chunk.  At hd = 64 a head keeps 8 KB (f32) in flight.  The step loop
//   is unrolled over the whole chunk.
// - Tile rule (Tile<HD>): G = min(kGroups, hd / 4) row groups, C = min(4,
//   hd / 8) columns; a head is G * hd / C threads (64, 32, 32 for hd = 64,
//   32, 16) and a block holds kBlockThreads / that many heads.  Launch
//   bounds cap a thread at kMaxRegs registers, so at hd = 64 an SM holds 8
//   heads (4 blocks of 2; 192 KB of ring in f32, 216 KB with the bf16
//   widening buffers): B = 32 (2048 heads) is 1.94 waves of 1056, B = 8
//   (512) one wave of ~4 heads per SM.
// - What holds it at about half its FP32 issue floor on an H100 (PERF.md):
//   instruction issue.  A thread issues ~260 instructions per step (the
//   chunk's staging work included) for 192 FP32 ones, in ~72% of the
//   schedulers' clocks at full clock, with B = 8 and B = 32 at nearly the
//   same rate per head; neither shared loads (halving them moved nothing),
//   the ring's depth nor the heads per block set it.
//
// Left for later: the chunked form of the recurrence on tensor cores (its
// division by cumulative decays overflows for fast-decaying channels).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kGroups = 4;          // row groups: threads that share a column
constexpr int kMaxCols = 4;         // columns of S per thread
constexpr int kChunk = 8;           // timesteps per ring stage
constexpr int kStages = 3;          // ring: computed, prepared, in flight
constexpr int kBlockThreads = 128;  // threads per block the rule aims at
constexpr int kStepUnroll = 8;      // timesteps of a chunk unrolled
constexpr int kMaxRegs = 128;       // registers per thread under the launch bounds

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

template <int HD>
struct Tile {
  static constexpr int G = HD / 4 < kGroups ? HD / 4 : kGroups;  // row groups
  static constexpr int R = HD / G;                               // rows per thread
  static constexpr int C = HD / 8 < kMaxCols ? HD / 8 : kMaxCols;  // columns per thread
  static constexpr int L = 32 / G;                               // column groups per warp
  static constexpr int P = G * HD / C;                           // threads per head
  static constexpr int HPB = kBlockThreads / P > 0 ? kBlockThreads / P : 1;  // heads per block
  static constexpr int THREADS = HPB * P;
  // threads per step for a_t (each sums whole quads of rows)
  static constexpr int Q = P / kChunk < HD / 4 ? P / kChunk : HD / 4;
  static_assert(R % 4 == 0 && C >= 1 && C <= G && L * C <= HD, "tile");
  static_assert(P % 32 == 0 && P >= kChunk && (HD / 4) % Q == 0 && Q <= 32, "tile");
};

// Shared memory of one head, in bytes: the ring (r, k, v in T, then w in
// f32, per stage), the widened r, k, v (bf16 only, double-buffered), u,
// and a_t (double-buffered).
template <int HD, typename T>
struct Smem {
  static constexpr bool kWiden = sizeof(T) != 4;
  static constexpr size_t kStream = (size_t)kChunk * HD;        // elements of one stream
  static constexpr size_t kStage = kStream * (3 * sizeof(T) + 4);
  static constexpr size_t kWide = kWiden ? 3 * kStream * 4 : 0;
  static constexpr size_t kRing = kStages * kStage;
  static constexpr size_t kU = kRing + 2 * kWide;
  static constexpr size_t kA = kU + HD * 4;
  static constexpr size_t kHead = kA + 2 * kChunk * 4;
  static_assert(kStage % 16 == 0 && kWide % 16 == 0 && kHead % 16 == 0, "alignment");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0: fill zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// the two bf16 of a 32-bit word (low one first) as f32: exact, a shift each
__device__ __forceinline__ float bf16_lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y), bf16_hi(raw.y));
}

// Copy chunk `t0 / kChunk` of one head's four streams into a ring stage.
template <int HD, typename T>
__device__ __forceinline__ void issue_chunk(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, unsigned char* stage, size_t head_off, size_t row_stride,
    int t0, int t_len, int p) {
  constexpr int P = Tile<HD>::P;
  constexpr int kPer = 16 / (int)sizeof(T);     // elements per 16-byte piece
  constexpr int kRow = HD / kPer;               // pieces per row
  T* st = reinterpret_cast<T*>(stage);
  for (int q = p; q < 3 * kChunk * kRow; q += P) {
    const int s = q / (kChunk * kRow);
    const int rem = q - s * (kChunk * kRow);
    const int tt = rem / kRow;
    const int col = (rem - tt * kRow) * kPer;
    const T* src = s == 0 ? r : (s == 1 ? k : v);
    const bool ok = t0 + tt < t_len;
    cp_async16(st + (size_t)(s * kChunk + tt) * HD + col,
               src + (ok ? head_off + (size_t)(t0 + tt) * row_stride + col : 0), ok);
  }
  float* sw = reinterpret_cast<float*>(stage + Smem<HD, T>::kStream * 3 * sizeof(T));
  for (int q = p; q < kChunk * (HD / 4); q += P) {
    const int tt = q / (HD / 4);
    const int col = (q - tt * (HD / 4)) * 4;
    const bool ok = t0 + tt < t_len;
    cp_async16(sw + tt * HD + col, w + (ok ? head_off + (size_t)(t0 + tt) * row_stride + col : 0),
               ok);
  }
}

// Prepare a landed stage: a_t = sum_i r_i u_i k_i for each of its steps,
// and (bf16) r, k, v widened to f32.
template <int HD, typename T>
__device__ __forceinline__ void prepare_chunk(const unsigned char* stage, float* wide,
                                              const float* us, float* as, int p) {
  using Tl = Tile<HD>;
  const T* st = reinterpret_cast<const T*>(stage);
  const int tt = p / Tl::Q;            // past kChunk: no step, but in the shuffles
  const int l = p - tt * Tl::Q;
  const T* rr = st + tt * HD;
  const T* kk = st + Smem<HD, T>::kStream + tt * HD;
  float a = 0.0f;
  if (tt < kChunk) {
#pragma unroll
    for (int m = 0; m < HD / 4 / Tl::Q; ++m) {
      const int i = 4 * (l + Tl::Q * m);
      const float4 r4 = load4(rr + i), k4 = load4(kk + i), u4 = load4(us + i);
      a = fmaf(r4.x * u4.x, k4.x, a);
      a = fmaf(r4.y * u4.y, k4.y, a);
      a = fmaf(r4.z * u4.z, k4.z, a);
      a = fmaf(r4.w * u4.w, k4.w, a);
    }
  }
#pragma unroll
  for (int m = 1; m < Tl::Q; m *= 2) a += __shfl_xor_sync(0xffffffffu, a, m);
  if (l == 0 && tt < kChunk) as[tt] = a;
  if constexpr (Smem<HD, T>::kWiden) {
    for (int q = p; q < 3 * kChunk * HD / 8; q += Tl::P) {
      const uint4 raw = *reinterpret_cast<const uint4*>(st + 8 * q);
      *reinterpret_cast<float4*>(wide + 8 * q) =
          make_float4(bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y), bf16_hi(raw.y));
      *reinterpret_cast<float4*>(wide + 8 * q + 4) =
          make_float4(bf16_lo(raw.z), bf16_hi(raw.z), bf16_lo(raw.w), bf16_hi(raw.w));
    }
  }
}

// Sum each of C columns over the G threads that share them (lanes L
// apart); returns the sum of column `col_of(g)` of this thread's group.
template <int C, int L>
__device__ __forceinline__ float reduce_columns(float (&acc)[C], int g) {
#pragma unroll
  for (int s = 0; s < ilog2(C); ++s) {    // halving: keep one half, send the other
    const int n = C >> (s + 1);
    const bool hi = (g >> s) & 1;
#pragma unroll
    for (int q = 0; q < n; ++q) {
      const float send = hi ? acc[q] : acc[q + n];
      const float keep = hi ? acc[q + n] : acc[q];
      acc[q] = keep + __shfl_xor_sync(0xffffffffu, send, L << s);
    }
  }
#pragma unroll
  for (int m = L * C; m < 32; m *= 2) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], m);
  return acc[0];
}

// The column of its group that reduce_columns leaves to row group g.
template <int C>
__device__ __forceinline__ int col_of(int g) {
  int col = 0;
#pragma unroll
  for (int s = 0; s < ilog2(C); ++s) col += ((g >> s) & 1) * (C >> (s + 1));
  return col;
}

// Block: Tile<HD>::HPB heads of P threads; head slot hs of block x is
// (b, h) = x * HPB + hs (past B * H it recomputes the last head and stores
// nothing).  Streams are (B, T, H, HD) row-major, rows 16-byte aligned.
template <int HD, typename T>
__global__ void __launch_bounds__(Tile<HD>::THREADS, 65536 / (kMaxRegs * Tile<HD>::THREADS))
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ s_out,
            int t_len, int heads, int n_heads) {
  using Tl = Tile<HD>;
  using Sm = Smem<HD, T>;
  constexpr int R = Tl::R, C = Tl::C, L = Tl::L;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = threadIdx.x / Tl::P;
  const int p = threadIdx.x - hs * Tl::P;
  const int bh_raw = blockIdx.x * Tl::HPB + hs;
  const bool valid = bh_raw < n_heads;
  const int bh = valid ? bh_raw : n_heads - 1;
  const int b = bh / heads;
  const int h = bh - b * heads;
  unsigned char* hsm = smem + (size_t)hs * Sm::kHead;
  float* us = reinterpret_cast<float*>(hsm + Sm::kU);
  float* as = reinterpret_cast<float*>(hsm + Sm::kA);
  float* wide = reinterpret_cast<float*>(hsm + Sm::kRing);

  const int lane = p & 31;
  const int g = lane / L;
  const int cg = (p >> 5) * L + (lane - g * L);        // column group
  const int col = cg * C + col_of<C>(g);               // the column this thread stores
  const size_t row_stride = (size_t)heads * HD;
  const size_t head_off = ((size_t)b * t_len * heads + h) * HD;

  for (int i = p; i < HD; i += Tl::P) us[i] = u[h * HD + i];
  float s[R][C];
  const float* s0p = s0 + (size_t)bh * HD * HD + (size_t)(g * R) * HD + cg * C;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) s[i][c] = s0p[(size_t)i * HD + c];

  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  auto stage_of = [&](int c) { return hsm + (size_t)(c % kStages) * Sm::kStage; };
  issue_chunk<HD, T>(r, k, v, w, stage_of(0), head_off, row_stride, 0, t_len, p);
  cp_async_commit();
  if (n_chunks > 1) {
    issue_chunk<HD, T>(r, k, v, w, stage_of(1), head_off, row_stride, kChunk, t_len, p);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  prepare_chunk<HD, T>(stage_of(0), wide, us, as, p);

  for (int c = 0; c < n_chunks; ++c) {
    // chunk c+1 has landed; chunk c is prepared; every read of chunk c-1 is done
    cp_async_wait<0>();
    __syncthreads();
    if (c + 2 < n_chunks) {
      issue_chunk<HD, T>(r, k, v, w, stage_of(c + 2), head_off, row_stride, (c + 2) * kChunk,
                         t_len, p);
    }
    cp_async_commit();
    const int nb = (c + 1) & 1;
    if (c + 1 < n_chunks) {
      prepare_chunk<HD, T>(stage_of(c + 1), wide + nb * (Sm::kWide / 4), us, as + nb * kChunk, p);
    }
    const unsigned char* st = stage_of(c);
    const float* rs = Sm::kWiden ? wide + (c & 1) * (Sm::kWide / 4)
                                 : reinterpret_cast<const float*>(st);
    const float* ks = rs + Sm::kStream;
    const float* vs = ks + Sm::kStream;
    const float* ws = reinterpret_cast<const float*>(st + Sm::kStream * 3 * sizeof(T));
    const float* ac = as + (c & 1) * kChunk;
    const int t0 = c * kChunk;
    const int n = min(kChunk, t_len - t0);
#pragma unroll (kStepUnroll)
    for (int tt = 0; tt < n; ++tt) {
      const float* rr = rs + tt * HD + g * R;
      const float* kk = ks + tt * HD + g * R;
      const float* wr = ws + tt * HD + g * R;
      float vv[C];
      if constexpr (C % 4 == 0) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 v4 = load4(vs + tt * HD + cg * C + 4 * q);
          vv[4 * q] = v4.x; vv[4 * q + 1] = v4.y; vv[4 * q + 2] = v4.z; vv[4 * q + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) vv[cc] = vs[tt * HD + cg * C + cc];
      }
      float acc[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) acc[cc] = 0.0f;
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 r4 = load4(rr + 4 * q), k4 = load4(kk + 4 * q), w4 = load4(wr + 4 * q);
        const float re[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ke[4] = {k4.x, k4.y, k4.z, k4.w};
        const float we[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int cc = 0; cc < C; ++cc) {
            float& sij = s[4 * q + e][cc];
            acc[cc] = fmaf(re[e], sij, acc[cc]);
            sij = fmaf(we[e], sij, ke[e] * vv[cc]);
          }
        }
      }
      const float yj = fmaf(ac[tt], vs[tt * HD + col], reduce_columns<C, L>(acc, g));
      if (valid) y[head_off + (size_t)(t0 + tt) * row_stride + col] = yj;
    }
  }
  if (valid) {
    float* sp = s_out + (size_t)bh * HD * HD + (size_t)(g * R) * HD + cg * C;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) sp[(size_t)i * HD + c] = s[i][c];
  }
}

template <int HD, typename T>
size_t block_smem() { return Tile<HD>::HPB * Smem<HD, T>::kHead; }

template <int HD, typename T>
cudaError_t prepare_launch() {
  return cudaFuncSetAttribute(wkv6_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)block_smem<HD, T>());
}

template <int HD, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int batch,
           int t_len, int heads, cudaStream_t stream) {
  using Tl = Tile<HD>;
  const cudaError_t e = prepare_launch<HD, T>();
  if (e != cudaSuccess) return (int)e;
  const int n_heads = batch * heads;
  const dim3 grid((unsigned)((n_heads + Tl::HPB - 1) / Tl::HPB));
  wkv6_kernel<HD, T><<<grid, Tl::THREADS, block_smem<HD, T>(), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_out), t_len, heads, n_heads);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int tile(int* out) {
  using Tl = Tile<HD>;
  const cudaError_t e = prepare_launch<HD, T>();
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  const cudaError_t o = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, wkv6_kernel<HD, T>, Tl::THREADS, block_smem<HD, T>());
  if (o != cudaSuccess) return (int)o;
  const int vals[9] = {Tl::R, Tl::C, Tl::P, Tl::HPB, Tl::THREADS,
                       (int)block_smem<HD, T>(), kChunk, kStages, blocks};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

template <typename T>
int dispatch(int head_dim, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* y, void* s_out,
             int batch, int t_len, int heads, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<16, T>(r, k, v, w, u, s0, y, s_out, batch, t_len, heads, s);
    case 32: return launch<32, T>(r, k, v, w, u, s0, y, s_out, batch, t_len, heads, s);
    case 64: return launch<64, T>(r, k, v, w, u, s0, y, s_out, batch, t_len, heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_tile(int head_dim, int* out) {
  switch (head_dim) {
    case 16: return tile<16, T>(out);
    case 32: return tile<32, T>(out);
    case 64: return tile<64, T>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Device pointers of contiguous
// row-major tensors: r, k, v (B, T, H, hd) of the type named by is_bf16;
// w (B, T, H, hd), u (H, hd), s0 (B, H, hd, hd) f32; y (B, T, H, hd) and
// s_out (B, H, hd, hd) f32, not overlapping the inputs; r, k, v, w start
// on 16 bytes.  hd is 16, 32 or 64.  Launches once on `stream` and does not
// synchronise.  Returns 0 or a cudaError_t (cudaErrorInvalidValue for a
// shape it does not take, or cudaGetLastError() after the launch).
extern "C" int wkv6_forward(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, int batch, int t_len,
                            int heads, int head_dim, int is_bf16, void* stream) {
  (void)cudaGetLastError();  // attribute only this launch's error
  if (batch <= 0 || t_len <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)batch * heads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(head_dim, r, k, v, w, u, s0, y, s_out, batch, t_len, heads, s);
  }
  return dispatch<float>(head_dim, r, k, v, w, u, s0, y, s_out, batch, t_len, heads, s);
}

// The tile of a launch at this head dim and type on the current device, so
// that callers can log it: out[0..8] = rows and columns of S per thread,
// threads per head, heads per block, threads per block, shared memory per
// block (bytes), timesteps per stage, ring stages, and resident blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns 0 or a
// cudaError_t.
extern "C" int wkv6_tile(int head_dim, int is_bf16, int* out) {
  (void)cudaGetLastError();
  return is_bf16 ? dispatch_tile<__nv_bfloat16>(head_dim, out) : dispatch_tile<float>(head_dim, out);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
