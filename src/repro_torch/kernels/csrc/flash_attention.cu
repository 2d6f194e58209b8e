// Flash-attention forward for NVIDIA Hopper (sm_90a): online softmax over
// K/V tiles, one block per (batch*head, query tile of 64 rows), causal or not.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel).  As in the reference, the kernel is reached only
// through the public wrapper ops.flash_attention_op; no model layer calls it
// (layers/attention.py runs blocked_attention).
//
// Computes, per (b, h) and query row i, with scale = 1/sqrt(d) in f32:
//   s_ij = scale * (q_i . k_j)                 (products exact, sums in f32)
//   p_ij = exp(s_ij - m_i) over the visible keys, l_i = sum_j p_ij
//   o_i  = (sum_j p~_ij v_j) / max(l_i, 1e-30), written in q's type
// where p~ is p rounded to v's type (P is cast before P.V in the reference,
// flash_attention.py:63) relative to the running maximum, and, under
// `causal`, key j is visible to query i iff j <= i: the mask is aligned
// top-left, as the Pallas kernel's k_pos <= q_pos (flash_attention.py:53-55),
// also when S != Sk.  Any S and Sk, d in {64, 128}; rows of q, k, v and o are
// read and written through strides (d contiguous), so (B, S, H, d) tensors
// need no transpose.
//
// Which kernel serves which dtype (fixed; neither stands in for the other):
//   bf16 -> flash_fwd_mma_kernel<D, CAUSAL>: tensor cores (mma.sync).
//   f32  -> flash_fwd_kernel<D, float, CAUSAL>: FP32 FMAs, the first design,
//           kept as it was (the f32 bar of 2e-3 rules out TF32).
//
// Bound on an H100 SXM: 4*d FLOP per visible (query, key) pair (q.k and p.v),
// at 989 TFLOP/s for bf16 (dense tensor cores) and 67 TFLOP/s for f32 (FP32
// cores), against q, k, v, o once at 3.35 TB/s.  At phi4-mini-3.8b's heads
// (H = 24, d = 128), S = Sk = 4096, B = 4, causal: 4.1e11 FLOP, 0.42 ms in
// bf16 and 6.2 ms in f32; the operations bound both.
//
// bf16 design (FlashAttention-2 on mma.sync).  The first design widened
// bf16 q, k, v to f32 in shared memory and ran both products on FP32 FMAs
// (it could never leave the FP32 cores' 67 TFLOP/s), sent P through shared
// memory, and loaded tiles synchronously.  Here a block has 4 warps and 64
// query rows, 16 per warp.  Q, K and V stay bf16 in shared memory in rows
// padded by 16 bytes, so the ldmatrix reads of 8 rows at one column hit 8
// different bank groups.  Each warp loads its Q fragments (m16n8k16 A
// operands) into registers once, from a tile copied in with cp.async.
// K and V tiles of 64 keys are double-buffered and copied with cp.async
// (16 bytes a thread, zero-fill past Sk, so a stale or NaN row never meets
// a p of 0), tile t+1 in flight while tile t computes.  S = Q.K^T runs as
// mma.sync.m16n8k16 bf16 x bf16 -> f32 (exact products, f32 sums, as the
// FP32 path), K fragments from ldmatrix.x4.  The online softmax runs on the
// accumulators in registers: each thread holds two rows, row maxima take two
// shuffles in the quad, p = exp2(s*log2(e)/sqrt(d) - m) with the scale and
// log2(e) folded into one multiply; masked scores are -inf and their p is set
// to 0.  P is rounded to bf16 in registers and fed straight in as the A
// operand of P.V (the m16n8 accumulator layout is the A-fragment layout), V
// fragments from ldmatrix.x4.trans; o accumulates in f32 registers and is
// written as bf16 pairs.  Walk from KV tile 0 (every row meets key 0 first),
// stop at the last tile a row of the block can see, skip (per warp) a tile
// that none of the warp's rows can see, mask element-wise only on tiles that
// cross the diagonal or the Sk edge, and issue the last query tiles (the most
// K/V tiles under `causal`) first.  Shared memory: 46,080 bytes at d = 64,
// 87,040 at d = 128 (opt-in above 48 KB); 192-206 registers at d = 128, so
// two blocks (8 warps) share an SM.  Every q, k, v, o row must start on 16
// bytes (the wrapper checks pointers and strides).  At phi4-mini's heads it
// runs at about 185 TFLOP/s, 5x its bound: with 8 warps an SM has little to
// hide the latency of each warp's ldmatrix -> mma -> softmax chain, and a
// register cap that would fit more blocks spills (scripts/kernel_variants.py
// compares such variants on the card).
//
// f32 design (kept): a block of 256 threads owns 64 query rows; Q^T (f32)
// stays in shared memory, each tile stages K^T and V (f32), computes the
// 64 x 64 scores as 4 x 4 per thread, takes row maxima and sums with warp
// shuffles, writes P to shared memory and adds P.V into a 4 x d/16
// accumulator per thread.  Shared memory is 67,840 bytes at d = 64 and
// 118,272 bytes at d = 128.
//
// Left for later: wgmma with TMA loads and warp specialisation (producer
// warp, consumer warpgroups) for bf16, the only way to the tensor cores'
// full rate; for f32, 3xTF32 or larger FP32 register tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block (both kernels)
constexpr int kBK = 64;          // keys per K/V tile (both kernels)
constexpr int kThreads = 256;    // f32 kernel, 16 x 16: ty owns 4 rows, tx 4 keys / d/16 columns
constexpr int kQS = kBQ + 4;     // Q^T row stride (float4-aligned)
constexpr int kKS = kBK + 1;     // K^T row stride (conflict-free transposed writes)
constexpr int kPS = kBK + 4;     // P row stride (float4-aligned)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// v as the type T holds it (f32 holds it exactly)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * kQS + (size_t)D * kKS + (size_t)kBK * D + (size_t)kBQ * kPS);
}

struct Strides {   // element strides of a (B, H, S, d) view, d contiguous
  long long b, h, s;
};

template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int heads,
    int s_len, int sk_len, float scale) {
  constexpr int NC = D / 64;   // float4 column groups of the accumulator per thread
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;                  // [D][kQS]   Q^T
  float* kt_s = qt_s + D * kQS;        // [D][kKS]   K^T of the tile
  float* v_s = kt_s + D * kKS;         // [kBK][D]   V of the tile
  float* p_s = v_s + kBK * D;          // [kBQ][kPS] P of the tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int n_qt = (s_len + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBQ;   // last query tiles first
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int row = e / D;
    const int dd = e - row * D;
    const int qpos = q0 + row;
    qt_s[dd * kQS + row] = qpos < s_len ? to_f32(qb[qpos * qs.s + dd]) : 0.0f;
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[r][c] = 0.0f;
  }

  int n_kt = (sk_len + kBK - 1) / kBK;
  if (CAUSAL) {
    const int last_q = min(q0 + kBQ, s_len) - 1;    // the block's last real row
    n_kt = min(n_kt, last_q / kBK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // Q^T is staged; the last tile's K^T, V, P are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int row = e / D;
      const int dd = e - row * D;
      const int kpos = k0 + row;
      const bool ok = kpos < sk_len;
      kt_s[dd * kKS + row] = ok ? to_f32(kb[kpos * ks.s + dd]) : 0.0f;
      v_s[row * D + dd] = ok ? to_f32(vb[kpos * vs.s + dd]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.0f;
    }
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float4 qv = *reinterpret_cast<const float4*>(qt_s + dd * kQS + 4 * ty);
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = kt_s[dd * kKS + tx + 16 * c];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[0][c] = fmaf(qv.x, kv[c], sc[0][c]);
        sc[1][c] = fmaf(qv.y, kv[c], sc[1][c]);
        sc[2][c] = fmaf(qv.z, kv[c], sc[2][c]);
        sc[3][c] = fmaf(qv.w, kv[c], sc[3][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ty + r;
      const int qpos = q0 + row;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        vis[c] = kpos < sk_len && (!CAUSAL || kpos <= qpos);
        sc[r][c] = vis[c] ? sc[r][c] * scale : kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
      // the 16 threads of a row are lanes 16*(ty&1) .. +15 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = vis[c] ? expf(sc[r][c] - m_new) : 0.0f;
        sum += p;
        p_s[row * kPS + tx + 16 * c] = round_to(p, (const T*)nullptr);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();   // P of the whole tile is in shared memory

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pr[r] = *reinterpret_cast<const float4*>(p_s + (4 * ty + r) * kPS + kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(v_s + (kk + u) * D + 64 * c + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = comp(pr[r], u);
            acc[r][4 * c + 0] = fmaf(p, vv.x, acc[r][4 * c + 0]);
            acc[r][4 * c + 1] = fmaf(p, vv.y, acc[r][4 * c + 1]);
            acc[r][4 * c + 2] = fmaf(p, vv.z, acc[r][4 * c + 2]);
            acc[r][4 * c + 3] = fmaf(p, vv.w, acc[r][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + 4 * ty + r;
    if (qpos < s_len) {
      const float denom = fmaxf(l[r], 1e-30f);
      T* orow = ob + qpos * os.s;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(orow + 64 * c + 4 * tx + e, acc[r][4 * c + e] / denom);
      }
    }
  }
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int kMmaWarps = 4;                  // 16 query rows each
constexpr int kMmaBQ = 16 * kMmaWarps;        // query rows per block
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
constexpr size_t mma_smem_bytes() {   // Q, then 2 x K and 2 x V, rows of D + 8
  return sizeof(__nv_bfloat16) * (size_t)(kMmaBQ + 4 * kBK) * (size_t)(D + 8);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on one m16n8k16 tile: bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Copy rows row0 .. row0+ROWS-1 of a (rows, D) bf16 view with row stride `rs`
// into a [ROWS][D + 8] tile with cp.async; rows at or past n_rows are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int row0, int n_rows) {
  constexpr int CPR = D / 8;   // 16-byte pieces per row
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * CPR; e += kMmaThreads) {
    const int r = e / CPR;
    const int cc = e - r * CPR;
    const int pos = row0 + r;
    const bool ok = pos < n_rows;
    cp_async16(smem_addr(dst + r * (D + 8) + cc * 8), ok ? src + pos * rs + cc * 8 : src, ok);
  }
}

// Block: kMmaWarps warps; warp w owns query rows q0 + 16w .. q0 + 16w + 15.  In a
// warp, lane = 4 * g + t: the thread holds rows g and g + 8 of the warp's 16
// and, in every n8 tile of scores or output, columns 2t and 2t + 1.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kMmaThreads, 1) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Strides qs,
    Strides ks, Strides vs, Strides os, int heads, int s_len, int sk_len, float scale_log2) {
  constexpr int LD = D + 8;      // shared-memory row stride, elements
  constexpr int KSTEPS = D / 16; // k16 steps of Q.K^T
  constexpr int NO = D / 8;      // n8 tiles of the output
  constexpr int NS = kBK / 8;    // n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);   // [kMmaBQ][LD]
  __nv_bfloat16* k_s = q_s + kMmaBQ * LD;                             // [2][64][LD]
  __nv_bfloat16* v_s = k_s + 2 * kBK * LD;                            // [2][64][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int n_qt = (s_len + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kMmaBQ;   // last query tiles first
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  const int w0 = q0 + 16 * warp;      // the warp's first query row
  const int row_a = w0 + g;           // the thread's two query rows
  const int row_b = row_a + 8;

  int n_kt = (sk_len + kBK - 1) / kBK;
  if (CAUSAL) {
    const int last_q = min(q0 + kMmaBQ, s_len) - 1;    // the block's last real row
    n_kt = min(n_kt, last_q / kBK + 1);
  }

  load_tile<D, kMmaBQ>(q_s, qb, qs.s, q0, s_len);
  cp_async_commit();
  load_tile<D, kBK>(k_s, kb, ks.s, 0, sk_len);
  load_tile<D, kBK>(v_s, vb, vs.s, 0, sk_len);
  cp_async_commit();

  cp_async_wait<1>();   // Q has landed
  __syncthreads();
  unsigned qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ldsm_x4(smem_addr(q_s + (16 * warp + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4)), qf[kk]);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};   // this thread's share of the row sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * kBK;
    if (kt + 1 < n_kt) {
      load_tile<D, kBK>(k_s + (buf ^ 1) * kBK * LD, kb, ks.s, k0 + kBK, sk_len);
      load_tile<D, kBK>(v_s + (buf ^ 1) * kBK * LD, vb, vs.s, k0 + kBK, sk_len);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile kt has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    const __nv_bfloat16* kt_s = k_s + buf * kBK * LD;
    const __nv_bfloat16* vt_s = v_s + buf * kBK * LD;
    // under `causal` a warp whose rows all precede the tile sees none of it
    // (its p would all be 0 and alpha 1), so it skips the tile
    if (!CAUSAL || k0 <= w0 + 15) {
      // S = Q . K^T: 16 rows x 64 keys per warp
      float sc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {   // keys 16np .. 16np + 15
          unsigned kf[4];
          ldsm_x4(smem_addr(kt_s + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                            8 * ((lane >> 3) & 1)),
                  kf);
          mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // online softmax in the log2 domain; element e of a tile is row e >> 1
      const bool masked = k0 + kBK > sk_len || (CAUSAL && k0 + kBK - 1 > w0);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[n][e] * scale_log2;
          if (masked) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const bool vis = key < sk_len && (!CAUSAL || key <= (e < 2 ? row_a : row_b));
            s = vis ? s : -INFINITY;
          }
          sc[n][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sc[n][e];
          const float p = (masked && s == -INFINITY) ? 0.0f : exp2f(s - mx[e >> 1]);
          l_run[e >> 1] += p;
          sc[n][e] = p;
        }
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P . V, P rounded to bf16 in registers as the A operand
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {   // keys 16kk .. 16kk + 15
        const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {   // output columns 16dp .. 16dp + 15
          unsigned vf[4];
          ldsm_x4_trans(smem_addr(vt_s + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                  16 * dp + 8 * (lane >> 4)),
                        vf);
          mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // the next iteration copies into this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = r == 0 ? row_a : row_b;
    if (row >= s_len) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow = ob + row * os.s;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
  }
}

template <int D, bool CAUSAL>
int launch_mma(const void* q, const void* k, const void* v, void* o, const Strides* st,
               int batch, int heads, int s_len, int sk_len, float scale_log2,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)batch * (unsigned)heads, (unsigned)((s_len + kMmaBQ - 1) / kMmaBQ));
  flash_fwd_mma_kernel<D, CAUSAL><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), st[0], st[1],
      st[2], st[3], heads, s_len, sk_len, scale_log2);
  return (int)cudaGetLastError();
}

// ---- host side --------------------------------------------------------------

template <int D, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, void* o, const Strides* st,
               int batch, int heads, int s_len, int sk_len, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, float, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)batch * (unsigned)heads, (unsigned)((s_len + kBQ - 1) / kBQ));
  flash_fwd_kernel<D, float, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st[0], st[1], st[2], st[3], heads, s_len, sk_len, scale);
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL>
int launch(int is_bf16, const void* q, const void* k, const void* v, void* o, const Strides* st,
           int batch, int heads, int s_len, int sk_len, double scale, cudaStream_t s) {
  if (is_bf16) {
    return launch_mma<D, CAUSAL>(q, k, v, o, st, batch, heads, s_len, sk_len,
                                 (float)(scale * 1.4426950408889634), s);
  }
  return launch_f32<D, CAUSAL>(q, k, v, o, st, batch, heads, s_len, sk_len, (float)scale, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Which kernel serves (dtype, d, causal), as written above; for logs.
extern "C" const char* flash_attention_kernel_name(int is_bf16, int head_dim, int causal) {
  if (head_dim != 64 && head_dim != 128) return "none (d must be 64 or 128)";
  static const char* names[2][2][2] = {
      {{"flash_fwd_kernel<64, float, false> (FP32 FMAs)",
        "flash_fwd_kernel<64, float, true> (FP32 FMAs)"},
       {"flash_fwd_kernel<128, float, false> (FP32 FMAs)",
        "flash_fwd_kernel<128, float, true> (FP32 FMAs)"}},
      {{"flash_fwd_mma_kernel<64, false> (bf16 mma.sync m16n8k16)",
        "flash_fwd_mma_kernel<64, true> (bf16 mma.sync m16n8k16)"},
       {"flash_fwd_mma_kernel<128, false> (bf16 mma.sync m16n8k16)",
        "flash_fwd_mma_kernel<128, true> (bf16 mma.sync m16n8k16)"}}};
  return names[is_bf16 ? 1 : 0][head_dim == 128 ? 1 : 0][causal ? 1 : 0];
}

// Plain C interface (loaded with ctypes).  q (B, H, S, d), k and v
// (B, H, Sk, d) and o (B, H, S, d) are device pointers to views of the type
// named by is_bf16 with d contiguous; `strides` holds 12 element strides,
// (batch, head, row) of q, k, v, o in turn.  o must not overlap the inputs.
// d is 64 or 128.  bf16 needs every row of q, k, v, o to start on 16 bytes.
// Launches once on `stream` and does not synchronise.  Returns 0 or a
// cudaError_t (cudaErrorInvalidValue for a shape it does not take,
// cudaErrorMisalignedAddress for a bf16 view off 16 bytes, or
// cudaGetLastError() after the launch).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       const long long* strides, int batch, int heads,
                                       int s_len, int sk_len, int head_dim, int is_bf16,
                                       int causal, void* stream) {
  (void)cudaGetLastError();  // attribute only this launch's error
  if (batch <= 0 || heads <= 0 || s_len <= 0 || sk_len <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)batch * heads > 0x7fffffffLL || (s_len + kBQ - 1) / kBQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (is_bf16) {
    // every row starts on 16 bytes: base pointers, and the strides of the
    // dimensions longer than 1, in multiples of 8 elements
    const int sizes[12] = {batch, heads, s_len, batch, heads, sk_len,
                           batch, heads, sk_len, batch, heads, s_len};
    bool ok = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
    for (int i = 0; i < 12; ++i) ok = ok && (sizes[i] == 1 || strides[i] % 8 == 0);
    if (!ok) return (int)cudaErrorMisalignedAddress;
  }
  const double scale = 1.0 / sqrt((double)head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return causal ? launch<64, true>(is_bf16, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s)
                  : launch<64, false>(is_bf16, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s);
  }
  if (head_dim == 128) {
    return causal ? launch<128, true>(is_bf16, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s)
                  : launch<128, false>(is_bf16, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
