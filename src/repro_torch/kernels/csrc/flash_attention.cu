// Flash-attention forward for NVIDIA Hopper (sm_90a): online softmax over
// K/V tiles, one block per (batch*head, query tile of 64 rows), causal or not.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel).  As in the reference, the kernel is reached only
// through the public wrapper ops.flash_attention_op; no model layer calls it
// (layers/attention.py runs blocked_attention).
//
// Computes, per (b, h) and query row i, with scale = 1/sqrt(d) in f32:
//   s_ij = scale * (q_i . k_j)                 (sums in f32)
//   p_ij = exp(s_ij - m_i) over the visible keys, l_i = sum_j p_ij
//   o_i  = (sum_j p~_ij v_j) / max(l_i, 1e-30), written in q's type
// where p~ is p rounded to v's type (P is cast before P.V in the reference,
// flash_attention.py:63; f32 P is not rounded) relative to the running
// maximum, and, under `causal`, key j is visible to query i iff j <= i: the
// mask is aligned top-left, as the Pallas kernel's k_pos <= q_pos
// (flash_attention.py:53-55), also when S != Sk.  Any S and Sk, d in
// {64, 128}; rows of q, k, v and o are read and written through strides (d
// contiguous), so (B, S, H, d) tensors need no transpose.
//
// Which kernel serves which dtype (fixed; neither stands in for the other):
//   bf16 -> flash_fwd_mma_kernel<D, CAUSAL>: mma.sync m16n8k16 bf16.
//   f32  -> flash_fwd_tf32x3_kernel<D, CAUSAL, VEC>: 3xTF32 on mma.sync
//           m16n8k8; VEC picks the copy path (16-byte cp.async when every
//           row of q, k, v, o starts on 16 bytes, else 4-byte cp.async).
//
// Bound on an H100 SXM: 4*d FLOP per visible (query, key) pair (q.k and p.v)
// against q, k, v, o once at 3.35 TB/s.  bf16 runs at 989 TFLOP/s (dense
// tensor cores).  f32 runs three TF32 products per product (below), so its
// bound is 3 x its FLOP at 495 TFLOP/s (TF32 tensor cores); on the FP32
// cores it would be 1 x at 67 TFLOP/s.  At phi4-mini-3.8b's heads (H = 24,
// d = 128), S = Sk = 4096, B = 4, causal: 4.1e11 FLOP, 0.42 ms in bf16, 2.50
// ms in f32 (6.2 ms on the FP32 cores); the operations bound both.
//
// bf16 design (FlashAttention-2 on mma.sync).  A block has 4 warps and 64
// query rows, 16 per warp.  Q, K and V stay bf16 in shared memory in rows
// padded by 16 bytes, so the ldmatrix reads of 8 rows at one column hit 8
// different bank groups.  Each warp loads its Q fragments (m16n8k16 A
// operands) into registers once, from a tile copied in with cp.async.
// K and V tiles of 64 keys are double-buffered and copied with cp.async
// (16 bytes a thread, zero-fill past Sk, so a stale or NaN row never meets
// a p of 0), tile t+1 in flight while tile t computes.  S = Q.K^T runs as
// mma.sync.m16n8k16 bf16 x bf16 -> f32 (exact products, f32 sums), K
// fragments from ldmatrix.x4.  The online softmax runs on the accumulators
// in registers: each thread holds two rows, row maxima take two shuffles in
// the quad, p = exp2(s*log2(e)/sqrt(d) - m) with the scale and log2(e)
// folded into one multiply; masked scores are -inf and their p is set to 0.
// P is rounded to bf16 in registers and fed straight in as the A operand of
// P.V (the m16n8 accumulator layout is the A-fragment layout), V fragments
// from ldmatrix.x4.trans; o accumulates in f32 registers and is written as
// bf16 pairs.  Walk from KV tile 0 (every row meets key 0 first), stop at the
// last tile a row of the block can see, skip (per warp) a tile that none of
// the warp's rows can see, mask element-wise only on tiles that cross the
// diagonal or the Sk edge, and issue the last query tiles (the most K/V
// tiles under `causal`) first.  Shared memory: 46,080 bytes at d = 64,
// 87,040 at d = 128 (opt-in above 48 KB); 192-206 registers at d = 128, so
// two blocks (8 warps) share an SM.  Every q, k, v, o row must start on 16
// bytes (the wrapper checks pointers and strides).  At phi4-mini's heads it
// runs at about 185 TFLOP/s, 5x its bound.
//
// f32 design (3xTF32, FlashAttention-2 on mma.sync m16n8k8).  The first
// design ran both products on FP32 FMAs (4 x 4 scores per thread, K
// transposed into shared memory by synchronous loads, P through shared
// memory behind a barrier) and reached 29% of the FP32 cores' 67 TFLOP/s;
// no FP32-core kernel can go much past SDPA's f32 time.  Plain TF32 keeps 10
// mantissa bits and fails the f32 limit (1e-4 |want| + 1e-5 at full width).
// 3xTF32 splits every f32 operand x into big = x cut to TF32 and small =
// x - big (TF32 in the tensor core; see split_tf32), and runs a.b as
// a_small.b_big + a_big.b_small + a_big.b_big on the tensor cores;
// small.small is dropped.  In Q.K^T the three products have accumulators
// of their own (chains of D/8 dependent mma, not 3 D/8: 7.82 against 7.95
// ms at phi4-mini's heads on an H100), summed small terms first; in P.V
// the small terms reach the accumulator before the large one.  That keeps
// about 20 bits of each operand (2^-20 relative), against 10 for plain
// TF32.  The walk (4 warps x 16 query rows, tile order, causal stop,
// per-warp skip, zero-fill) is the bf16 kernel's.
// Q's tile stays f32 in shared memory (copied once with the first K/V tile)
// and each warp reads and splits its A fragments per k8 step: f32
// fragments of all d in registers (64 at d = 128) beside the 64 accumulators
// made ptxas spill.  K and V tiles of kF32BK = 32 keys stay f32 in shared
// memory, double-buffered by cp.async with zero-fill past Sk, and are split
// per fragment as they are read.  The contraction index of Q.K^T is
// relabelled inside each k8 step (logical t -> column 2t, t + 4 -> 2t + 1),
// so a Q or K fragment pair is one 8-byte load; Q and K rows are padded by 8
// floats, which puts a half-warp's 8-byte reads on 32 banks.  P stays in
// registers: the m16n8 accumulator gives thread (g, t) keys 2t and 2t + 1,
// the tf32 A fragment wants k = t and t + 4, so the keys are relabelled
// (a0 = c0, a1 = c2, a2 = c1, a3 = c3) and V's fragment reads keys 2t and
// 2t + 1; V rows are padded by 4 floats, which puts those scalar reads on
// 32 banks.  Shared memory: 54,272 bytes at d = 64, 103,424 at d = 128, so
// two blocks (8 warps) share an SM.  At phi4-mini's heads it runs at about
// 53 TFLOP/s (158 of the TF32 cores' 495 across the three passes), 3.1x its
// bound, ahead of SDPA's f32 kernel (9.1 ms).
//
// Left for later: wgmma with TMA loads and warp specialisation (producer
// warp, consumer warpgroups), the only way to the tensor cores' full rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;          // keys per K/V tile (bf16 kernel)
constexpr float kNegInf = -1e30f;

struct Strides {   // element strides of a (B, H, S, d) view, d contiguous
  long long b, h, s;
};

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


// ---- f32: 3xTF32 on tensor cores ----------------------------------------------

constexpr int kF32BK = 32;   // keys per K/V tile (f32 kernel)

template <int D>
constexpr size_t tf32_smem_bytes() {   // Q and 2 x K in rows of D + 8, then 2 x V in rows of D + 4
  return sizeof(float) * ((size_t)(kMmaBQ + 2 * kF32BK) * (D + 8) + 2 * (size_t)kF32BK * (D + 4));
}

// 4-byte asynchronous copy global -> shared; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// x as two TF32 operands: big = x cut to TF32's 10 mantissa bits (toward
// zero), small = x - big (exact in f32), whose low 13 bits the tensor core
// ignores.  |x - big - tf32(small)| <= 2^-20 |x|.  cvt.rna.tf32.f32 for both
// (2^-22) is a sequence of instructions on sm_90a, not one, and cost 35% of
// the kernel's time at phi4-mini's heads (11.06 against 8.17 ms, same card).
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a . b on one m16n8k8 tile: tf32 inputs, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: a_small.b_big and a_big.b_small first, then
// a_big.b_big; b is split here
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&a_big)[4],
                                           const unsigned (&a_small)[4], float b0, float b1) {
  unsigned b0_big, b0_small, b1_big, b1_small;
  split_tf32(b0, b0_big, b0_small);
  split_tf32(b1, b1_big, b1_small);
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0_big, b1_big);
}

// Copy rows row0 .. row0+ROWS-1 of a (rows, D) f32 view with row stride
// `rs` into a [ROWS][LD] tile with cp.async, 16 bytes a copy when VEC, else
// 4; rows at or past n_rows are zeros.
template <int D, int LD, int ROWS, bool VEC>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src, long long rs,
                                              int row0, int n_rows) {
  constexpr int W = VEC ? 4 : 1;   // floats per copy
  constexpr int CPR = D / W;       // copies per row
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * CPR; e += kMmaThreads) {
    const int r = e / CPR;
    const int cc = e - r * CPR;
    const int pos = row0 + r;
    const bool ok = pos < n_rows;
    const float* s = ok ? src + pos * rs + cc * W : src;
    const unsigned d = smem_addr(dst + r * LD + cc * W);
    if constexpr (VEC) {
      cp_async16(d, s, ok);
    } else {
      cp_async4(d, s, ok);
    }
  }
}

// Block and warp walk as flash_fwd_mma_kernel: kMmaWarps warps, warp w owns
// query rows q0 + 16w .. q0 + 16w + 15; lane = 4 * g + t holds rows g and
// g + 8 of the warp's 16 and, in every n8 tile of scores or output, columns
// 2t and 2t + 1.  VEC: every row of q, k, v, o starts on 16 bytes.
template <int D, bool CAUSAL, bool VEC>
__global__ void __launch_bounds__(kMmaThreads, 1) flash_fwd_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int heads, int s_len,
    int sk_len, float scale_log2) {
  constexpr int LDK = D + 8;        // Q and K row stride: 8-byte fragment reads on 32 banks
  constexpr int LDV = D + 4;        // V row stride: scalar reads of keys 2t, 2t + 1 on 32 banks
  constexpr int KSTEPS = D / 8;     // k8 steps of Q.K^T
  constexpr int NO = D / 8;         // n8 tiles of the output
  constexpr int NS = kF32BK / 8;    // n8 tiles of the scores, k8 steps of P.V
  extern __shared__ __align__(16) float f32_smem[];
  float* q_s = f32_smem;                 // [kMmaBQ][LDK]
  float* k_s = q_s + kMmaBQ * LDK;       // [2][kF32BK][LDK]
  float* v_s = k_s + 2 * kF32BK * LDK;   // [2][kF32BK][LDV]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int n_qt = (s_len + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kMmaBQ;   // last query tiles first
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;
  const int w0 = q0 + 16 * warp;      // the warp's first query row
  const int row_a = w0 + g;           // the thread's two query rows
  const int row_b = row_a + 8;

  int n_kt = (sk_len + kF32BK - 1) / kF32BK;
  if (CAUSAL) {
    const int last_q = min(q0 + kMmaBQ, s_len) - 1;    // the block's last real row
    n_kt = min(n_kt, last_q / kF32BK + 1);
  }

  load_f32_tile<D, LDK, kMmaBQ, VEC>(q_s, qb, qs.s, q0, s_len);
  load_f32_tile<D, LDK, kF32BK, VEC>(k_s, kb, ks.s, 0, sk_len);
  load_f32_tile<D, LDV, kF32BK, VEC>(v_s, vb, vs.s, 0, sk_len);
  cp_async_commit();
  // the warp's Q rows g and g + 8, f32, read per k8 step (f32 fragments of
  // all D would take 4 * D / 8 registers beside the accumulators)
  const float* qa_s = q_s + (16 * warp + g) * LDK + 2 * t;

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
    const int k0 = kt * kF32BK;
    if (kt + 1 < n_kt) {
      load_f32_tile<D, LDK, kF32BK, VEC>(k_s + (buf ^ 1) * kF32BK * LDK, kb, ks.s, k0 + kF32BK,
                                         sk_len);
      load_f32_tile<D, LDV, kF32BK, VEC>(v_s + (buf ^ 1) * kF32BK * LDV, vb, vs.s, k0 + kF32BK,
                                         sk_len);
    }
    cp_async_commit();
    cp_async_wait<1>();   // Q and tile kt have landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    const float* kt_s = k_s + buf * kF32BK * LDK;
    const float* vt_s = v_s + buf * kF32BK * LDV;
    // under `causal` a warp whose rows all precede the tile sees none of it
    if (!CAUSAL || k0 <= w0 + 15) {
      // S = Q . K^T: 16 rows x kF32BK keys per warp, 3xTF32.  The three
      // products go to three accumulators, so each chain of dependent mma
      // is KSTEPS long, not 3 x KSTEPS; the small terms are added first.
      float sc[NS][4], sc_sb[NS][4], sc_bs[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = sc_sb[n][e] = sc_bs[n][e] = 0.0f;
      }
      // Inside each k8 step column 2t serves as k = t and column 2t + 1 as
      // k = t + 4, for Q and K alike, so each fragment pair is one 8-byte read
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const float2 qa = *reinterpret_cast<const float2*>(qa_s + 8 * kk);
        const float2 qr = *reinterpret_cast<const float2*>(qa_s + 8 * LDK + 8 * kk);
        unsigned qa_big[4], qa_small[4];
        split_tf32(qa.x, qa_big[0], qa_small[0]);
        split_tf32(qr.x, qa_big[1], qa_small[1]);
        split_tf32(qa.y, qa_big[2], qa_small[2]);
        split_tf32(qr.y, qa_big[3], qa_small[3]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {   // keys 8n .. 8n + 7 of the tile
          const float2 kv =
              *reinterpret_cast<const float2*>(kt_s + (8 * n + g) * LDK + 8 * kk + 2 * t);
          unsigned k0_big, k0_small, k1_big, k1_small;
          split_tf32(kv.x, k0_big, k0_small);
          split_tf32(kv.y, k1_big, k1_small);
          mma_tf32(sc_sb[n], qa_small, k0_big, k1_big);
          mma_tf32(sc_bs[n], qa_big, k0_small, k1_small);
          mma_tf32(sc[n], qa_big, k0_big, k1_big);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += sc_sb[n][e] + sc_bs[n][e];
      }

      // online softmax in the log2 domain; element e of a tile is row e >> 1
      const bool masked = k0 + kF32BK > sk_len || (CAUSAL && k0 + kF32BK - 1 > w0);
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

      // O += P . V in 3xTF32, P from registers: within k8 step kk, key
      // 8kk + 2t serves as k = t and key 8kk + 2t + 1 as k = t + 4
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        unsigned pa_big[4], pa_small[4];
        split_tf32(sc[kk][0], pa_big[0], pa_small[0]);
        split_tf32(sc[kk][2], pa_big[1], pa_small[1]);
        split_tf32(sc[kk][1], pa_big[2], pa_small[2]);
        split_tf32(sc[kk][3], pa_big[3], pa_small[3]);
        const float* v0 = vt_s + (8 * kk + 2 * t) * LDV + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {   // output columns 8n .. 8n + 7
          mma_3xtf32(acc[n], pa_big, pa_small, v0[8 * n], v0[LDV + 8 * n]);
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
    float* orow = ob + row * os.s;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float o0 = acc[n][2 * r] / denom;
      const float o1 = acc[n][2 * r + 1] / denom;
      if constexpr (VEC) {
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = make_float2(o0, o1);
      } else {
        orow[8 * n + 2 * t] = o0;
        orow[8 * n + 2 * t + 1] = o1;
      }
    }
  }
}

template <int D, bool CAUSAL, bool VEC>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o, const Strides* st,
                  int batch, int heads, int s_len, int sk_len, float scale_log2,
                  cudaStream_t stream) {
  constexpr size_t smem = tf32_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D, CAUSAL, VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)batch * (unsigned)heads, (unsigned)((s_len + kMmaBQ - 1) / kMmaBQ));
  flash_fwd_tf32x3_kernel<D, CAUSAL, VEC><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st[0], st[1], st[2], st[3], heads, s_len, sk_len, scale_log2);
  return (int)cudaGetLastError();
}

// ---- host side --------------------------------------------------------------

template <int D, bool CAUSAL>
int launch(int is_bf16, bool vec, const void* q, const void* k, const void* v, void* o,
           const Strides* st, int batch, int heads, int s_len, int sk_len, double scale,
           cudaStream_t s) {
  const float scale_log2 = (float)(scale * 1.4426950408889634);
  if (is_bf16) {
    return launch_mma<D, CAUSAL>(q, k, v, o, st, batch, heads, s_len, sk_len, scale_log2, s);
  }
  if (vec) {
    return launch_tf32x3<D, CAUSAL, true>(q, k, v, o, st, batch, heads, s_len, sk_len,
                                          scale_log2, s);
  }
  return launch_tf32x3<D, CAUSAL, false>(q, k, v, o, st, batch, heads, s_len, sk_len,
                                         scale_log2, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Which kernel serves (dtype, d, causal), as written above; for logs.
extern "C" const char* flash_attention_kernel_name(int is_bf16, int head_dim, int causal) {
  if (head_dim != 64 && head_dim != 128) return "none (d must be 64 or 128)";
  static const char* names[2][2][2] = {
      {{"flash_fwd_tf32x3_kernel<64, false, VEC> (3xTF32 mma.sync m16n8k8)",
        "flash_fwd_tf32x3_kernel<64, true, VEC> (3xTF32 mma.sync m16n8k8)"},
       {"flash_fwd_tf32x3_kernel<128, false, VEC> (3xTF32 mma.sync m16n8k8)",
        "flash_fwd_tf32x3_kernel<128, true, VEC> (3xTF32 mma.sync m16n8k8)"}},
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
// d is 64 or 128.  bf16 needs every row of q, k, v, o to start on 16 bytes;
// f32 copies 16 bytes at a time when they do (VEC), else 4.  Launches once
// on `stream` and does not synchronise.  Returns 0 or a cudaError_t
// (cudaErrorInvalidValue for a shape it does not take,
// cudaErrorMisalignedAddress for a bf16 view off 16 bytes, or
// cudaGetLastError() after the launch).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       const long long* strides, int batch, int heads,
                                       int s_len, int sk_len, int head_dim, int is_bf16,
                                       int causal, void* stream) {
  (void)cudaGetLastError();  // attribute only this launch's error
  if (batch <= 0 || heads <= 0 || s_len <= 0 || sk_len <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)batch * heads > 0x7fffffffLL || (s_len + kMmaBQ - 1) / kMmaBQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  // every row starts on 16 bytes: base pointers, and the strides of the
  // dimensions longer than 1, in multiples of 16 bytes
  const int per16 = is_bf16 ? 8 : 4;   // elements per 16 bytes
  const int sizes[12] = {batch, heads, s_len, batch, heads, sk_len,
                         batch, heads, sk_len, batch, heads, s_len};
  bool rows16 = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) rows16 = rows16 && (sizes[i] == 1 || strides[i] % per16 == 0);
  if (is_bf16 && !rows16) return (int)cudaErrorMisalignedAddress;
  const double scale = 1.0 / sqrt((double)head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return causal ? launch<64, true>(is_bf16, rows16, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s)
                  : launch<64, false>(is_bf16, rows16, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s);
  }
  if (head_dim == 128) {
    return causal ? launch<128, true>(is_bf16, rows16, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s)
                  : launch<128, false>(is_bf16, rows16, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
