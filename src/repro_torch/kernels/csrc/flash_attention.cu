// Flash-attention forward for NVIDIA Hopper (sm_90a): online softmax over
// K/V tiles, one block per (batch*head, query tile), causal or not.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel).  As in the reference, the kernel is reached only
// through the public wrapper ops.flash_attention_op; no model layer calls it
// (layers/attention.py runs blocked_attention).
//
// Computes, per (b, h) and query row i, with scale = 1/sqrt(d) in f32:
//   s_ij = scale * (q_i . k_j)                 (f32 products and sums)
//   p_ij = exp(s_ij - m_i) over the visible keys, l_i = sum_j p_ij
//   o_i  = (sum_j p~_ij v_j) / max(l_i, 1e-30), written in q's type
// where p~ is p rounded to v's type (P is cast before P.V in the reference,
// flash_attention.py:63) and, under `causal`, key j is visible to query i iff
// j <= i: the mask is aligned top-left, as the Pallas kernel's k_pos <= q_pos
// (flash_attention.py:53-55), also when S != Sk.  q, k, v are f32 or bf16,
// widened to f32 in shared memory; every product and sum is an FP32 FMA (no
// TF32: the f32 bar is 2e-3 and TF32 keeps about three digits).
//
// Bound on an H100 SXM: 4*d FLOP per visible (query, key) pair (q.k and p.v),
// at 989 TFLOP/s for bf16 (dense tensor cores) and 67 TFLOP/s for f32 (FP32
// cores, since the bar rules out TF32), against q, k, v, o once at 3.35 TB/s.
// At phi4-mini-3.8b's heads (H = 24, d = 128), S = Sk = 4096, B = 4, causal:
// 4.1e11 FLOP, 0.42 ms in bf16 and 6.2 ms in f32; the operations bound both.
// This kernel runs both types on the FP32 cores, so in bf16 it cannot come
// near its bound; tensor cores (mma.sync / wgmma) are left for the redesign.
//
// Design (simple first): a block of 256 threads owns kBQ = 64 query rows of
// one (b, h) and walks the K/V tiles of kBK = 64 keys from tile 0 on, so every
// row meets key 0 first and has a real maximum before any tile it cannot
// see.  Q^T (f32) stays in shared memory for the whole walk; each tile stages
// K^T and V (f32) in shared memory, computes the 64 x 64 scores as 4 x 4 per
// thread (rows 4*ty.., keys tx + 16*c), takes row maxima and sums across the
// 16 threads of a row with warp shuffles, keeps (m, l) per row in registers,
// writes P (rounded to v's type) to shared memory, and adds P.V into a 4 x d/16
// accumulator per thread (columns 64*c + 4*tx ..).  Under `causal` the walk
// stops at the last tile that holds a key some row of the block can see;
// inside a tile the mask is element-wise (k_pos <= q_pos), and keys past Sk
// and rows past S are masked, so any S and Sk are taken.  Rows of q, k, v,
// o are read through strides (d contiguous), so (B, S, H, d) tensors need no
// transpose.  The blocks of the last query tiles (the most K/V tiles under
// `causal`) are issued first.  Shared memory is 67,840 bytes at d = 64 and
// 118,272 bytes at d = 128, above the 48 KB default, so the launch opts in
// with cudaFuncSetAttribute.
//
// Left for later: tensor cores, keeping K and V in their own type in shared
// memory, TMA loads double-buffered against the compute, more blocks per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kThreads = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys / d/16 columns
constexpr int kQS = kBQ + 4;     // Q^T row stride (float4-aligned)
constexpr int kKS = kBK + 1;     // K^T row stride (conflict-free transposed writes)
constexpr int kPS = kBK + 4;     // P row stride (float4-aligned)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v as the type T holds it (round to nearest even for bf16), widened to f32
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

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

template <int D, typename T, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, const Strides* st,
           int batch, int heads, int s_len, int sk_len, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)batch * (unsigned)heads, (unsigned)((s_len + kBQ - 1) / kBQ));
  flash_fwd_kernel<D, T, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], heads, s_len, sk_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int head_dim, int causal, const void* q, const void* k, const void* v, void* o,
             const Strides* st, int batch, int heads, int s_len, int sk_len, float scale,
             cudaStream_t s) {
  if (head_dim == 64) {
    return causal ? launch<64, T, true>(q, k, v, o, st, batch, heads, s_len, sk_len, scale, s)
                  : launch<64, T, false>(q, k, v, o, st, batch, heads, s_len, sk_len, scale, s);
  }
  if (head_dim == 128) {
    return causal ? launch<128, T, true>(q, k, v, o, st, batch, heads, s_len, sk_len, scale, s)
                  : launch<128, T, false>(q, k, v, o, st, batch, heads, s_len, sk_len, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  q (B, H, S, d), k and v
// (B, H, Sk, d) and o (B, H, S, d) are device pointers to views of the type
// named by is_bf16 with d contiguous; `strides` holds 12 element strides,
// (batch, head, row) of q, k, v, o in turn.  o must not overlap the inputs.
// d is 64 or 128.  Launches once on `stream` and does not synchronise.
// Returns 0 or a cudaError_t (cudaErrorInvalidValue for a shape it does not
// take, or cudaGetLastError() after the launch).
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
  const float scale = (float)(1.0 / sqrt((double)head_dim));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(head_dim, causal, q, k, v, o, st, batch, heads, s_len,
                                   sk_len, scale, s);
  }
  return dispatch<float>(head_dim, causal, q, k, v, o, st, batch, heads, s_len, sk_len, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
