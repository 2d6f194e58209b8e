// RWKV-6 WKV recurrence for NVIDIA Hopper (sm_90a): one (batch, head) per
// block, the whole time loop inside the block, the head's state on chip.
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
//
// Design (simple first): thread j owns column j of S in hd registers, so the
// state never leaves the block and no thread waits on another's column.
// Each step needs r_t, k_t, w_t and u of every row i: they are staged in
// shared memory as one float4 (r_i, k_i, w_i, u_i) per row, read back as one
// broadcast 128-bit load per i; v_t[j] stays in a register.  The streams are
// read row by row, each (b, t, h) row hd-contiguous (coalesced), kChunk
// timesteps at a time into registers one chunk ahead of the compute, so the
// loads of chunk c+1 are in flight while chunk c is computed; the staging
// buffer is double-buffered, one __syncthreads() per chunk.  hd is a
// template parameter (16, 32, 64); the Pallas kernel's whole-(T, hd) blocks
// in VMEM are not carried over: nothing of the streams is kept beyond a
// chunk.
//
// Left for later: several threads per column (more warps per block to hide
// latency), and the chunked form of the recurrence on tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kChunk = 8;   // timesteps staged per round

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Row j of kChunk timesteps from t0 on (zeros past t_len) into registers.
template <typename T>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, size_t base, size_t row_stride, int t0, int t_len,
    float (&pr)[kChunk], float (&pk)[kChunk], float (&pv)[kChunk], float (&pw)[kChunk]) {
#pragma unroll
  for (int tt = 0; tt < kChunk; ++tt) {
    const int t = t0 + tt;
    if (t < t_len) {
      const size_t o = base + (size_t)t * row_stride;
      pr[tt] = to_f32(r[o]);
      pk[tt] = to_f32(k[o]);
      pv[tt] = to_f32(v[o]);
      pw[tt] = w[o];
    } else {
      pr[tt] = pk[tt] = pv[tt] = pw[tt] = 0.0f;
    }
  }
}

// Block: HD threads, thread j owning column j of S.  Grid: B * H blocks,
// block bh = b * H + h.  Streams are (B, T, H, HD) row-major.
template <int HD, typename T>
__global__ void __launch_bounds__(HD) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ s_out,
    int t_len, int heads) {
  __shared__ float4 stage[2][kChunk][HD];   // (r_i, k_i, w_i, u_i) per staged step
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const size_t row_stride = (size_t)heads * HD;              // between timesteps
  const size_t base = ((size_t)b * t_len * heads + h) * HD + j;
  const float uj = u[h * HD + j];

  float s[HD];
  const float* s0p = s0 + (size_t)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s0p[(size_t)i * HD];

  float pr[kChunk], pk[kChunk], pv[kChunk], pw[kChunk];
  load_chunk(r, k, v, w, base, row_stride, 0, t_len, pr, pk, pv, pw);
  int buf = 0;
  for (int t0 = 0; t0 < t_len; t0 += kChunk, buf ^= 1) {
    float vc[kChunk];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      stage[buf][tt][j] = make_float4(pr[tt], pk[tt], pw[tt], uj);
      vc[tt] = pv[tt];
    }
    // chunk t0 is staged; every read of this buffer two chunks ago is done
    __syncthreads();
    if (t0 + kChunk < t_len) {
      load_chunk(r, k, v, w, base, row_stride, t0 + kChunk, t_len, pr, pk, pv, pw);
    }
    const int n = min(kChunk, t_len - t0);
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < n) {
        const float vj = vc[tt];
        const float4* a = stage[buf][tt];
        float acc0 = 0.0f;
        float acc1 = 0.0f;
#pragma unroll
        for (int i = 0; i < HD; i += 2) {
          const float4 a0 = a[i];
          const float kv0 = a0.y * vj;
          acc0 = fmaf(a0.x, fmaf(a0.w, kv0, s[i]), acc0);
          s[i] = fmaf(a0.z, s[i], kv0);
          const float4 a1 = a[i + 1];
          const float kv1 = a1.y * vj;
          acc1 = fmaf(a1.x, fmaf(a1.w, kv1, s[i + 1]), acc1);
          s[i + 1] = fmaf(a1.z, s[i + 1], kv1);
        }
        y[base + (size_t)(t0 + tt) * row_stride] = acc0 + acc1;
      }
    }
  }
  float* sp = s_out + (size_t)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) sp[(size_t)i * HD] = s[i];
}

template <int HD, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int batch,
           int t_len, int heads, cudaStream_t stream) {
  const dim3 grid((unsigned)batch * (unsigned)heads);
  wkv6_kernel<HD, T><<<grid, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_out), t_len, heads);
  return (int)cudaGetLastError();
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

}  // namespace

// Plain C interface (loaded with ctypes).  Device pointers of contiguous
// row-major tensors: r, k, v (B, T, H, hd) of the type named by is_bf16;
// w (B, T, H, hd), u (H, hd), s0 (B, H, hd, hd) f32; y (B, T, H, hd) and
// s_out (B, H, hd, hd) f32, not overlapping the inputs.  hd is 16, 32 or 64.
// Launches once on `stream` and does not synchronise.  Returns 0 or a
// cudaError_t (cudaErrorInvalidValue for a shape it does not take, or
// cudaGetLastError() after the launch).
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

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
