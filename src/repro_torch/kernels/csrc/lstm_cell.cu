// Fused LSTM cell for NVIDIA Hopper (sm_90a): one timestep of MVM_X + MVM_H
// + bias + gate activations + the c'/h' update in one kernel.
//
// Replaces: src/repro/kernels/lstm_cell.py::lstm_cell_pallas (body
// _lstm_cell_kernel), the Pallas TPU kernel behind the "fused" schedule.
//
// Computes, per batch row and hidden unit j, for gates g in (i, f, g, o):
//   pre[g] = sum_k x[k]*wx[g,k,j] + sum_k h[k]*wh[g,k,j] + b[g,j]   (f32, FMA)
//   c' = sig(pre_f)*c + sig(pre_i)*tanh(pre_g),  h' = sig(pre_o)*tanh(c')
// with exact sigmoid/tanh (expf, tanhf) or the paper's piecewise-linear ones.
// x and h are f32 or bf16 (converted to f32; the weights stay f32, as JAX
// promotes bf16 x f32 to f32); c is f32; h' is written in h's type, c' in f32.
//
// Bound on an H100 SXM, per launch: about 8*B*H*(In+H) FLOP on the FP32
// cores (no tensor cores: the f32 bar is 1e-5, which TF32 cannot meet), and
// about B*(In+H)*s + B*H*(8+s) + 16*H*(In+H) bytes (s = bytes of x/h).  At
// the paper's widths (In, H <= 64) and a large batch it is bound by the
// operations, not the bytes.
//
// Design (simple first): the batch is tiled across blocks; each block stages
// its rows of x and h in shared memory as f32, and each thread owns one
// (row, hidden unit j) and computes all four gates for it, so the c'/h'
// update stays in registers.  Weights are read from global memory (L1/L2
// resident at these sizes), coalesced along j; x/h reads from shared memory
// are warp broadcasts.  Ragged edges of B and H are masked, so no shape
// needs to divide a tile.
//
// Aliasing: h_out must not overlap x or h (every block of a row reads the
// whole h row); c_out may be c itself (each thread reads and writes only its
// own element), which the "fused" schedule uses to update c in place.
//
// Left for later: weight reuse across several rows per thread, tensor cores
// with 3xTF32, persistence across timesteps (K2), and a CUDA graph over the
// per-request launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// Block: (tj, tr) threads; threadIdx.x walks hidden units, threadIdx.y rows.
// Grid: (ceil(B / tr), ceil(H / tj)).  Shared memory: tr * (In + H) floats.
template <typename T, bool PWL>
__global__ void __launch_bounds__(kThreads) lstm_cell_kernel(
    const T* __restrict__ x, const T* __restrict__ h, const float* c,
    const float* __restrict__ wx, const float* __restrict__ wh,
    const float* __restrict__ b, T* __restrict__ h_out, float* c_out,
    int batch, int in_dim, int hidden) {
  extern __shared__ float rows[];
  const int k_dim = in_dim + hidden;
  const int row0 = blockIdx.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // stage [x | h] of this block's rows as f32; rows past B read as zeros
  for (int idx = tid; idx < (int)blockDim.y * k_dim; idx += nthreads) {
    const int r = idx / k_dim;
    const int k = idx - r * k_dim;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < batch) {
      v = k < in_dim ? to_f32(x[(size_t)row * in_dim + k])
                     : to_f32(h[(size_t)row * hidden + (k - in_dim)]);
    }
    rows[idx] = v;
  }
  __syncthreads();

  const int row = row0 + threadIdx.y;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= batch || j >= hidden) return;

  const float* xr = rows + threadIdx.y * k_dim;
  const float* hr = xr + in_dim;
  float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ah[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  const size_t wx_gate = (size_t)in_dim * hidden;   // stride between gates
#pragma unroll 4
  for (int k = 0; k < in_dim; ++k) {
    const float v = xr[k];
    const float* w = wx + (size_t)k * hidden + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) ax[g] = fmaf(v, __ldg(w + g * wx_gate), ax[g]);
  }
  const size_t wh_gate = (size_t)hidden * hidden;
#pragma unroll 4
  for (int k = 0; k < hidden; ++k) {
    const float v = hr[k];
    const float* w = wh + (size_t)k * hidden + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) ah[g] = fmaf(v, __ldg(w + g * wh_gate), ah[g]);
  }

  float pre[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) pre[g] = ax[g] + ah[g] + __ldg(b + g * hidden + j);

  const size_t o = (size_t)row * hidden + j;
  const float c_new = sigmoid_act<PWL>(pre[1]) * c[o] +
                      sigmoid_act<PWL>(pre[0]) * tanh_act<PWL>(pre[2]);
  const float h_new = sigmoid_act<PWL>(pre[3]) * tanh_act<PWL>(c_new);
  c_out[o] = c_new;
  store(h_out + o, h_new);
}

template <typename T, bool PWL>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
            const void* x, const void* h, const void* c, const void* wx,
            const void* wh, const void* b, void* h_out, void* c_out,
            int batch, int in_dim, int hidden) {
  lstm_cell_kernel<T, PWL><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const float*>(c), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(b),
      static_cast<T*>(h_out), static_cast<float*>(c_out), batch, in_dim,
      hidden);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers of
// contiguous row-major tensors: x (B, In), h/h_out (B, H) of the type named by
// is_bf16; c/c_out (B, H), wx (4, In, H), wh (4, H, H), b (4, H) f32.
// Launches on `stream` and does not synchronise.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int lstm_cell_forward(const void* x, const void* h, const void* c,
                                 const void* wx, const void* wh, const void* b,
                                 void* h_out, void* c_out, int batch,
                                 int in_dim, int hidden, int is_bf16, int pwl,
                                 void* stream) {
  (void)cudaGetLastError();  // attribute only this launch's error
  if (batch <= 0 || in_dim <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  int tj = 8;
  while (tj < hidden && tj < 128) tj *= 2;
  const int tr = kThreads / tj;
  const size_t smem = (size_t)tr * (size_t)(in_dim + hidden) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(tj, tr);
  const dim3 grid((batch + tr - 1) / tr, (hidden + tj - 1) / tj);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (pwl) launch<__nv_bfloat16, true>(grid, block, smem, s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden);
    else     launch<__nv_bfloat16, false>(grid, block, smem, s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden);
  } else {
    if (pwl) launch<float, true>(grid, block, smem, s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden);
    else     launch<float, false>(grid, block, smem, s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
