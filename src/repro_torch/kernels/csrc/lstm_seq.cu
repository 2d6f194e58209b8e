// Sequence-streaming LSTM layer for NVIDIA Hopper (sm_90a): all T timesteps
// of one layer in one launch, (h, c) kept on chip between timesteps.
//
// Replaces: src/repro/kernels/lstm_seq.py::lstm_seq_pallas (body
// _lstm_seq_kernel).  As in the reference, the kernel is reached only through
// the public wrapper ops.lstm_seq_op; no schedule uses it.
//
// Computes, per batch row and hidden unit j, for t = 0 .. T-1 and gates g in
// (i, f, g, o):
//   pre[g] = sum_k x_t[k]*wx[g,k,j] + sum_k hx[k]*wh[g,k,j] + b[g,j]   (f32, FMA)
//   c = sig(pre_f)*c + sig(pre_i)*tanh(pre_g),  h = sig(pre_o)*tanh(c),  ys[t] = h
// where hx is h_{t-1} rounded to x's type, as the reference casts h to x's
// dtype before MVM_H (lstm_seq.py:51): in bf16, h is rounded to bf16 every
// step, while the carried h and c stay f32.  x is f32 or bf16 (converted to
// f32 against the f32 weights, as JAX promotes it); h0 and the final h are
// f32 here (the wrapper converts them from and to h0's type, exactly); c0 and
// the final c are f32; ys is written in x's type.  Exact sigmoid/tanh (expf,
// tanhf) or the paper's piecewise-linear ones.
//
// Bound on an H100 SXM: 8*T*B*H*(In+H) FLOP on the FP32 cores (no tensor
// cores: the f32 bar is 1e-5, which TF32 cannot meet) at 67 TFLOP/s, against
// T*B*(In+H)*s + B*H*(2s + 8) + 16*H*(In+H+1) bytes (s = bytes of x; each
// input and output once, the weights once) at 3.35 TB/s.  At the paper's widths and
// a large batch the operations bound it.
//
// Design (simple first): a block owns whole batch rows with all H hidden
// units of each, so h_t never leaves the block and no block waits for
// another.  Each thread owns one (row, j), keeps c, the final h and its four
// biases in registers, and computes all four gates.  h_{t-1} lives in two
// shared-memory buffers (read one, write the other) with a __syncthreads()
// between timesteps; x_t of the block's rows is staged in shared memory as
// f32 each step.  The weights take 16*H*(In+H) bytes: when they fit in
// shared memory beside those buffers (up to the 227 KB a block can opt in to,
// e.g. 98 KB at the paper's widest layer (In, H) = (32, 64)), each block
// loads them once and keeps them stationary there for all T steps; when they
// do not (384 KB at (64, 128)), every step reads them from L2 (__ldg).  The
// path is chosen by size inside lstm_seq_forward.  Ragged batches are masked.
//
// Left for later: tensor cores (3xTF32 to hold the f32 bar), several rows per
// thread to reuse each weight from a register, and splitting H across a
// thread-block cluster (distributed shared memory, one cluster barrier per
// step) for weights larger than one block's shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;         // threads per block while H <= 256
constexpr int kMaxHidden = 1024;      // one thread per hidden unit of a row
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v as the type T holds it (round to nearest even for bf16), widened to f32
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
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

template <bool SMEM_W>
__device__ __forceinline__ float load_w(const float* p) {
  if constexpr (SMEM_W) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Block: (tj, tr) threads; threadIdx.x walks hidden units (tj >= H),
// threadIdx.y the block's rows.  Grid: ceil(B / tr).  Dynamic shared memory,
// in floats: [wx 4*In*H | wh 4*H*H] when SMEM_W, then x_s tr*In, then
// h_s 2*tr*H.
template <typename T, bool PWL, bool SMEM_W>
__global__ void __launch_bounds__(kMaxHidden) lstm_seq_kernel(
    const T* __restrict__ xs, const float* __restrict__ h0,
    const float* __restrict__ c0, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ b,
    T* __restrict__ ys, float* __restrict__ h_out, float* __restrict__ c_out,
    int t_len, int batch, int in_dim, int hidden) {
  extern __shared__ float smem[];
  const int tr = blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int row0 = blockIdx.x * tr;
  const int r = threadIdx.y;
  const int j = threadIdx.x;
  const int row = row0 + r;
  const bool active = row < batch && j < hidden;

  const size_t wx_n = (size_t)4 * in_dim * hidden;
  const size_t wh_n = (size_t)4 * hidden * hidden;
  float* x_s = smem + (SMEM_W ? wx_n + wh_n : 0);
  float* h_s = x_s + (size_t)tr * in_dim;

  const float* wxp = wx;
  const float* whp = wh;
  if constexpr (SMEM_W) {
    for (size_t i = tid; i < wx_n; i += nthreads) smem[i] = wx[i];
    for (size_t i = tid; i < wh_n; i += nthreads) smem[wx_n + i] = wh[i];
    wxp = smem;
    whp = smem + wx_n;
  }

  const size_t o = (size_t)row * hidden + j;
  float bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float c = 0.0f;
  float h = 0.0f;
  if (active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = b[g * hidden + j];
    c = c0[o];
    h = h0[o];
  }
  // h_{-1} = h0 in x's type; rows past B read as zeros
  for (int idx = tid; idx < tr * hidden; idx += nthreads) {
    const int rr = idx / hidden;
    const int k = idx - rr * hidden;
    const int rw = row0 + rr;
    h_s[idx] = rw < batch ? round_to(h0[(size_t)rw * hidden + k], (T*)nullptr) : 0.0f;
  }

  const size_t wx_gate = (size_t)in_dim * hidden;   // stride between gates
  const size_t wh_gate = (size_t)hidden * hidden;
  for (int t = 0; t < t_len; ++t) {
    const float* h_cur = h_s + (size_t)(t & 1) * tr * hidden;
    float* h_nxt = h_s + (size_t)((t & 1) ^ 1) * tr * hidden;
    // stage x_t of this block's rows (contiguous in xs[t]) as f32
    const T* xt = xs + ((size_t)t * batch + row0) * in_dim;
    for (int idx = tid; idx < tr * in_dim; idx += nthreads) {
      x_s[idx] = row0 + idx / in_dim < batch ? to_f32(xt[idx]) : 0.0f;
    }
    __syncthreads();   // x_t and h_{t-1} are in shared memory

    if (active) {
      const float* xr = x_s + r * in_dim;
      const float* hr = h_cur + r * hidden;
      float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float ah[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = 0; k < in_dim; ++k) {
        const float v = xr[k];
        const float* w = wxp + (size_t)k * hidden + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) ax[g] = fmaf(v, load_w<SMEM_W>(w + g * wx_gate), ax[g]);
      }
#pragma unroll 4
      for (int k = 0; k < hidden; ++k) {
        const float v = hr[k];
        const float* w = whp + (size_t)k * hidden + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) ah[g] = fmaf(v, load_w<SMEM_W>(w + g * wh_gate), ah[g]);
      }
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) pre[g] = ax[g] + ah[g] + bias[g];
      c = sigmoid_act<PWL>(pre[1]) * c + sigmoid_act<PWL>(pre[0]) * tanh_act<PWL>(pre[2]);
      h = sigmoid_act<PWL>(pre[3]) * tanh_act<PWL>(c);
      store(ys + ((size_t)t * batch + row) * hidden + j, h);
      h_nxt[r * hidden + j] = round_to(h, (T*)nullptr);
    }
    __syncthreads();   // every read of x_s and h_cur is done before step t+1
  }
  if (active) {
    c_out[o] = c;
    h_out[o] = h;
  }
}

struct Plan {
  int tj;           // threads along H (a power of two >= H)
  int tr;           // rows per block
  bool smem_w;      // weights stationary in shared memory
  size_t smem;      // dynamic shared memory per block, bytes
};

int make_plan(int batch, int in_dim, int hidden, Plan* p) {
  if (batch <= 0 || in_dim <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  if (hidden > kMaxHidden) return (int)cudaErrorInvalidValue;
  int tj = 8;
  while (tj < hidden) tj *= 2;
  int tr = kThreads / tj;
  if (tr < 1) tr = 1;
  if (tr > batch) tr = batch;
  int dev = 0;
  int optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const size_t buffers = (size_t)tr * (size_t)(in_dim + 2 * hidden) * sizeof(float);
  const size_t weights = (size_t)16 * hidden * (size_t)(in_dim + hidden);
  p->tj = tj;
  p->tr = tr;
  p->smem_w = weights + buffers <= (size_t)optin;
  p->smem = p->smem_w ? weights + buffers : buffers;
  if (p->smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

template <typename T, bool PWL, bool SMEM_W>
int launch(const Plan& p, cudaStream_t stream, const void* xs, const void* h0,
           const void* c0, const void* wx, const void* wh, const void* b,
           void* ys, void* h_out, void* c_out, int t_len, int batch,
           int in_dim, int hidden) {
  if (p.smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_kernel<T, PWL, SMEM_W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(p.tj, p.tr);
  const dim3 grid((batch + p.tr - 1) / p.tr);
  lstm_seq_kernel<T, PWL, SMEM_W><<<grid, block, p.smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const float*>(h0),
      static_cast<const float*>(c0), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(b),
      static_cast<T*>(ys), static_cast<float*>(h_out),
      static_cast<float*>(c_out), t_len, batch, in_dim, hidden);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Plan& p, int pwl, cudaStream_t s, const void* xs,
             const void* h0, const void* c0, const void* wx, const void* wh,
             const void* b, void* ys, void* h_out, void* c_out, int t_len,
             int batch, int in_dim, int hidden) {
  if (pwl) {
    if (p.smem_w) return launch<T, true, true>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden);
    return launch<T, true, false>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden);
  }
  if (p.smem_w) return launch<T, false, true>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden);
  return launch<T, false, false>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers of
// contiguous row-major tensors: xs (T, B, In) and ys (T, B, H) of the type
// named by is_bf16; h0, c0, h_out, c_out (B, H), wx (4, In, H), wh (4, H, H),
// b (4, H) f32.  ys, h_out and c_out must not overlap the inputs.  Launches
// once on `stream` and does not synchronise.  Returns 0 or a cudaError_t
// (a refused plan, or cudaGetLastError() after the launch).
extern "C" int lstm_seq_forward(const void* xs, const void* h0, const void* c0,
                                const void* wx, const void* wh, const void* b,
                                void* ys, void* h_out, void* c_out, int t_len,
                                int batch, int in_dim, int hidden, int is_bf16,
                                int pwl, void* stream) {
  (void)cudaGetLastError();  // attribute only this launch's error
  if (t_len <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const int rc = make_plan(batch, in_dim, hidden, &p);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(p, pwl, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden);
  }
  return dispatch<float>(p, pwl, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden);
}

// Which path a launch of this shape takes on the current device: 1 when the
// weights stay in shared memory, 0 when they are read from L2, or minus a
// cudaError_t when no plan exists.  Writes the shared memory per block.
extern "C" int lstm_seq_weights_in_smem(int batch, int in_dim, int hidden,
                                        size_t* smem_bytes) {
  Plan p;
  const int rc = make_plan(batch, in_dim, hidden, &p);
  if (rc != 0) return -rc;
  *smem_bytes = p.smem;
  return p.smem_w ? 1 : 0;
}

extern "C" const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
