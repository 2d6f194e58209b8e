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
// Bound on an H100 SXM: 8*T*B*H*(In+H) FLOP on the FP32 cores at 67 TFLOP/s
// (no tensor cores: the f32 bar is 1e-5 over up to 64 compounding steps, and
// even 3xTF32 drops bits that FP32 FMAs keep), against T*B*(In+H)*s +
// B*H*(2s + 8) + 16*H*(In+H+1) bytes (s = bytes of x; each input and output
// once, the weights once) at 3.35 TB/s.  At the paper's widths and a large
// batch the operations bound it.
//
// Design: each timestep is a small GEMM [x_t | h_{t-1}] (BM x (In+H)) times
// W ((In+H) x 4H) with the c/h update in its epilogue, as K1 does one
// timestep (lstm_cell.cu), but a block owns BM batch rows with all H units
// and all four gates, so h_t never leaves the block, and it runs all T
// steps.  Each thread keeps a register micro-tile of TM rows x kTN = 2 units
// x 4 gates (up to 64 accumulators) and the c of its TM x 2 (row, unit)
// pairs; per 4 k it reads TM 16-byte activation rows and, per k, two 16-byte
// weight pieces (the four gates of each of its two units), so one read of a
// weight feeds TM FMAs and one of an activation 8.  The first design gave
// each thread one (row, unit): four weight loads per k, each feeding one FMA,
// never reused across rows, and staged x_t synchronously between two
// barriers per step.  Here x_{t+1} is copied with cp.async (16 bytes, f32
// rows on 16 bytes; plain loads after the step's arithmetic otherwise) while
// step t computes, h_t goes from the epilogue (rounded to x's type) into the
// other half of a double-buffered shared tile, and one __syncthreads() per
// step separates the steps; ys rows are written from registers.  Weights
// sit in shared memory for all T steps, gate-interleaved per unit
// ([k][unit parity][unit pair][gate], zero-padded to k and unit multiples of
// 4 and 2), when they fit beside the activation tiles (98 KB at the paper's
// widest layer (32, 64)); else every step reads them from L2 in the
// reference layout (384 KB at (64, 128)), still TM FMAs per load.
//
// Tiles by shape (lstm_seq_tile): TM is 8, 4 or 1, and the block has
// ceil(H/2) x NR threads (BM = NR * TM rows); the first (NR, TM) with at
// least 128 blocks is taken, NR largest first (up to 256 threads, at least
// 128), then TM, so at B = 8192 the grid covers the 132 SMs with 8 warps a
// block where it can (on an H100, (64, 32) and (16, 32) ran 1.4-1.5x faster on
// 8 warps x TM = 4 than on 4 warps x TM = 8); small batches take TM = 1.
// H <= 1024.
//
// Left for later: splitting H across a thread-block cluster (distributed
// shared memory, one cluster barrier per step) for weights larger than one
// block's shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kTN = 2;                // hidden units per thread
constexpr int kMaxHidden = 1024;      // ceil(H / kTN) <= max_threads(1) threads along units
constexpr int kTargetBlocks = 128;    // about one block per SM of an H100 (132 SMs)
constexpr int kTargetThreads = 256;   // threads per block the plan aims at
constexpr size_t kDefaultSmem = 48 * 1024;

// most threads a block of TM-row threads may have (its launch bounds)
__host__ __device__ constexpr int max_threads(int tm) { return tm == 1 ? 512 : 256; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// v as the type T holds it (round to nearest even for bf16), widened to f32
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// acc[r][j][g] += sum_k a[r][k] * w[g][k][unit u0 + j] over k < k_len (a
// multiple of 4; activations past the real width are zeros).  a: the
// thread's first row, row stride `as`.  SMEM_W: ws is the part's weights in
// shared memory offset to the thread's unit pair ([k][parity][nu][4]);
// else wg is the part's gate-major (4, rows, hidden) weights in global
// memory, read with k and units clamped into range.
template <int TM, bool SMEM_W>
__device__ __forceinline__ void accumulate(float (&acc)[TM][kTN][4], const float* a, int as,
                                           int k_len, const float* ws, int nu,
                                           const float* __restrict__ wg, int rows, int hidden,
                                           int u0) {
  const size_t gs = (size_t)rows * hidden;   // gate stride of wg
  const int ua = min(u0, hidden - 1);
  const int ub = min(u0 + 1, hidden - 1);
#pragma unroll 1
  for (int k = 0; k < k_len; k += 4) {
    float4 av[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) av[r] = *reinterpret_cast<const float4*>(a + r * as + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 w0, w1;   // gates (i, f, g, o) of units u0 and u0 + 1
      if constexpr (SMEM_W) {
        const float* wk = ws + (size_t)(k + e) * 8 * nu;
        w0 = *reinterpret_cast<const float4*>(wk);
        w1 = *reinterpret_cast<const float4*>(wk + 4 * nu);
      } else {
        const float* wk = wg + (size_t)min(k + e, rows - 1) * hidden;
        w0 = make_float4(__ldg(wk + ua), __ldg(wk + gs + ua), __ldg(wk + 2 * gs + ua),
                         __ldg(wk + 3 * gs + ua));
        w1 = make_float4(__ldg(wk + ub), __ldg(wk + gs + ub), __ldg(wk + 2 * gs + ub),
                         __ldg(wk + 3 * gs + ub));
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float x = comp(av[r], e);
        acc[r][0][0] = fmaf(x, w0.x, acc[r][0][0]);
        acc[r][0][1] = fmaf(x, w0.y, acc[r][0][1]);
        acc[r][0][2] = fmaf(x, w0.z, acc[r][0][2]);
        acc[r][0][3] = fmaf(x, w0.w, acc[r][0][3]);
        acc[r][1][0] = fmaf(x, w1.x, acc[r][1][0]);
        acc[r][1][1] = fmaf(x, w1.y, acc[r][1][1]);
        acc[r][1][2] = fmaf(x, w1.z, acc[r][1][2]);
        acc[r][1][3] = fmaf(x, w1.w, acc[r][1][3]);
      }
    }
  }
}

// Stage x_t of the block's rows as f32 into x_s ([BM][xs_ld]); rows past B
// and columns past In read as zeros.  VEC: cp.async of 16 bytes (f32, In a
// multiple of 4, xs on 16 bytes); the caller commits and waits.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_x(float* x_s, int xs_ld, const T* __restrict__ xs, int t,
                                        int m0, int bm, int batch, int in_dim, int kx) {
  const int nthreads = blockDim.x;
  const T* xt = xs + ((size_t)t * batch + m0) * in_dim;
  if constexpr (VEC) {
    const int cpr = in_dim / 4;
    for (int e = threadIdx.x; e < bm * cpr; e += nthreads) {
      const int r = e / cpr;
      const int cc = e - r * cpr;
      const bool ok = m0 + r < batch;
      cp_async16(x_s + r * xs_ld + 4 * cc, ok ? xt + (size_t)r * in_dim + 4 * cc : xs, ok);
    }
  } else {
    for (int e = threadIdx.x; e < bm * kx; e += nthreads) {
      const int r = e / kx;
      const int kk = e - r * kx;
      x_s[r * xs_ld + kk] =
          m0 + r < batch && kk < in_dim ? to_f32(xt[(size_t)r * in_dim + kk]) : 0.0f;
    }
  }
}

// Block: nu * nr threads, nu = ceil(H / kTN); thread tid owns unit pair
// tn = tid % nu and rows tm*TM .. +TM-1 (tm = tid / nu) of the block's BM =
// nr*TM rows.  Grid: ceil(B / BM).  Dynamic shared memory, in floats:
// [weights 8*nu*(kx+kh) when SMEM_W | x_s 2*BM*(kx+4) | h_s 2*BM*(kh+4)],
// kx, kh = In, H rounded up to multiples of 4.
template <typename T, bool PWL, bool SMEM_W, int TM>
__global__ void __launch_bounds__(max_threads(TM), 1) lstm_seq_kernel(
    const T* __restrict__ xs, const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ wx, const float* __restrict__ wh, const float* __restrict__ b,
    T* __restrict__ ys, float* __restrict__ h_out, float* __restrict__ c_out, int t_len,
    int batch, int in_dim, int hidden, int nr, bool vec_x, bool vec_y) {
  extern __shared__ __align__(16) float smem[];
  const int nu = (hidden + kTN - 1) / kTN;
  const int bm = nr * TM;
  const int kx = (in_dim + 3) & ~3;
  const int kh = (hidden + 3) & ~3;
  const int xs_ld = kx + 4;
  const int hs_ld = kh + 4;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tn = tid % nu;
  const int tm = tid / nu;
  const int u0 = kTN * tn;
  const int m0 = blockIdx.x * bm;
  const int r0 = tm * TM;   // the thread's first row in the block

  float* w_s = smem;
  float* x_s = smem + (SMEM_W ? (size_t)8 * nu * (kx + kh) : 0);
  float* h_s = x_s + (size_t)2 * bm * xs_ld;

  if constexpr (SMEM_W) {
    // [k][unit parity][unit pair][gate], k over [x | h] padded to kx + kh,
    // units to 2 * nu; read coalesced along units
    const int hp = kTN * nu;
    const int n = (kx + kh) * 4 * hp;
    for (int e = tid; e < n; e += nthreads) {
      const int u = e % hp;
      const int rest = e / hp;
      const int g = rest & 3;
      const int k = rest >> 2;
      float w = 0.0f;
      if (u < hidden) {
        if (k < kx) {
          if (k < in_dim) w = wx[((size_t)g * in_dim + k) * hidden + u];
        } else if (k - kx < hidden) {
          w = wh[((size_t)g * hidden + (k - kx)) * hidden + u];
        }
      }
      w_s[((size_t)(k * kTN + (u & 1)) * nu + (u >> 1)) * 4 + g] = w;
    }
  }
  // h_{-1} = h0 in x's type in buffer 0; rows past B, columns past H and
  // the whole of buffer 1 read as zeros until written
  for (int e = tid; e < 2 * bm * hs_ld; e += nthreads) {
    const int r = e / hs_ld;
    const int k = e - r * hs_ld;
    const int row = m0 + r;
    h_s[e] = r < bm && row < batch && k < hidden
                 ? round_to(h0[(size_t)row * hidden + k], (T*)nullptr)
                 : 0.0f;
  }
  if (vec_x) {
    stage_x<T, true>(x_s, xs_ld, xs, 0, m0, bm, batch, in_dim, kx);
  } else {
    stage_x<T, false>(x_s, xs_ld, xs, 0, m0, bm, batch, in_dim, kx);
  }
  cp_async_commit();

  float bias[kTN][4];
  float c[TM][kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int u = u0 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[j][g] = u < hidden ? b[g * hidden + u] : 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = m0 + r0 + r;
      c[r][j] = u < hidden && row < batch ? c0[(size_t)row * hidden + u] : 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();   // weights, h_{-1} and x_0 are in shared memory

  const float* wsx = w_s + (size_t)tn * 4;                           // x part of the weights
  const float* wsh = w_s + (size_t)8 * nu * kx + (size_t)tn * 4;     // h part
  for (int t = 0; t < t_len; ++t) {
    const int cur = t & 1;
    float* x_nxt = x_s + (size_t)(cur ^ 1) * bm * xs_ld;
    float* h_nxt = h_s + (size_t)(cur ^ 1) * bm * hs_ld;
    if (vec_x && t + 1 < t_len) {   // x_{t+1} lands while step t computes
      stage_x<T, true>(x_nxt, xs_ld, xs, t + 1, m0, bm, batch, in_dim, kx);
    }
    cp_async_commit();

    float acc[TM][kTN][4];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][j][g] = bias[j][g];
      }
    }
    accumulate<TM, SMEM_W>(acc, x_s + (size_t)cur * bm * xs_ld + r0 * xs_ld, xs_ld, kx, wsx,
                           nu, wx, in_dim, hidden, u0);
    accumulate<TM, SMEM_W>(acc, h_s + (size_t)cur * bm * hs_ld + r0 * hs_ld, hs_ld, kh, wsh,
                           nu, wh, hidden, hidden, u0);

#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = m0 + r0 + r;
      float hv[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float* p = acc[r][j];
        c[r][j] = sigmoid_act<PWL>(p[1]) * c[r][j] + sigmoid_act<PWL>(p[0]) * tanh_act<PWL>(p[2]);
        hv[j] = sigmoid_act<PWL>(p[3]) * tanh_act<PWL>(c[r][j]);
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (u0 + j < hidden) h_nxt[(r0 + r) * hs_ld + u0 + j] = round_to(hv[j], (T*)nullptr);
      }
      if (row < batch) {
        T* yrow = ys + ((size_t)t * batch + row) * hidden;
        if (vec_y) {   // H even: both units are real
          store2(yrow + u0, hv[0], hv[1]);
        } else {
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            if (u0 + j < hidden) store(yrow + u0 + j, hv[j]);
          }
        }
        if (t == t_len - 1) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            if (u0 + j < hidden) {
              h_out[(size_t)row * hidden + u0 + j] = hv[j];
              c_out[(size_t)row * hidden + u0 + j] = c[r][j];
            }
          }
        }
      }
    }
    if (!vec_x && t + 1 < t_len) {
      stage_x<T, false>(x_nxt, xs_ld, xs, t + 1, m0, bm, batch, in_dim, kx);
    }
    cp_async_wait_all();
    __syncthreads();   // h_t and x_{t+1} are in shared memory; step t's reads are done
  }
}

struct Plan {
  int tm;           // rows per thread
  int nr;           // row groups per block (BM = nr * tm)
  int nu;           // threads along H
  bool smem_w;      // weights stationary in shared memory
  size_t smem;      // dynamic shared memory per block, bytes
};

long long blocks(int batch, int bm) { return (batch + bm - 1) / bm; }

int make_plan(int batch, int in_dim, int hidden, Plan* p) {
  if (batch <= 0 || in_dim <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  if (hidden > kMaxHidden) return (int)cudaErrorInvalidValue;
  int dev = 0;
  int optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const int nu = (hidden + kTN - 1) / kTN;
  const size_t kx = (size_t)((in_dim + 3) & ~3);
  const size_t kh = (size_t)((hidden + 3) & ~3);
  const size_t weights = sizeof(float) * 8 * (size_t)nu * (kx + kh);
  auto buffers = [&](int bm) { return sizeof(float) * 2 * (size_t)bm * (kx + 4 + kh + 4); };

  // the most threads first (up to kTargetThreads), then the most rows per thread
  int tm = 0;
  int nr = 0;
  int top = 1;
  while (2 * top * nu <= kTargetThreads) top *= 2;
  for (int r = top; r >= 1 && !tm && (r == top || r * nu >= 128); r /= 2) {
    for (int cand : {8, 4, 1}) {
      if (r * nu <= max_threads(cand) && blocks(batch, r * cand) >= kTargetBlocks) {
        tm = cand;
        nr = r;
        break;
      }
    }
  }
  if (!tm) {   // a small batch: one row per thread, no more row groups than rows
    tm = 1;
    nr = 1;
    while (2 * nr * nu <= kTargetThreads && nr < batch) nr *= 2;
  }
  while (buffers(nr * tm) > (size_t)optin && nr > 1) nr /= 2;   // wide x rows
  if (buffers(nr * tm) > (size_t)optin && tm > 1) tm = 1;
  if (buffers(nr * tm) > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  p->tm = tm;
  p->nr = nr;
  p->nu = nu;
  p->smem_w = weights + buffers(nr * tm) <= (size_t)optin;
  p->smem = (p->smem_w ? weights : 0) + buffers(nr * tm);
  return 0;
}

template <typename T, bool PWL, bool SMEM_W, int TM>
int launch(const Plan& p, cudaStream_t stream, const void* xs, const void* h0,
           const void* c0, const void* wx, const void* wh, const void* b,
           void* ys, void* h_out, void* c_out, int t_len, int batch,
           int in_dim, int hidden, bool vec_x, bool vec_y) {
  if (p.smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_kernel<T, PWL, SMEM_W, TM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)blocks(batch, p.nr * TM));
  lstm_seq_kernel<T, PWL, SMEM_W, TM><<<grid, p.nu * p.nr, p.smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const float*>(h0),
      static_cast<const float*>(c0), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(b),
      static_cast<T*>(ys), static_cast<float*>(h_out),
      static_cast<float*>(c_out), t_len, batch, in_dim, hidden, p.nr, vec_x, vec_y);
  return (int)cudaGetLastError();
}

template <typename T, bool PWL, bool SMEM_W>
int dispatch_tm(const Plan& p, cudaStream_t s, const void* xs, const void* h0, const void* c0,
                const void* wx, const void* wh, const void* b, void* ys, void* h_out,
                void* c_out, int t_len, int batch, int in_dim, int hidden, bool vec_x,
                bool vec_y) {
#define LSTM_SEQ_LAUNCH(TM)                                                                \
  launch<T, PWL, SMEM_W, TM>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, \
                             in_dim, hidden, vec_x, vec_y)
  if (p.tm == 8) return LSTM_SEQ_LAUNCH(8);
  if (p.tm == 4) return LSTM_SEQ_LAUNCH(4);
  return LSTM_SEQ_LAUNCH(1);
#undef LSTM_SEQ_LAUNCH
}

template <typename T>
int dispatch(const Plan& p, int pwl, cudaStream_t s, const void* xs, const void* h0,
             const void* c0, const void* wx, const void* wh, const void* b, void* ys,
             void* h_out, void* c_out, int t_len, int batch, int in_dim, int hidden,
             bool vec_x, bool vec_y) {
  if (pwl) {
    if (p.smem_w) return dispatch_tm<T, true, true>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden, vec_x, vec_y);
    return dispatch_tm<T, true, false>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden, vec_x, vec_y);
  }
  if (p.smem_w) return dispatch_tm<T, false, true>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden, vec_x, vec_y);
  return dispatch_tm<T, false, false>(p, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden, vec_x, vec_y);
}

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) % n) == 0; }

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers of
// contiguous row-major tensors: xs (T, B, In) and ys (T, B, H) of the type
// named by is_bf16; h0, c0, h_out, c_out (B, H), wx (4, In, H), wh (4, H, H),
// b (4, H) f32.  ys, h_out and c_out must not overlap the inputs.  Launches
// once on `stream` and does not synchronise.  Returns 0 or a cudaError_t
// (a refused plan: H > 1024 or rows too wide for shared memory; or
// cudaGetLastError() after the launch).
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
  const bool vec_x = !is_bf16 && in_dim % 4 == 0 && aligned(xs, 16);
  const bool vec_y = hidden % 2 == 0 && aligned(ys, is_bf16 ? 4 : 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(p, pwl, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden, vec_x, vec_y);
  }
  return dispatch<float>(p, pwl, s, xs, h0, c0, wx, wh, b, ys, h_out, c_out, t_len, batch, in_dim, hidden, vec_x, vec_y);
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

// The tile of a launch of this shape on the current device: BM rows per
// block and TM rows per thread (see the header), or minus a cudaError_t
// when no plan exists.  Exposed so that callers can log it.
extern "C" int lstm_seq_tile(int batch, int in_dim, int hidden, int* bm, int* tm) {
  Plan p;
  const int rc = make_plan(batch, in_dim, hidden, &p);
  if (rc != 0) return -rc;
  *bm = p.nr * p.tm;
  *tm = p.tm;
  return 0;
}

extern "C" const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
