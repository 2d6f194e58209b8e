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
// x and h are f32 or bf16 (widened to f32; the weights stay f32, as JAX
// promotes bf16 x f32 to f32); c is f32; h' is written in h's type, c' in f32.
//
// Bound on an H100 SXM, per launch: about 8*B*H*(In+H) FLOP on the FP32
// cores (no tensor cores: the f32 bar is 1e-5, which plain TF32 cannot meet), and
// about B*(In+H)*s + B*H*(8+s) + 16*H*(In+H) bytes (s = bytes of x/h).  At
// the paper's widths (In, H <= 64) and a large batch the operations bound it.
//
// Design: one launch is a GEMM [x | h] (B x K, K = In + H) times W (K x 4H)
// with the LSTM update fused into its epilogue.  A block owns BM batch rows
// x BN hidden units with all four gates of those units, so c'/h' are
// computed from registers.  The contraction runs in chunks of kBK = 16
// through shared memory, the x part first and then the h part (the In
// boundary is handled per k inside the loop), double-buffered: chunk c+1 is
// copied (cp.async, 16 bytes, where rows and pointers are 16-byte aligned
// and x/h are f32; plain loads otherwise) while chunk c computes.  Each
// thread accumulates a TM-rows x (4 gates x kTN = 2 units) micro-tile: per
// four k, TM 16-byte activation loads and 16 8-byte weight loads from shared
// memory feed 32*TM FMAs.  The first design gave each thread one (row, unit)
// and fed every FMA with its own load of a weight from L1/L2, never reusing
// a weight across rows, so it was bound by its load instructions.
//
// Tiles by shape: BN is the smallest of 8, 16, 32 that covers H; BM is 64
// (TM = 4) while the grid keeps at least kTargetBlocks blocks, else 16
// (TM = 1), and then BN shrinks toward 8 until it does, so a small batch
// (the gateway's 256-row flushes, B = 1) spreads over hidden-unit blocks.
// Shared memory is fixed per tile (at most 26,624 bytes), whatever In and H,
// so any width is taken.  Grid: (ceil(H / BN), ceil(B / BM)); CUDA caps the
// second dimension at 65,535 blocks, so one launch takes at most
// 65,535 * 64 = 4,194,240 rows and refuses more.
//
// Aliasing: h_out must not overlap x or h (every block of a row reads the
// whole h row); c_out may be c itself (each thread reads and writes only its
// own elements), which the "fused" schedule uses to update c in place.
//
// Left for later: a CUDA graph over the per-request launches (the serving
// path issues one launch per layer and timestep and is host-bound), and
// persistence across timesteps (K2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBK = 16;             // contraction chunk
constexpr int kTN = 2;              // hidden units per thread
constexpr int kTargetBlocks = 128;  // about one block per SM of an H100 (132 SMs)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Block: 16 * BN / kTN threads; thread (tm, tn) owns rows tm*TM .. +TM-1 and
// units tn*kTN .. +kTN-1 of the tile, all four gates.
template <typename T, bool PWL, int BM, int BN>
__global__ void __launch_bounds__(16 * BN / kTN) lstm_cell_kernel(
    const T* __restrict__ x, const T* __restrict__ h, const float* c,
    const float* __restrict__ wx, const float* __restrict__ wh,
    const float* __restrict__ b, T* __restrict__ h_out, float* c_out,
    int batch, int in_dim, int hidden, bool vec_a, bool vec_w) {
  constexpr int TM = BM / 16;
  constexpr int NTHREADS = 16 * BN / kTN;
  constexpr int AS = kBK + 4;   // row stride of the activation tile (16-byte rows, no bank conflicts)
  __shared__ __align__(16) float a_s[2][BM][AS];        // [x | h] chunk, row-major
  __shared__ __align__(16) float w_s[2][kBK][4][BN];    // weight chunk, gate-major per k

  const int tid = threadIdx.x;
  const int tn = tid % (BN / kTN);
  const int tm = tid / (BN / kTN);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_dim = in_dim + hidden;
  const int n_chunks = (k_dim + kBK - 1) / kBK;

  // copy chunk `ch` of [x | h] rows m0.. and of W units n0.. into buffer `buf`;
  // rows past B, units past H and k past In + H read as zeros
  auto load_chunk = [&](int ch, int buf) {
    const int k0 = ch * kBK;
    if (vec_a) {   // f32, In and H multiples of 4, 16-byte aligned: 4 k per copy
      for (int e = tid; e < BM * (kBK / 4); e += NTHREADS) {
        const int r = e / (kBK / 4);
        const int k = k0 + 4 * (e - r * (kBK / 4));
        const int row = m0 + r;
        const bool ok = row < batch && k < k_dim;
        const T* src = x;
        if (ok) src = k < in_dim ? x + (size_t)row * in_dim + k
                                 : h + (size_t)row * hidden + (k - in_dim);
        cp_async16(&a_s[buf][r][k - k0], src, ok);
      }
    } else {
      for (int e = tid; e < BM * kBK; e += NTHREADS) {
        const int r = e / kBK;
        const int kl = e - r * kBK;
        const int k = k0 + kl;
        const int row = m0 + r;
        float v = 0.0f;
        if (row < batch && k < k_dim) {
          v = k < in_dim ? to_f32(x[(size_t)row * in_dim + k])
                         : to_f32(h[(size_t)row * hidden + (k - in_dim)]);
        }
        a_s[buf][r][kl] = v;
      }
    }
    if (vec_w) {   // H a multiple of 4, 16-byte aligned: 4 units per copy
      for (int e = tid; e < kBK * 4 * (BN / 4); e += NTHREADS) {
        const int kl = e / (4 * (BN / 4));
        const int rest = e - kl * (4 * (BN / 4));
        const int g = rest / (BN / 4);
        const int nl = 4 * (rest - g * (BN / 4));
        const int k = k0 + kl;
        const int n = n0 + nl;
        const bool ok = k < k_dim && n < hidden;
        const float* src = wx;
        if (ok) src = k < in_dim ? wx + ((size_t)g * in_dim + k) * hidden + n
                                 : wh + ((size_t)g * hidden + (k - in_dim)) * hidden + n;
        cp_async16(&w_s[buf][kl][g][nl], src, ok);
      }
    } else {
      for (int e = tid; e < kBK * 4 * BN; e += NTHREADS) {
        const int kl = e / (4 * BN);
        const int rest = e - kl * (4 * BN);
        const int g = rest / BN;
        const int nl = rest - g * BN;
        const int k = k0 + kl;
        const int n = n0 + nl;
        float v = 0.0f;
        if (k < k_dim && n < hidden) {
          v = k < in_dim ? __ldg(wx + ((size_t)g * in_dim + k) * hidden + n)
                         : __ldg(wh + ((size_t)g * hidden + (k - in_dim)) * hidden + n);
        }
        w_s[buf][kl][g][nl] = v;
      }
    }
  };

  float acc[4][TM][kTN];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[g][r][j] = 0.0f;
    }
  }

  load_chunk(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < n_chunks) load_chunk(ch + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // chunk ch has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        av[r] = *reinterpret_cast<const float4*>(&a_s[buf][tm * TM + r][kk]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 wv = *reinterpret_cast<const float2*>(&w_s[buf][kk + u][g][tn * kTN]);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float a = comp(av[r], u);
            acc[g][r][0] = fmaf(a, wv.x, acc[g][r][0]);
            acc[g][r][1] = fmaf(a, wv.y, acc[g][r][1]);
          }
        }
      }
    }
    __syncthreads();      // the next iteration copies into this buffer
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + tn * kTN + j;
    if (n >= hidden) continue;
    float bias[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = __ldg(b + g * hidden + n);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = m0 + tm * TM + r;
      if (row >= batch) continue;
      const size_t o = (size_t)row * hidden + n;
      const float c_new = sigmoid_act<PWL>(acc[1][r][j] + bias[1]) * c[o] +
                          sigmoid_act<PWL>(acc[0][r][j] + bias[0]) *
                              tanh_act<PWL>(acc[2][r][j] + bias[2]);
      const float h_new = sigmoid_act<PWL>(acc[3][r][j] + bias[3]) * tanh_act<PWL>(c_new);
      c_out[o] = c_new;
      store(h_out + o, h_new);
    }
  }
}

template <typename T, bool PWL, int BM, int BN>
void launch(cudaStream_t stream, const void* x, const void* h, const void* c, const void* wx,
            const void* wh, const void* b, void* h_out, void* c_out, int batch, int in_dim,
            int hidden, bool vec_a, bool vec_w) {
  const dim3 grid((unsigned)((hidden + BN - 1) / BN), (unsigned)((batch + BM - 1) / BM));
  lstm_cell_kernel<T, PWL, BM, BN><<<grid, 16 * BN / kTN, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const float*>(c),
      static_cast<const float*>(wx), static_cast<const float*>(wh),
      static_cast<const float*>(b), static_cast<T*>(h_out), static_cast<float*>(c_out),
      batch, in_dim, hidden, vec_a, vec_w);
}

template <typename T, bool PWL>
void dispatch(int bm, int bn, cudaStream_t s, const void* x, const void* h, const void* c,
              const void* wx, const void* wh, const void* b, void* h_out, void* c_out,
              int batch, int in_dim, int hidden, bool vec_a, bool vec_w) {
#define LSTM_CELL_LAUNCH(BM, BN)                                                            \
  launch<T, PWL, BM, BN>(s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden, vec_a, \
                         vec_w)
  if (bm == 64) {
    if (bn == 32) LSTM_CELL_LAUNCH(64, 32);
    else if (bn == 16) LSTM_CELL_LAUNCH(64, 16);
    else LSTM_CELL_LAUNCH(64, 8);
  } else {
    if (bn == 32) LSTM_CELL_LAUNCH(16, 32);
    else if (bn == 16) LSTM_CELL_LAUNCH(16, 16);
    else LSTM_CELL_LAUNCH(16, 8);
  }
#undef LSTM_CELL_LAUNCH
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

long long blocks(int batch, int hidden, int bm, int bn) {
  return (long long)((batch + bm - 1) / bm) * ((hidden + bn - 1) / bn);
}

}  // namespace

// The tile (BM rows, BN hidden units) a launch at this shape uses; see the
// header.  Exposed so that callers can log it.
extern "C" void lstm_cell_tile(int batch, int hidden, int* bm, int* bn) {
  int n = hidden <= 8 ? 8 : hidden <= 16 ? 16 : 32;
  int m = 64;
  if (blocks(batch, hidden, m, n) < kTargetBlocks) m = 16;
  while (n > 8 && blocks(batch, hidden, m, n) < kTargetBlocks) n /= 2;
  *bm = m;
  *bn = n;
}

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
  int bm, bn;
  lstm_cell_tile(batch, hidden, &bm, &bn);
  const bool rows4 = in_dim % 4 == 0 && hidden % 4 == 0;
  const bool vec_a = !is_bf16 && rows4 && aligned16(x) && aligned16(h);
  const bool vec_w = hidden % 4 == 0 && aligned16(wx) && aligned16(wh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (pwl) dispatch<__nv_bfloat16, true>(bm, bn, s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden, vec_a, vec_w);
    else     dispatch<__nv_bfloat16, false>(bm, bn, s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden, vec_a, vec_w);
  } else {
    if (pwl) dispatch<float, true>(bm, bn, s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden, vec_a, vec_w);
    else     dispatch<float, false>(bm, bn, s, x, h, c, wx, wh, b, h_out, c_out, batch, in_dim, hidden, vec_a, vec_w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
