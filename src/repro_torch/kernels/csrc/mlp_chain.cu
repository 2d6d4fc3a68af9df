// Fused (gated) MLP chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_mlp_chain`
// (src/repro/kernels/gemm_chain.py:205, body `_mlp_kernel`).  It
// computes the same function with the same rounding points:
//
//   E = (act(A Wg) * (A Wu)) Wd        gated
//   E = act(A Wu) Wd                   ungated
//
// both up-projections accumulated in f32, the hidden block rounded to
// the promoted weight type (bf16 only when A and the weights are both
// bf16), E accumulated in f32 across the n blocks and cast once to A's
// type.  A may be f32 while the weights are bf16 (the f32-wide output
// of a stitched ln2 prologue): the weights are widened in registers,
// which is exact, so no f32 copy of them is ever made.  gelu is the
// tanh form (jax.nn.gelu's default).
//
// Design: the grid is the one the tuned schedule defines — (m tiles,
// E column tiles, batch), with one E column tile of the whole H for the
// flat class and H/bh of them for the deep class.  The Pallas grid's
// sequential (n, k) axes become two loops inside the block: for every
// n block the A, Wu and Wg tiles of each k step are staged in shared
// memory with 16-byte loads, eight in flight per thread (issued one
// after another, a step paid a dozen memory latencies in a row); a
// thread owns one column of the (bm, bn) up-projection block for 8 rows
// at a time (accumulators in registers within a k step, in shared
// memory across them); the activation runs in place, and each thread
// owns E columns, streaming its Wd column from device memory (never
// staged, eight rows of it in flight) with 8 rows of E per pass.  Ragged
// edges are masked: zero-filled loads are exact because act(0) * 0 = 0
// and act(0) = 0 for silu, gelu and relu, and no padded copy of any
// operand is made.  The shared-memory layout is exactly
// `mlp_smem_bytes` in core/perf_model.py, which Rule 4 of the tuner and
// the Python wrapper both check.
//
// Bound: at decode (M = 4 rows for qwen3-8b) the chain is bound by the
// bytes of its weights, 302 MB per call at full width (Wg, Wu, Wd in
// bf16): 0.090 ms at 3.35 TB/s.  What this simple design leaves on the
// table: the deep class recomputes A Wg and A Wu for every E column
// tile, so each of the H/bh blocks streams all of Wg and Wu through
// its own SM (8 blocks on 132 SMs at decode) — splitting n across
// blocks with a second pass over the partial E is the first lever; no
// tensor cores (wgmma) and no asynchronous copies (cp.async / TMA), so
// loads and FMAs do not overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;    // rows one thread carries in registers
constexpr int kInFlight = 8;  // loads a thread issues before it waits

enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == kSilu) return x * (1.f / (1.f + expf(-x)));
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
  }
  return fmaxf(x, 0.f);
}

// Copy a (rows, cols) tile whose row r starts at src + r * ld into dst
// (row-major, `cols` wide), zero-filling rows >= valid_rows and columns
// >= valid_cols; 16 bytes a thread-step when both ends are aligned, with
// kInFlight loads issued before the first store so their latencies
// overlap.
template <typename T>
__device__ void stage_tile(T* __restrict__ dst, const T* __restrict__ src,
                           int rows, int cols, long long ld, int valid_rows,
                           int valid_cols) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = cols % V == 0 && ld % V == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (vec) {
    const int cv = cols / V;
    const int total = rows * cv;
    for (int base = threadIdx.x; base < total;
         base += kInFlight * kThreads) {
      int4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int e = base + u * kThreads;
        const int r = e / cv;
        const int c = (e - r * cv) * V;
        v[u] = make_int4(0, 0, 0, 0);
        if (e < total && r < valid_rows && c + V <= valid_cols)
          v[u] = __ldg(reinterpret_cast<const int4*>(src + r * ld + c));
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int e = base + u * kThreads;
        if (e >= total) break;
        const int r = e / cv;
        const int c = (e - r * cv) * V;
        T* d = dst + r * cols + c;
        if (r >= valid_rows || c + V <= valid_cols) {
          *reinterpret_cast<int4*>(d) = v[u];  // a full chunk, or zeros
        } else {                               // the ragged column edge
          const T* s = src + r * ld + c;
          for (int i = 0; i < V; ++i)
            d[i] = c + i < valid_cols ? s[i] : from_f32<T>(0.f);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      const int c = e - r * cols;
      dst[e] = (r < valid_rows && c < valid_cols) ? src[r * ld + c]
                                                  : from_f32<T>(0.f);
    }
  }
}

template <typename TA, typename TW, bool GATED>
__global__ void __launch_bounds__(kThreads) mlp_chain_kernel(
    const TA* __restrict__ a, const TW* __restrict__ wu,
    const TW* __restrict__ wg, const TW* __restrict__ wd,
    TA* __restrict__ e_out, int m, int n, int k, int h, int bm, int bn,
    int bk, int be, int act, int round_hidden) {
  const int row0 = blockIdx.x * bm;
  const int col0 = blockIdx.y * be;
  const int b = blockIdx.z;
  const int rows = min(bm, m - row0);  // valid rows of this block
  const int cols = min(be, h - col0);  // valid E columns of this block
  constexpr int nw = GATED ? 2 : 1;

  // layout == mlp_smem_bytes(bm, bn, bk, be, sizeof(TA), sizeof(TW),
  // GATED): the f32 sections, then the staged tiles, wider type first
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_u = reinterpret_cast<float*>(smem);
  float* s_g = GATED ? s_u + bm * bn : s_u;
  float* s_e = s_g + bm * bn;
  unsigned char* tail = reinterpret_cast<unsigned char*>(s_e + bm * be);
  TA* s_a;
  TW* s_wu;
  if (sizeof(TW) >= sizeof(TA)) {
    s_wu = reinterpret_cast<TW*>(tail);
    s_a = reinterpret_cast<TA*>(s_wu + nw * bk * bn);
  } else {
    s_a = reinterpret_cast<TA*>(tail);
    s_wu = reinterpret_cast<TW*>(s_a + bm * bk);
  }
  TW* s_wg = s_wu + bk * bn;  // read only when GATED

  const TA* a_b = a + static_cast<size_t>(b) * m * k +
                  static_cast<size_t>(row0) * k;
  const TW* wu_b = wu + static_cast<size_t>(b) * k * n;
  const TW* wg_b = GATED ? wg + static_cast<size_t>(b) * k * n : wu_b;
  const TW* wd_b = wd + static_cast<size_t>(b) * n * h + col0;
  const int chunks = (bm + kRows - 1) / kRows;

  for (int i = threadIdx.x; i < bm * be; i += kThreads) s_e[i] = 0.f;

  for (int n0 = 0; n0 < n; n0 += bn) {
    const int ncols = min(bn, n - n0);
    for (int i = threadIdx.x; i < bm * bn; i += kThreads) {
      s_u[i] = 0.f;
      if (GATED) s_g[i] = 0.f;
    }
    for (int k0 = 0; k0 < k; k0 += bk) {
      const int kr = min(bk, k - k0);
      __syncthreads();  // the previous tiles are no longer read
      stage_tile(s_a, a_b + k0, bm, bk, k, rows, kr);
      stage_tile(s_wu, wu_b + static_cast<size_t>(k0) * n + n0, bk, bn, n,
                 kr, ncols);
      if (GATED)
        stage_tile(s_wg, wg_b + static_cast<size_t>(k0) * n + n0, bk, bn,
                   n, kr, ncols);
      __syncthreads();

      // U (+)= A Wu, G (+)= A Wg: a thread owns column j, kRows rows
      for (int p = threadIdx.x; p < bn * chunks; p += kThreads) {
        const int j = p % bn;
        const int r0 = (p / bn) * kRows;
        float au[kRows], ag[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) au[r] = ag[r] = 0.f;
        for (int kk = 0; kk < bk; ++kk) {
          const float u = to_f32(s_wu[kk * bn + j]);
          const float g = GATED ? to_f32(s_wg[kk * bn + j]) : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r0 + r < bm) {
              const float x = to_f32(s_a[(r0 + r) * bk + kk]);
              au[r] = fmaf(x, u, au[r]);
              if (GATED) ag[r] = fmaf(x, g, ag[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r0 + r < bm) {
            s_u[(r0 + r) * bn + j] += au[r];
            if (GATED) s_g[(r0 + r) * bn + j] += ag[r];
          }
        }
      }
    }
    __syncthreads();

    // hidden = act(G) * U (or act(U)), rounded to the promoted weight
    // type, in place of U
    for (int i = threadIdx.x; i < bm * bn; i += kThreads) {
      float x = GATED ? act_fn(s_g[i], act) * s_u[i] : act_fn(s_u[i], act);
      if (round_hidden) x = __bfloat162float(__float2bfloat16(x));
      s_u[i] = x;
    }
    __syncthreads();

    // E += hidden Wd: a thread owns E column c, kRows rows per pass,
    // kInFlight rows of Wd loaded before they are used
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      const TW* wcol = wd_b + static_cast<size_t>(n0) * h + c;
      for (int r0 = 0; r0 < rows; r0 += kRows) {
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        for (int j0 = 0; j0 < ncols; j0 += kInFlight) {
          float w[kInFlight];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q)
            w[q] = j0 + q < ncols
                       ? to_f32(wcol[static_cast<size_t>(j0 + q) * h])
                       : 0.f;
#pragma unroll
          for (int q = 0; q < kInFlight; ++q)
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              if (r0 + r < rows && j0 + q < ncols)
                acc[r] = fmaf(s_u[(r0 + r) * bn + j0 + q], w[q], acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < rows) s_e[(r0 + r) * be + c] += acc[r];
      }
    }
    __syncthreads();  // hidden is no longer read; E is complete so far
  }

  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    e_out[(static_cast<size_t>(b) * m + row0 + r) * h + col0 + c] =
        from_f32<TA>(s_e[r * be + c]);
  }
}

template <typename TA, typename TW, bool GATED>
int launch(const void* a, const void* wu, const void* wg, const void* wd,
           void* e, int batch, int m, int n, int k, int h, int bm, int bn,
           int bk, int be, int act, int round_hidden, size_t smem,
           cudaStream_t stream) {
  auto kernel = mlp_chain_kernel<TA, TW, GATED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + bm - 1) / bm, (h + be - 1) / be, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TA*>(a), static_cast<const TW*>(wu),
      static_cast<const TW*>(wg), static_cast<const TW*>(wd),
      static_cast<TA*>(e), m, n, k, h, bm, bn, bk, be, act, round_hidden);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TW>
int launch_gated(int gated, const void* a, const void* wu, const void* wg,
                 const void* wd, void* e, int batch, int m, int n, int k,
                 int h, int bm, int bn, int bk, int be, int act,
                 int round_hidden, size_t smem, cudaStream_t stream) {
  if (gated)
    return launch<TA, TW, true>(a, wu, wg, wd, e, batch, m, n, k, h, bm, bn,
                                bk, be, act, round_hidden, smem, stream);
  return launch<TA, TW, false>(a, wu, wg, wd, e, batch, m, n, k, h, bm, bn,
                               bk, be, act, round_hidden, smem, stream);
}

}  // namespace

extern "C" {

// a_dtype / w_dtype: 0 = float32, 1 = bfloat16 (E takes a's type);
// act: 0 = silu, 1 = gelu (tanh form), 2 = relu; be: the E tile width
// (bh for the deep class, H for the flat class).  Returns
// cudaGetLastError() after the launch (0 on success); the caller
// validated every shape, tile and the shared-memory size.
int mlp_chain_launch(int a_dtype, int w_dtype, int gated, int act,
                     const void* a, const void* wu, const void* wg,
                     const void* wd, void* e, int batch, int m, int n, int k,
                     int h, int bm, int bn, int bk, int be,
                     long long smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const int round_hidden = a_dtype == 1 && w_dtype == 1;
  if (a_dtype == 0 && w_dtype == 0)
    return launch_gated<float, float>(gated, a, wu, wg, wd, e, batch, m, n,
                                      k, h, bm, bn, bk, be, act,
                                      round_hidden, smem, s);
  if (a_dtype == 0 && w_dtype == 1)
    return launch_gated<float, __nv_bfloat16>(gated, a, wu, wg, wd, e,
                                              batch, m, n, k, h, bm, bn, bk,
                                              be, act, round_hidden, smem, s);
  if (a_dtype == 1 && w_dtype == 0)
    return launch_gated<__nv_bfloat16, float>(gated, a, wu, wg, wd, e,
                                              batch, m, n, k, h, bm, bn, bk,
                                              be, act, round_hidden, smem, s);
  if (a_dtype == 1 && w_dtype == 1)
    return launch_gated<__nv_bfloat16, __nv_bfloat16>(
        gated, a, wu, wg, wd, e, batch, m, n, k, h, bm, bn, bk, be, act,
        round_hidden, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
