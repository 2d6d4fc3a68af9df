// Fused GEMM chains for Hopper (sm_90a): the paper's core artifact.
//
// Replaces two Pallas TPU kernels with the same rounding points:
//
// * `fused_gemm_chain` (src/repro/kernels/gemm_chain.py:80, body
//   `_chain_kernel`): E = (A B) D.  For every n block, C = A B is
//   accumulated in f32 over the k blocks, rounded to D's type, and
//   E += C D is accumulated in f32 over the n blocks; E is cast once to
//   A's type.
// * `fused_gemm_chain3` (src/repro/kernels/gemm_chain3.py:60, body
//   `_kernel`): G = ((A B) D) F, the flat machine above with the whole
//   (bm, H) E row on chip; after the last n block E is rounded to F's
//   type and G = E F is accumulated in f32 and cast to A's type.
//
// A, B, D (and F) share one type, f32 or bf16, as the JAX kernels take
// them; the tiles divide the dims (the wrapper checks, as the JAX
// kernels assert).
//
// Design: the grid is the one the tuned schedule defines — (m tiles, E
// column tiles, batch), with one E column tile of the whole H for the
// flat class (and for the three-GEMM kernel) and H/bh of them for the
// deep class, which recomputes C for each.  The Pallas grid's
// sequential (n, k) axes become two loops inside the block.  For every
// k step the A (bm, bk) and B (bk, bn) tiles are staged in shared
// memory with 16-byte loads, eight in flight per thread; a thread owns
// one column of the (bm, bn) C block for 8 rows at a time (accumulators
// in registers within a k step, in shared memory across them).  C is
// rounded in place, and each thread owns E columns, streaming its D
// column from device memory (never staged, eight rows in flight) with
// 8 rows of E per pass.  The three-GEMM kernel's last product reads F
// the same way.  The shared-memory layout is exactly
// `gemm_chain_smem_bytes` / `gemm_chain3_smem_bytes` in
// core/perf_model.py, which Rule 4 of the tuner and the Python wrappers
// both check.
//
// Bound: the paper's chains (Table II) are memory-bound on their I/O
// at the bf16 tensor-core rate, e.g. G4 (M = N = 512, K = H = 256)
// reads and writes ~1.3 MB against ~0.27 GFLOP; on CUDA cores at the
// f32 rate (67 TFLOP/s) the operations bound it instead.  What this
// simple design leaves on the table: no tensor cores (wgmma), no
// asynchronous copies (cp.async / TMA), so loads and FMAs do not
// overlap, and D is re-read from L1/L2 once per 8 rows of E.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;      // rows one thread carries in registers
constexpr int kInFlight = 8;  // loads a thread issues before it waits

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

// x rounded to T and widened back: the astype(T) before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Copy a (rows, cols) tile whose row r starts at src + r * ld into dst
// (row-major, `cols` wide); 16 bytes a thread-step when both ends are
// aligned, with kInFlight loads issued before the first store so their
// latencies overlap.
template <typename T>
__device__ void stage_tile(T* __restrict__ dst, const T* __restrict__ src,
                           int rows, int cols, long long ld) {
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
        if (e < total) {
          const int r = e / cv;
          const int c = (e - r * cv) * V;
          v[u] = __ldg(reinterpret_cast<const int4*>(src + r * ld + c));
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int e = base + u * kThreads;
        if (e < total) {
          const int r = e / cv;
          const int c = (e - r * cv) * V;
          *reinterpret_cast<int4*>(dst + r * cols + c) = v[u];
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      dst[e] = src[r * ld + (e - r * cols)];
    }
  }
}

// acc (rows, ldacc) f32 in shared memory += X (rows, kd) f32 in shared
// memory times the (kd, cols) block of W at w + j * ldw + c in device
// memory: a thread owns one accumulator column, kRows rows per pass,
// kInFlight rows of W loaded before they are used.  X holds values
// already rounded to W's type where the JAX kernel rounds them.
template <typename T>
__device__ void accumulate_from_global(float* __restrict__ acc, int ldacc,
                                       const float* __restrict__ x, int kd,
                                       const T* __restrict__ w,
                                       long long ldw, int rows, int cols) {
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const T* wcol = w + c;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = 0.f;
      for (int j0 = 0; j0 < kd; j0 += kInFlight) {
        float wv[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q)
          wv[q] = j0 + q < kd ? to_f32(wcol[(j0 + q) * ldw]) : 0.f;
#pragma unroll
        for (int q = 0; q < kInFlight; ++q)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r0 + r < rows && j0 + q < kd)
              a[r] = fmaf(x[(r0 + r) * kd + j0 + q], wv[q], a[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < rows) acc[(r0 + r) * ldacc + c] += a[r];
    }
  }
}

template <typename T, bool THREE>
__global__ void __launch_bounds__(kThreads) chain_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ d, const T* __restrict__ f, T* __restrict__ out,
    int m, int n, int k, int h, int g, int bm, int bn, int bk, int be) {
  const int row0 = blockIdx.x * bm;
  const int col0 = blockIdx.y * be;
  const int bz = blockIdx.z;
  const int chunks = (bm + kRows - 1) / kRows;

  // layout == gemm_chain_smem_bytes(bm, bn, bk, be, sizeof(T))
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_c = reinterpret_cast<float*>(smem);
  float* s_e = s_c + bm * bn;
  T* s_a = reinterpret_cast<T*>(s_e + bm * be);
  T* s_b = s_a + bm * bk;

  const T* a_b = a + (static_cast<size_t>(bz) * m + row0) * k;
  const T* b_b = b + static_cast<size_t>(bz) * k * n;
  const T* d_b = d + static_cast<size_t>(bz) * n * h + col0;

  for (int i = threadIdx.x; i < bm * be; i += kThreads) s_e[i] = 0.f;

  for (int n0 = 0; n0 < n; n0 += bn) {
    for (int i = threadIdx.x; i < bm * bn; i += kThreads) s_c[i] = 0.f;
    for (int k0 = 0; k0 < k; k0 += bk) {
      __syncthreads();  // the previous tiles are no longer read
      stage_tile(s_a, a_b + k0, bm, bk, k);
      stage_tile(s_b, b_b + static_cast<size_t>(k0) * n + n0, bk, bn, n);
      __syncthreads();

      // C (+)= A B: a thread owns column j, kRows rows
      for (int p = threadIdx.x; p < bn * chunks; p += kThreads) {
        const int j = p % bn;
        const int r0 = (p / bn) * kRows;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        for (int kk = 0; kk < bk; ++kk) {
          const float w = to_f32(s_b[kk * bn + j]);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r0 + r < bm)
              acc[r] = fmaf(to_f32(s_a[(r0 + r) * bk + kk]), w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < bm) s_c[(r0 + r) * bn + j] += acc[r];
      }
    }
    __syncthreads();

    // C rounded to D's type in place, then E += C D
    for (int i = threadIdx.x; i < bm * bn; i += kThreads)
      s_c[i] = round_to<T>(s_c[i]);
    __syncthreads();
    accumulate_from_global(s_e, be, s_c, bn,
                           d_b + static_cast<size_t>(n0) * h, h, bm, be);
    __syncthreads();  // C is no longer read; E is complete so far
  }

  if (!THREE) {
    for (int i = threadIdx.x; i < bm * be; i += kThreads) {
      const int r = i / be;
      const int c = i - r * be;
      out[(static_cast<size_t>(bz) * m + row0 + r) * h + col0 + c] =
          from_f32<T>(s_e[i]);
    }
    return;
  }

  // G = E F: E (bm, H) rounded to F's type in place; the (bm, G) result
  // accumulates in the C buffer's place when it fits there, else
  // column block by column block of bn
  for (int i = threadIdx.x; i < bm * h; i += kThreads)
    s_e[i] = round_to<T>(s_e[i]);
  const T* f_b = f + static_cast<size_t>(bz) * h * g;
  for (int g0 = 0; g0 < g; g0 += bn) {
    const int gc = min(bn, g - g0);
    __syncthreads();  // s_e rounded / the previous block stored
    for (int i = threadIdx.x; i < bm * gc; i += kThreads) s_c[i] = 0.f;
    __syncthreads();
    accumulate_from_global(s_c, gc, s_e, h, f_b + g0, g, bm, gc);
    __syncthreads();
    for (int i = threadIdx.x; i < bm * gc; i += kThreads) {
      const int r = i / gc;
      const int c = i - r * gc;
      out[(static_cast<size_t>(bz) * m + row0 + r) * g + g0 + c] =
          from_f32<T>(s_c[i]);
    }
  }
}

template <typename T, bool THREE>
int launch(const void* a, const void* b, const void* d, const void* f,
           void* out, int batch, int m, int n, int k, int h, int g, int bm,
           int bn, int bk, int be, size_t smem, cudaStream_t stream) {
  auto kernel = chain_kernel<T, THREE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m / bm, h / be, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(d), static_cast<const T*>(f),
      static_cast<T*>(out), m, n, k, h, g, bm, bn, bk, be);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// E = (A B) D.  dtype: 0 = float32, 1 = bfloat16; be: the E tile width
// (bh for the deep class, H for the flat class).  Returns
// cudaGetLastError() after the launch (0 on success); the caller
// validated every shape, tile and the shared-memory size.
int gemm_chain_launch(int dtype, const void* a, const void* b,
                      const void* d, void* e, int batch, int m, int n, int k,
                      int h, int bm, int bn, int bk, int be,
                      long long smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (dtype == 0)
    return launch<float, false>(a, b, d, nullptr, e, batch, m, n, k, h, 0,
                                bm, bn, bk, be, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(a, b, d, nullptr, e, batch, m, n, k,
                                        h, 0, bm, bn, bk, be, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// G = ((A B) D) F, the flat class (the whole E row on chip).  Same
// conventions as gemm_chain_launch.
int gemm_chain3_launch(int dtype, const void* a, const void* b,
                       const void* d, const void* f, void* out, int batch,
                       int m, int n, int k, int h, int g, int bm, int bn,
                       int bk, long long smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (dtype == 0)
    return launch<float, true>(a, b, d, f, out, batch, m, n, k, h, g, bm,
                               bn, bk, h, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(a, b, d, f, out, batch, m, n, k, h, g,
                                       bm, bn, bk, h, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
