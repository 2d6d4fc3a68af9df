// One kv shard's online-softmax GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_partial_kernel` behind
// `fused_attention_partial` (src/repro/kernels/attention.py).  It
// computes the same raw combine state (o_unnorm, m_run, l_run) with the
// same recurrence: S = q k^T * scale in f32, masked from GLOBAL
// positions with NEG_INF, running max and sum in f32, P rounded to v's
// type before P V, and rows masked across the whole shard emitting the
// merge identity (0, NEG_INF, 0).
//
// Design: one thread block per (batch, q-head, q-tile).  The kv head is
// h / group.  The block walks the kv axis in tiles of `bkv` inside one
// loop (the sequential grid axis of the TPU kernel), staging the q, k
// and v tiles in shared memory with 16-byte loads; a warp computes one
// score at a time (lanes split the head dim), a warp updates one row's
// softmax statistics, and each thread owns output columns of P V.
// The shared-memory layout is exactly `attention_smem_bytes` in
// core/perf_model.py, which Rule 4 of the tuner and the Python wrapper
// both check, so no tuned tile can exceed the 227 KB a block may use.
//
// Bound: at decode (one query row per request) the kernel does ~2 flops
// per kv byte, so it is bound by the kv bytes it reads at 3.35 TB/s.
// What this simple design leaves on the table: each of the `group`
// q-heads sharing a kv head re-reads the same kv tile (4x the necessary
// traffic for qwen3-8b, mostly caught by L2); no tensor cores (wgmma);
// no asynchronous copies (cp.async / TMA), so loads and math do not
// overlap; one block per (request, head) leaves SMs idle at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernel, bit for bit
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Copy `n` contiguous elements from global to shared memory, 16 bytes a
// thread-step when both ends are 16-byte aligned.
template <typename T>
__device__ void stage(T* dst, const T* src, int n) {
  const int bytes = n * static_cast<int>(sizeof(T));
  if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_pos,
    const int* __restrict__ q_pos, float* __restrict__ o_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int hq, int hkv,
    int m, int n, int d, int dv, int bq, int bkv, int kv_pos_bstride,
    int q_pos_bstride, int masked, int window, float scale) {
  const int row0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // layout == attention_smem_bytes(bq, bkv, d, dv, sizeof(T))
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + bq * d;
  T* s_v = s_k + bkv * d;
  float* s_s = reinterpret_cast<float*>(s_v + bkv * dv);
  float* s_o = s_s + bq * bkv;
  float* s_m = s_o + bq * dv;
  float* s_l = s_m + bq;
  float* s_c = s_l + bq;

  const size_t row_base = (static_cast<size_t>(b) * hq + h) * m + row0;
  const size_t kv_base = (static_cast<size_t>(b) * hkv + hk) * n;
  const int* rows = q_pos + static_cast<size_t>(b) * q_pos_bstride + row0;
  const int* cols = kv_pos + static_cast<size_t>(b) * kv_pos_bstride;

  stage(s_q, q + row_base * d, bq * d);
  for (int e = threadIdx.x; e < bq * dv; e += kThreads) s_o[e] = 0.f;
  for (int i = threadIdx.x; i < bq; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.f;
  }

  for (int j0 = 0; j0 < n; j0 += bkv) {
    __syncthreads();  // the previous tile is no longer read
    stage(s_k, k + (kv_base + j0) * d, bkv * d);
    stage(s_v, v + (kv_base + j0) * dv, bkv * dv);
    __syncthreads();

    // scores: one warp per (row, key), lanes split the head dim
    for (int p = warp; p < bq * bkv; p += kWarps) {
      const int i = p / bkv;
      const int j = p % bkv;
      const T* qr = s_q + i * d;
      const T* kr = s_k + j * d;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32)
        acc = fmaf(to_f32(qr[c]), to_f32(kr[c]), acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        float s = acc * scale;
        if (masked) {
          const int col = cols[j0 + j];
          const int row = rows[i];
          bool keep = col <= row;
          if (window > 0) keep = keep && col > row - window;
          if (!keep) s = kNegInf;
        }
        s_s[i * bkv + j] = s;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int i = warp; i < bq; i += kWarps) {
      float* sr = s_s + i * bkv;
      float mx = kNegInf;
      for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_prev = s_m[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bkv; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        s_c[i] = corr;
        s_l[i] = s_l[i] * corr + sum;
        s_m[i] = m_new;
      }
    }
    __syncthreads();

    // o = o * corr + P V, P rounded to v's type first
    for (int e = threadIdx.x; e < bq * dv; e += kThreads) {
      const int i = e / dv;
      const int c = e % dv;
      const float* pr = s_s + i * bkv;
      float acc = 0.f;
      for (int j = 0; j < bkv; ++j)
        acc = fmaf(to_f32(from_f32<T>(pr[j])), to_f32(s_v[j * dv + c]), acc);
      s_o[e] = s_o[e] * s_c[i] + acc;
    }
  }
  __syncthreads();

  // rows masked across the whole shard accumulated exp(0) = 1 per key:
  // emit the merge identity (0, NEG_INF, 0) for them instead
  for (int e = threadIdx.x; e < bq * dv; e += kThreads) {
    const bool dead = s_m[e / dv] <= kNegInf * 0.5f;
    o_out[row_base * dv + e] = dead ? 0.f : s_o[e];
  }
  for (int i = threadIdx.x; i < bq; i += kThreads) {
    const bool dead = s_m[i] <= kNegInf * 0.5f;
    m_out[row_base + i] = s_m[i];
    l_out[row_base + i] = dead ? 0.f : s_l[i];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_pos,
           const int* q_pos, float* o, float* m_run, float* l_run, int batch,
           int hq, int hkv, int m, int n, int d, int dv, int bq, int bkv,
           int kv_pos_bstride, int q_pos_bstride, int masked, int window,
           float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m / bq, hq, batch);
  attn_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_pos, q_pos, o, m_run, l_run, hq, hkv, m,
      n, d, dv, bq, bkv, kv_pos_bstride, q_pos_bstride, masked, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 on success); the caller validated every shape.
int attn_partial_launch(int dtype, const void* q, const void* k,
                        const void* v, const int* kv_pos, const int* q_pos,
                        float* o, float* m_run, float* l_run, int batch,
                        int hq, int hkv, int m, int n, int d, int dv, int bq,
                        int bkv, int kv_pos_bstride, int q_pos_bstride,
                        int masked, int window, float scale,
                        long long smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (dtype == 0)
    return launch<float>(q, k, v, kv_pos, q_pos, o, m_run, l_run, batch, hq,
                         hkv, m, n, d, dv, bq, bkv, kv_pos_bstride,
                         q_pos_bstride, masked, window, scale, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kv_pos, q_pos, o, m_run, l_run,
                                 batch, hq, hkv, m, n, d, dv, bq, bkv,
                                 kv_pos_bstride, q_pos_bstride, masked,
                                 window, scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
