// Online-softmax GQA attention for Hopper (sm_90a), in two entries
// over one kv loop:
//
// * `attn_partial_launch` replaces the Pallas TPU kernel
//   `_attn_partial_kernel` behind `fused_attention_partial`
//   (src/repro/kernels/attention.py:160).  It returns the raw combine
//   state (o_unnorm, m_run, l_run) with masks from GLOBAL positions,
//   and rows masked across the whole shard emit the merge identity
//   (0, NEG_INF, 0).
// * `attn_launch` replaces `_attn_kernel` behind `fused_attention`
//   (src/repro/kernels/attention.py:255): query rows sit at the tail of
//   the kv sequence (row r at position N - M + r, kv slot j at j), the
//   epilogue divides by l (l == 0 -> 1) and writes q's type, and rows
//   with no key at all are NOT zeroed: like the Pallas body they
//   accumulate exp(NEG_INF - NEG_INF) = 1 per key, so their output is
//   the mean of v.  Under a causal or window mask the block skips kv
//   tiles masked for every row of its q tile, but only when every row
//   of the tile sees some key: after a row's first live tile such a
//   tile adds exp(NEG_INF - m) = 0 with rescale 1, and before it its
//   sums are rescaled by exp(NEG_INF - m) = 0, so skipping is exact.
//
// Both run the same recurrence: S = q k^T * scale in f32, masked with
// NEG_INF, running max and sum in f32, P rounded to v's type before
// P V.
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
// per kv byte, so it is bound by the kv bytes it reads at 3.35 TB/s;
// over a whole causal sequence (the cache-free forward, M = N = 2048,
// D = 128) it does ~800 flops per byte and is bound by the bf16
// tensor-core rate, which this CUDA-core design does not approach.
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
// threads per block: 128 for the partial entry (decode, one query row
// per request); 512 for the normalised entry, whose long q tiles hold
// one block per SM in shared memory, so that 16 warps (not 4) hide the
// latency of the score loop's loads and shuffles
template <bool FINAL>
constexpr int kThreads = FINAL ? 512 : 128;

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

// FINAL = false: the partial entry (positions from kv_pos / q_pos, raw
// state out); FINAL = true: the normalised entry (tail positions,
// o / l in T out, m_out / l_out unused, the position arrays null).
template <typename T, bool FINAL>
__global__ void __launch_bounds__(kThreads<FINAL>) attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_pos,
    const int* __restrict__ q_pos, void* __restrict__ o_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int hq, int hkv,
    int m, int n, int d, int dv, int bq, int bkv, int kv_pos_bstride,
    int q_pos_bstride, int masked, int window, float scale) {
  const int row0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  constexpr int nt = kThreads<FINAL>;
  constexpr int n_warps = nt / 32;
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
  const int* rows =
      FINAL ? nullptr : q_pos + static_cast<size_t>(b) * q_pos_bstride + row0;
  const int* cols =
      FINAL ? nullptr : kv_pos + static_cast<size_t>(b) * kv_pos_bstride;
  const int tail = n - m + row0;  // FINAL: position of this tile's row 0

  // kv tiles to walk; FINAL skips those masked for every row of the q
  // tile when every row sees a key (see the header: exact)
  int j_begin = 0, j_end = n;
  if (FINAL && masked && tail >= 0) {
    j_end = min(n, ((tail + bq - 1) / bkv + 1) * bkv);
    if (window > 0) j_begin = max(0, tail - window + 1) / bkv * bkv;
  }

  stage(s_q, q + row_base * d, bq * d);
  for (int e = threadIdx.x; e < bq * dv; e += nt) s_o[e] = 0.f;
  for (int i = threadIdx.x; i < bq; i += nt) {
    s_m[i] = kNegInf;
    s_l[i] = 0.f;
  }

  for (int j0 = j_begin; j0 < j_end; j0 += bkv) {
    __syncthreads();  // the previous tile is no longer read
    stage(s_k, k + (kv_base + j0) * d, bkv * d);
    stage(s_v, v + (kv_base + j0) * dv, bkv * dv);
    __syncthreads();

    // scores: one warp per (row, key), lanes split the head dim
    for (int p = warp; p < bq * bkv; p += n_warps) {
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
          const int col = FINAL ? j0 + j : cols[j0 + j];
          const int row = FINAL ? tail + i : rows[i];
          bool keep = col <= row;
          if (window > 0) keep = keep && col > row - window;
          if (!keep) s = kNegInf;
        }
        s_s[i * bkv + j] = s;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int i = warp; i < bq; i += n_warps) {
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
    for (int e = threadIdx.x; e < bq * dv; e += nt) {
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

  if (FINAL) {
    // o / l in q's type; a row with no key keeps the mean of v
    T* out = static_cast<T*>(o_out);
    for (int e = threadIdx.x; e < bq * dv; e += nt) {
      const float l = s_l[e / dv];
      out[row_base * dv + e] = from_f32<T>(s_o[e] / (l == 0.f ? 1.f : l));
    }
    return;
  }
  // rows masked across the whole shard accumulated exp(0) = 1 per key:
  // emit the merge identity (0, NEG_INF, 0) for them instead
  float* out = static_cast<float*>(o_out);
  for (int e = threadIdx.x; e < bq * dv; e += nt) {
    const bool dead = s_m[e / dv] <= kNegInf * 0.5f;
    out[row_base * dv + e] = dead ? 0.f : s_o[e];
  }
  for (int i = threadIdx.x; i < bq; i += nt) {
    const bool dead = s_m[i] <= kNegInf * 0.5f;
    m_out[row_base + i] = s_m[i];
    l_out[row_base + i] = dead ? 0.f : s_l[i];
  }
}

template <typename T, bool FINAL>
int launch(const void* q, const void* k, const void* v, const int* kv_pos,
           const int* q_pos, void* o, float* m_run, float* l_run, int batch,
           int hq, int hkv, int m, int n, int d, int dv, int bq, int bkv,
           int kv_pos_bstride, int q_pos_bstride, int masked, int window,
           float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, FINAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m / bq, hq, batch);
  attn_kernel<T, FINAL><<<grid, kThreads<FINAL>, smem, stream>>>(
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
    return launch<float, false>(q, k, v, kv_pos, q_pos, o, m_run, l_run,
                                batch, hq, hkv, m, n, d, dv, bq, bkv,
                                kv_pos_bstride, q_pos_bstride, masked,
                                window, scale, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, kv_pos, q_pos, o, m_run,
                                        l_run, batch, hq, hkv, m, n, d, dv,
                                        bq, bkv, kv_pos_bstride,
                                        q_pos_bstride, masked, window,
                                        scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The normalised attention O = softmax(q k^T * scale + mask) V with the
// query rows at the tail of the kv sequence; o in q's type.  dtype: 0 =
// float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch
// (0 on success); the caller validated every shape and tile.
int attn_launch(int dtype, const void* q, const void* k, const void* v,
                void* o, int batch, int hq, int hkv, int m, int n, int d,
                int dv, int bq, int bkv, int masked, int window, float scale,
                long long smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (dtype == 0)
    return launch<float, true>(q, k, v, nullptr, nullptr, o, nullptr,
                               nullptr, batch, hq, hkv, m, n, d, dv, bq,
                               bkv, 0, 0, masked, window, scale, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, k, v, nullptr, nullptr, o,
                                       nullptr, nullptr, batch, hq, hkv, m,
                                       n, d, dv, bq, bkv, 0, 0, masked,
                                       window, scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
