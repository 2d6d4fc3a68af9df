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
// Bound.  The paper's chains are bound by operations at the bf16
// tensor-core rate: G12 (B = 8, M = N = 1024, K = H = 128) does 4.3
// GFLOP on 6.3 MB of I/O, 4.3 us at 989 TFLOP/s against 1.9 us of
// bytes; its unfused form (two cuBLAS products) spends 0.015 ms.
//
// Design.  The two-GEMM chain is the MLP kernel's machine
// (chain_mma.cuh, designed at the head of mlp_chain.cu) in its
// ungated case with the identity activation: C is the hidden tile, D
// the down-projection.
// * bf16: `mlp_mma_kernel` on the split grid (m tiles, E tiles, n splits
//   x batch) — the flat class one E tile of all of H, the deep class
//   H / bh of them, each recomputing C — with C and E on `mma.sync`
//   through `ldmatrix`, a `cp.async` ring staging A, B and D, C rounded
//   to bf16 in shared memory, and the splits' f32 partial E summed in
//   split order by `mlp_merge_kernel` (two runs of one call are bitwise
//   equal).  The split count is `perf_model.mlp_splits`, ungated, the
//   rule the tuner prices.
// * f32: `mlp_f32_kernel` on the same split grid, on CUDA cores: f32
//   parity allows no TF32.
// * The three-GEMM chain in bf16 (`chain3_mma_kernel`): one block a (m
//   tile, batch), no split, since E must be whole before it is rounded
//   to F's type.  The machine's up phase computes C of all of N into
//   shared memory, its down phase E chunk by chunk in registers over all
//   of n, rounded to bf16 into an on-chip (bm, H) E row, and a second
//   down phase G = E F with F through the same ring, written once.
// * The three-GEMM chain in f32 (`chain3_f32_kernel`), on CUDA cores:
//   per (n, k) step the A and B tiles staged with 16-byte loads, a
//   thread owns a column of C for 8 rows, D (and then F) streamed per
//   thread from device memory, the f32 E row in shared memory.
// Shared memory is exactly `mlp_smem_bytes` (two-GEMM) and
// `gemm_chain3_smem_bytes` (three-GEMM) in core/perf_model.py, and the
// bf16 tile rule `mlp_tiles_ok`; Rule 4 of the tuner and the Python
// wrappers check them.
//
// The stitching hooks of the JAX kernels (`prologue` on the A tile at
// load, `epilogue` on the finished output tile before the store) are the
// machine's (chain_mma.cuh); in the three-GEMM chain the epilogue runs
// on G, the chain's output, as `gemm_chain3._kernel` applies it.
//
// The ring of both chains gives up stages, down to two, where the full
// ring would not fit beside what the block holds (perf_model.mlp_ring's
// `held`), so the parent's tiles, such as 128/128/128 at K = 128, run.
//
// What this leaves: what the MLP kernel leaves (`wgmma`, TMA, warp
// specialisation, a fixed cost of each ring step that the tuner does not
// price: it only breaks ties by steps); and the up phase's 16-column
// groups a warp, of which an n tile narrower than 128 columns keeps only
// some warps busy.

#include "chain_mma.cuh"

namespace {

// acc (rows, ldacc) f32 in shared memory += X (rows, kd) f32 in shared
// memory times the (kd, cols) block of W at w + j * ldw + c in device
// memory: a thread owns one accumulator column, kRows rows per pass,
// kInFlight rows of W loaded before they are used.
__device__ void accumulate_from_global(float* __restrict__ acc, int ldacc,
                                       const float* __restrict__ x, int kd,
                                       const float* __restrict__ w,
                                       long long ldw, int rows, int cols) {
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float* wcol = w + c;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = 0.f;
      for (int j0 = 0; j0 < kd; j0 += kInFlight) {
        float wv[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q)
          wv[q] = j0 + q < kd ? wcol[(j0 + q) * ldw] : 0.f;
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

// G = ((A B) D) F in f32 on CUDA cores, one block a (m tile, batch)
template <bool HOOKED>
__global__ void __launch_bounds__(kThreads) chain3_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ d, const float* __restrict__ f,
    float* __restrict__ out, int m, int n, int k, int h, int g, int bm,
    int bn, int bk, Hook pro, Hook epi) {
  const int row0 = blockIdx.x * bm;
  const int bz = blockIdx.y;
  const int chunks = (bm + kRows - 1) / kRows;

  // layout == gemm_chain3_smem_bytes(bm, bn, bk, n, h, 4)
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_c = reinterpret_cast<float*>(smem);
  float* s_e = s_c + bm * bn;
  float* s_a = s_e + bm * h;
  float* s_b = s_a + bm * bk;

  const float* a_b = a + (static_cast<size_t>(bz) * m + row0) * k;
  const float* b_b = b + static_cast<size_t>(bz) * k * n;
  const float* d_b = d + static_cast<size_t>(bz) * n * h;

  for (int i = threadIdx.x; i < bm * h; i += kThreads) s_e[i] = 0.f;

  for (int n0 = 0; n0 < n; n0 += bn) {
    for (int i = threadIdx.x; i < bm * bn; i += kThreads) s_c[i] = 0.f;
    for (int k0 = 0; k0 < k; k0 += bk) {
      __syncthreads();  // the previous tiles are no longer read
      stage_tile(s_a, a_b + k0, bm, bk, k, bm, bk);
      stage_tile(s_b, b_b + static_cast<size_t>(k0) * n + n0, bk, bn, n, bk,
                 bn);
      __syncthreads();
      if constexpr (HOOKED) {
        if (pro.n) {  // the prologue on the staged A tile
          hook_tile(&pro, s_a, bk, bm, bk);
          __syncthreads();
        }
      }

      // C (+)= A B: a thread owns column j, kRows rows
      for (int p = threadIdx.x; p < bn * chunks; p += kThreads) {
        const int j = p % bn;
        const int r0 = (p / bn) * kRows;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        for (int kk = 0; kk < bk; ++kk) {
          const float w = s_b[kk * bn + j];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r0 + r < bm) acc[r] = fmaf(s_a[(r0 + r) * bk + kk], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < bm) s_c[(r0 + r) * bn + j] += acc[r];
      }
    }
    __syncthreads();
    accumulate_from_global(s_e, h, s_c, bn,
                           d_b + static_cast<size_t>(n0) * h, h, bm, h);
    __syncthreads();  // C is no longer read; E is complete so far
  }

  // G = E F; the (bm, G) result accumulates in the C buffer's place,
  // column block by column block of bn
  const float* f_b = f + static_cast<size_t>(bz) * h * g;
  for (int g0 = 0; g0 < g; g0 += bn) {
    const int gc = min(bn, g - g0);
    __syncthreads();  // the previous block stored
    for (int i = threadIdx.x; i < bm * gc; i += kThreads) s_c[i] = 0.f;
    __syncthreads();
    accumulate_from_global(s_c, gc, s_e, h, f_b + g0, g, bm, gc);
    __syncthreads();
    for (int i = threadIdx.x; i < bm * gc; i += kThreads) {
      const int r = i / gc;
      const int c = i - r * gc;
      float v = s_c[i];
      if constexpr (HOOKED) v = apply_hook(epi, v);
      out[(static_cast<size_t>(bz) * m + row0 + r) * g + g0 + c] = v;
    }
  }
}

// G = ((A B) D) F in bf16 on tensor cores, one block a (m tile, batch):
// C of all of N, then the whole E row, then G.
template <int MB, int NB, bool HOOKED>
__global__ void __launch_bounds__(kThreads, 1) chain3_mma_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    const bf16* __restrict__ d, const bf16* __restrict__ f,
    bf16* __restrict__ out, int m, int n, int k, int h, int g, int bm,
    int bn, int bk, int stages, int dr, Hook pro, Hook epi) {
  const int batch = gridDim.y;
  const int bz = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, m - row0);  // valid rows of this block
  const MmaGeom G(bm, bn, bk, 1, dr);
  const int ldh = (n + bn - 1) / bn * G.bnp + kPad;
  const int hp = ceil16(h), lde = hp + kPad;

  // layout == gemm_chain3_smem_bytes(bm, bn, bk, n, h, 2): the ring of
  // mlp_ring(bm, bn, bk, false), C of all of N (bmp, n blocks x bnp),
  // then the E row (bmp, ceil16(H))
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* hid = ring + stages * G.stage;
  bf16* erow = hid + G.bmp * ldh;

  const bf16* b_b = b + static_cast<size_t>(bz) * k * n;
  mma_up<false, MB, NB, HOOKED>(G, ring, stages, hid, ldh,
                        a + (static_cast<size_t>(bz) * m + row0) * k, b_b,
                        b_b, rows, n, k, bn, bk, 0, n, kIdentity, pro);
  __syncthreads();  // all of C written; the ring is free
  // E rounded to F's type; its columns past H (zero) fill the row to hp
  mma_down<MB>(G, ring, stages, dr, hid, ldh,
               d + static_cast<size_t>(bz) * n * h, h, n, 0, h,
               [&](int row, int col, float v0, float v1) {
                 if (col < hp)
                   *reinterpret_cast<uint32_t*>(erow + row * lde + col) =
                       pack_bf16(v0, v1);
               });
  __syncthreads();  // the E row is whole; the ring is free
  mma_down<MB>(G, ring, stages, dr, erow, lde,
               f + static_cast<size_t>(bz) * h * g, g, h, 0, g,
               [&](int row, int col, float v0, float v1) {
                 if (row >= rows) return;
                 if constexpr (HOOKED) {
                   v0 = apply_hook(epi, v0);
                   v1 = apply_hook(epi, v1);
                 }
                 store_e2(out, nullptr, 0, 1, bz, batch, m, g, row0 + row,
                          col, g, v0, v1);
               });
}

}  // namespace

extern "C" {

// E = (A B) D on the MLP machine.  dtype: 0 = float32, 1 = bfloat16;
// be: the E tile width (bh for the deep class, H for the flat class);
// the n axis in `splits` runs of `per` bn blocks, whose f32 partial E
// go to `part` (splits, B, M, H) and are merged into e (part unused
// with one split); stages, dr: the bf16 ring, perf_model.mlp_ring with
// the hidden tile of one n block held (unused in f32); pro, epi: the
// prologue on A and the epilogue on E (n = 0: none).  Returns
// cudaGetLastError() after the launches (0 on success); the caller
// validated every shape, tile, the split and the shared-memory size.
int gemm_chain_launch(int dtype, const void* a, const void* b,
                      const void* d, void* e, void* part, int batch, int m,
                      int n, int k, int h, int bm, int bn, int bk, int be,
                      int splits, int per, int stages, int dr,
                      long long smem_bytes, void* stream, Hook pro,
                      Hook epi) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (machine_args_bad(batch, h, be, splits, per, stages, dr, part))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch<float, float, false>(a, b, b, d, e, p, batch, m, n, k, h,
                                       bm, bn, bk, be, splits, per, stages,
                                       dr, kIdentity, smem, s, pro, epi);
  if (dtype == 1)
    return launch<bf16, bf16, false>(a, b, b, d, e, p, batch, m, n, k, h, bm,
                                     bn, bk, be, splits, per, stages, dr,
                                     kIdentity, smem, s, pro, epi);
  return static_cast<int>(cudaErrorInvalidValue);
}

// G = ((A B) D) F, the flat class (the whole E row on chip).  stages,
// dr: the bf16 ring, perf_model.gemm_chain3_ring (unused in f32); the
// epilogue runs on G.  Same conventions as gemm_chain_launch.
int gemm_chain3_launch(int dtype, const void* a, const void* b,
                       const void* d, const void* f, void* out, int batch,
                       int m, int n, int k, int h, int g, int bm, int bn,
                       int bk, int stages, int dr, long long smem_bytes,
                       void* stream, Hook pro, Hook epi) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(smem_bytes);
  if (batch > 65535 || stages < 2 || stages > kMaxStages || dr < 16 ||
      dr % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + bm - 1) / bm, batch);
  const bool hooked = pro.n || epi.n;
  if (dtype == 0) {
    auto kernel = hooked ? chain3_f32_kernel<true> : chain3_f32_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(d), static_cast<const float*>(f),
        static_cast<float*>(out), m, n, k, h, g, bm, bn, bk, pro, epi);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = with_bucket(bm, bn, [&](auto mb, auto nb) {
    constexpr int MB = decltype(mb)::value, NB = decltype(nb)::value;
    auto kernel = hooked ? chain3_mma_kernel<MB, NB, true>
                         : chain3_mma_kernel<MB, NB, false>;
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<const bf16*>(d), static_cast<const bf16*>(f),
        static_cast<bf16*>(out), m, n, k, h, g, bm, bn, bk, stages, dr, pro,
        epi);
    return 0;
  });
  return err ? err : static_cast<int>(cudaGetLastError());
}

const char* chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
