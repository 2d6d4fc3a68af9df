// Online-softmax GQA attention for Hopper (sm_90a), in two entries.
//
// * `attn_launch` replaces `_attn_kernel` behind `fused_attention`
//   (src/repro/kernels/attention.py:255): the normalised attention with
//   the query rows at the tail of the kv sequence (row r at position
//   N - M + r, kv slot j at j); the epilogue divides by l (l == 0 -> 1)
//   and writes q's type.  Rows with no key at all are NOT zeroed: like
//   the Pallas body they accumulate exp(NEG_INF - NEG_INF) = 1 per key,
//   so their output is the mean of v.
//   Bound: over a whole causal sequence (the cache-free forward, M = N =
//   2048, D = 128) the work is ~800 flops per byte, so the bf16
//   tensor-core rate bounds it.  Design (bf16, `attn_mma_kernel`): a
//   flash-attention forward on `mma.sync.m16n8k16` (bf16 in, f32
//   accumulate).  One block per (q-head, q tile, batch) with
//   ceil(bq / 16) warps; each warp owns 16 query rows (padded rows are
//   zero and never stored).  S = Q K^T comes from `ldmatrix` fragments;
//   the softmax statistics stay in registers, reduced over the 4 threads
//   of a quad; P is rounded to bf16 in registers and is directly the A
//   operand of the P V product, whose V fragments come from
//   `ldmatrix.trans`.  O, m and l stay in registers until the epilogue.
//   K and V arrive through 16-byte `cp.async` into a 2-stage ring whose
//   stages hold at least 64 keys (several small kv tiles side by side:
//   one barrier, one copy wait and one load of the Q fragments per
//   stage, S for the whole stage at once, then the softmax tile after
//   tile), rows padded by 16 bytes so that `ldmatrix` is free of bank
//   conflicts.  A kv tile that is no multiple of 16 keys (the whole of
//   an N such as 100, or a tile the clamp shrank to divide N) lies in
//   shared memory padded with zero rows to whole 16-key chunks; the
//   padding keys score -inf and weigh exactly 0, even in a row whose
//   real keys are all masked.  O is rescaled only when some row's max
//   moved.  The masks run only on tiles that cross the diagonal or the
//   window edge of a warp's rows.  The grid puts the q-heads fastest,
//   so the heads of one GQA group run side by side and share each kv
//   tile through L2 (a block per group would multiply the registers a
//   block needs by the group size); the late, long q tiles of a causal
//   mask launch first.  The f32 entry keeps a CUDA-core
//   loop (`attn_f32_kernel`): TF32 tensor cores would break the f32
//   tolerance, and f32 is only the front door's Table III path.
//   The JAX kernel's stitching hooks (hook.cuh) run in both: the q
//   prologue once on the q tile in shared memory after its load (its
//   fragments are re-read for every kv stage, so hooking them would
//   repeat the work), the k prologue on each stage's keys after they
//   land and never on v, both before the `* scale` and rounded to the
//   tile's type; the o epilogue on o / l, rows with no key included,
//   before the store.  Both kernels run them only in their HOOKED
//   instantiations, which the launch picks when a hook has steps.
// * `attn_partial_launch` replaces the Pallas TPU kernel
//   `_attn_partial_kernel` behind `fused_attention_partial`
//   (src/repro/kernels/attention.py:160).  It returns the raw combine
//   state (o_unnorm, m_run, l_run) with masks from GLOBAL positions, and
//   rows masked across the whole shard emit the merge identity
//   (0, NEG_INF, 0).
//   Bound: at decode (one query row per request) it does ~2 flops per
//   kv byte, so the kv bytes at 3.35 TB/s bound it.  Design
//   (`attn_partial_kernel`, CUDA cores): one block per (kv split, kv
//   head x q tile, request) holds all `group * bq` rows of the GQA
//   group, so each kv tile is read once for the group; the kv axis is
//   split across blocks (the wrapper picks the split count from the
//   SMs, how many blocks each holds and the shape), each split a run of
//   whole kv tiles streamed through a 2-stage `cp.async` ring whose
//   stages hold at least 128 bf16 keys; a thread scores one key for all
//   rows.  With more than one split each block writes its raw state to
//   scratch and `attn_merge_kernel` combines the splits with the
//   log-sum-exp rule before it zeroes dead rows; a split in which a row
//   is wholly masked holds (sum v, NEG_INF, count) and weighs
//   exp(NEG_INF - m) = 0 against any live split.
// * `attn_partial_paged_launch` runs the same kernel (its PAGED
//   instantiation) behind `fused_attention_paged` on the page pool in
//   place, for the Pallas paged kernel
//   (src/repro/kernels/attention.py `fused_attention_paged`, which
//   gathers each chunk of the page table first).  Bound: the live keys'
//   bytes, as above.  Each block reads its request's length and walks
//   the page table itself, loading only the pages that hold keys its
//   rows may see (from the window's first page to the length's last),
//   each key's 16-byte pieces by `cp.async` from the page where it lies;
//   the splits share each request's live tiles equally, so the host's
//   split count depends on no length and a captured launch stays valid
//   from step to step.  An empty slot walks nothing and its rows leave
//   the merge identity.  Nothing is gathered or copied first.
//
// Both entries run the recurrence of the TPU kernels over kv tiles of
// `bkv`: S = q k^T * scale in f32, masked with NEG_INF, running max and
// sum in f32, P rounded to v's type before P V.  The normalised entry
// skips kv tiles masked for every row of a q tile (or of a warp's 16
// rows) only when every row of the tile sees some key: after a row's
// first live tile such a tile adds exp(NEG_INF - m) = 0 with rescale 1,
// and before it its sums are rescaled by exp(NEG_INF - m) = 0, so
// skipping is exact.
//
// Shared memory is exactly `attention_smem_bytes` (normalised entry)
// and `attention_partial_smem_bytes` (partial entry) in
// core/perf_model.py, which Rule 4 of the tuner and the Python wrapper
// both check; the tile rule of the tensor-core kernel
// (`attention_tiles_ok`) is checked the same way.
//
// What this design still leaves: `wgmma` (the warpgroup product is the
// only way to the full tensor-core rate), TMA copies and warp
// specialisation (a producer warp keeping loads in flight), and the
// tuner pricing the kv split and the cost of a small kv tile (it prices
// the unsplit kernel, the split is the wrapper's, and its picks of
// 16-key tiles run slower than larger ones).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hook.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernel, bit for bit
// INVALID_POS of the wrapper: a key at this position fails every
// causal mask
constexpr int kInvalidPos = 1 << 30;
// the score of a padding key of a ragged kv tile: -inf, so that its weight
// exp(-inf - m) is exactly 0 even where every real key is masked
__device__ __forceinline__ float pad_score() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------
// normalised entry, bf16: the tensor-core kernel
// ---------------------------------------------------------------------

constexpr int kMmaRows = 16;     // query rows per warp
constexpr int kMmaMaxWarps = 8;  // bq <= 128
constexpr int kPad = 8;          // bf16 elements (16 B) after each smem row
// a stage of the kv ring holds max(1, kMmaStageKeys / bkv) kv tiles, so
// that small tiles do not pay a barrier and a copy wait each
constexpr int kMmaStageKeys = 64;

// DVB / BKVB: the largest dv and the most keys of a stage this
// instantiation holds in registers (the O accumulator, dv / 2 floats a
// thread, and the stage's scores, keys / 2); loops over them are
// unrolled and guarded by the real dv and stage, so the register arrays
// keep constant indices.  (Keeping the warp's Q fragments in registers
// too, and __expf for expf, each measured slower on the card.)  RAGGED:
// bkv is no multiple of 16; the other instantiations carry none of its
// padding arithmetic.
template <int DVB, int BKVB, bool RAGGED, bool HOOKED>
__global__ void __launch_bounds__(kMmaMaxWarps * 32) attn_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int hq, int hkv,
    int m, int n, int d, int dv, int bq, int bkv, int masked, int window,
    float scale, Hook qpro, Hook kpro, Hook oepi) {
  const int h = blockIdx.x;                    // q-heads of a group adjacent
  const int qt = gridDim.y - 1 - blockIdx.y;   // late q tiles first
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row of the fragment (and row + 8)
  const int tig = lane & 3;  // column pair of the fragment
  const int nt = blockDim.x;
  const int rows = (nt >> 5) * kMmaRows;  // bq rounded up to 16
  const int ldq = d + kPad;
  const int ldv = dv + kPad;
  // a kv tile lies in shared memory padded to whole 16-key chunks: its
  // padding rows are zero and their scores -inf, so they add exactly 0
  const int bkvp = RAGGED ? (bkv + 15) / 16 * 16 : bkv;
  const int st = max(1, kMmaStageKeys / bkvp);  // kv tiles a stage
  const int sk = st * bkvp;                     // shared-memory rows a stage

  // layout == attention_smem_bytes(bq, bkv, d, dv, 2)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + rows * ldq;        // 2 stages of sk x ldq
  bf16* s_v = s_k + 2 * sk * ldq;      // 2 stages of sk x ldv

  const int row0 = qt * bq;
  const size_t row_base = (static_cast<size_t>(b) * hq + h) * m + row0;
  const size_t kv_base = (static_cast<size_t>(b) * hkv + hk) * n;
  const int tail = n - m + row0;  // position of this tile's row 0

  // kv tiles to walk: skip those masked for every row of the q tile
  // when every row sees a key (see the header: exact)
  int j_begin = 0, j_end = n;
  const bool skips = masked && tail >= 0;
  if (skips) {
    j_end = min(n, ((tail + bq - 1) / bkv + 1) * bkv);
    if (window > 0) j_begin = max(0, tail - window + 1) / bkv * bkv;
  }
  const int n_tiles = (j_end - j_begin) / bkv;

  {  // q tile: padded rows are zero
    const int chunks = d / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += nt) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const bool valid = r < bq;
      cp_async16(s_q + r * ldq + c,
                 q + (row_base + (valid ? r : 0)) * d + c, valid);
    }
  }
  // `tiles` kv tiles from key j0 on into ring stage `stage`; shared row
  // r holds key r of the run, or with ragged tiles key x of tile u
  // (r = u * bkvp + x) and zeros where x >= bkv
  auto load_kv = [&](int j0, int tiles, int stage) {
    const bf16* kg = k + (kv_base + j0) * d;
    const bf16* vg = v + (kv_base + j0) * dv;
    bf16* ks = s_k + stage * sk * ldq;
    bf16* vs = s_v + stage * sk * ldv;
    const int kc = d / 8, vc = dv / 8;
    auto key = [&](int r, bool& valid) {
      if (!RAGGED) return r;
      const int u = r / bkvp, x = r - u * bkvp;
      valid = x < bkv;
      return u * bkv + (valid ? x : 0);
    };
    for (int i = threadIdx.x; i < tiles * bkvp * kc; i += nt) {
      bool valid = true;
      const int j = key(i / kc, valid);
      cp_async16(ks + (i / kc) * ldq + (i % kc) * 8,
                 kg + j * d + (i % kc) * 8, valid);
    }
    for (int i = threadIdx.x; i < tiles * bkvp * vc; i += nt) {
      bool valid = true;
      const int j = key(i / vc, valid);
      cp_async16(vs + (i / vc) * ldv + (i % vc) * 8,
                 vg + j * dv + (i % vc) * 8, valid);
    }
  };
  const int n_stages = (n_tiles + st - 1) / st;
  if (n_tiles > 0) load_kv(j_begin, min(st, n_tiles), 0);
  cp_async_commit();
  if constexpr (HOOKED) {
    if (qpro.n) {  // the q prologue, once on the q tile; the first
                   // stage's barrier orders it before any fragment read
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      hook_tile(&qpro, s_q, ldq, bq, d);
    }
  }

  float acc_o[DVB / 8][4];
#pragma unroll
  for (int t = 0; t < DVB / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[t][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int lo = tail + warp * kMmaRows;  // position of the warp's row 0
  const int hi = lo + kMmaRows - 1;
  const bf16* q_frag = s_q + (warp * kMmaRows + (lane & 15)) * ldq +
                       (lane >> 4) * 8;

  for (int it = 0; it < n_stages; ++it) {
    const int ns = min(st, n_tiles - it * st);  // kv tiles in this stage
    const int j_stage = j_begin + it * st * bkv;
    if (it + 1 < n_stages)
      load_kv(j_stage + st * bkv, min(st, n_tiles - (it + 1) * st),
              (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const bf16* ks = s_k + (it & 1) * sk * ldq;
    const bf16* vs = s_v + (it & 1) * sk * ldv;
    const int rows_s = ns * bkvp;  // shared-memory rows in this stage
    if constexpr (HOOKED) {
      if (kpro.n) {  // the k prologue on this stage's keys (padding keys
                     // score -inf whatever they hold)
        hook_tile(&kpro, s_k + (it & 1) * sk * ldq, ldq, rows_s, d);
        __syncthreads();
      }
    }

    // a kv tile masked for all 16 rows of this warp is skipped (exact,
    // as above); a tile live for all of them needs no mask
    auto dead = [&](int j0) {
      return skips &&
             (j0 > hi || (window > 0 && j0 + bkv - 1 <= lo - window));
    };
    // S = Q K^T over the whole stage (its kv tiles side by side, so the
    // Q fragments load once a stage): 16 rows x keys, 16 of the head
    // dim at a time; 16-row chunks of dead tiles are skipped
    float s[BKVB / 8][4];
#pragma unroll
    for (int t = 0; t < BKVB / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    bool live[BKVB / 16];
#pragma unroll
    for (int c = 0; c < BKVB / 16; ++c)
      live[c] = c * 16 < rows_s && !dead(j_stage + c * 16 / bkvp * bkv);
    const bf16* k_frag = ks + ((lane & 7) + ((lane >> 4) << 3)) * ldq +
                         ((lane >> 3) & 1) * 8;
    for (int kc = 0; kc < d; kc += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, q_frag + kc);
#pragma unroll
      for (int c = 0; c < BKVB / 16; ++c) {
        if (live[c]) {
          uint32_t bb[4];
          ldmatrix_x4(bb, k_frag + c * 16 * ldq + kc);
          mma_bf16(s[2 * c], a, bb[0], bb[1]);
          mma_bf16(s[2 * c + 1], a, bb[2], bb[3]);
        }
      }
    }

    // the online softmax and P V, one kv tile of the stage after the
    // other; a chunk t of 8 rows belongs to tile t * 8 / bkvp
    for (int u = 0; u < ns; ++u) {
      const int j0 = j_stage + u * bkv;
      if (dead(j0)) continue;
      const bool edge = masked && !(j0 + bkv - 1 <= lo &&
                                    (window <= 0 || j0 > hi - window));
      const int t_lo = u * bkvp / 8, t_hi = t_lo + bkvp / 8;
      // scale, mask, row max (this thread: rows g and g + 8)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int t = 0; t < BKVB / 8; ++t) {
        if (t >= t_lo && t < t_hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[t][e] * scale;
            if (edge || RAGGED) {
              // the key's position (its tile u starts at row u * bkvp)
              const int col =
                  j_stage + t * 8 + tig * 2 + (e & 1) + u * (bkv - bkvp);
              if (edge) {
                const int row = lo + g + (e >> 1) * 8;
                bool keep = col <= row;
                if (window > 0) keep = keep && col > row - window;
                if (!keep) x = kNegInf;
              }
              if (RAGGED && col - j0 >= bkv)
                x = pad_score();  // exp(-inf - m) = 0
            }
            s[t][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        corr[i] = expf(m_run[i] - m_new);
        m_run[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < BKVB / 8; ++t) {
        if (t >= t_lo && t < t_hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(s[t][e] - m_run[e >> 1]);
            s[t][e] = p;
            sum[e >> 1] += p;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l_run[i] = l_run[i] * corr[i] + sum[i];
      }
      // rescale O unless no row of the warp moved its max (x * 1 = x)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int t = 0; t < DVB / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_o[t][e] *= corr[e >> 1];
      }
      // O += P V: P (rounded to bf16) is the A operand as it lies in the
      // score registers, 16 keys at a time
#pragma unroll
      for (int c = 0; c < BKVB / 16; ++c) {
        if (2 * c >= t_lo && 2 * c < t_hi) {
          uint32_t a[4];
          a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
          a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
          a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
          a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
          const bf16* vrow =
              vs + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldv +
              (lane >> 4) * 8;
#pragma unroll
          for (int t = 0; t < DVB / 16; ++t) {
            if (t < dv / 16) {
              uint32_t bb[4];
              ldmatrix_x4_trans(bb, vrow + t * 16);
              mma_bf16(acc_o[2 * t], a, bb[0], bb[1]);
              mma_bf16(acc_o[2 * t + 1], a, bb[2], bb[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage is no longer read
  }

  // the o epilogue on o / l in f32, then bf16; a row with no key keeps
  // the mean of v
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * kMmaRows + g + i * 8;
    if (r >= bq) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    uint32_t* out =
        reinterpret_cast<uint32_t*>(o + (row_base + r) * dv + tig * 2);
#pragma unroll
    for (int t = 0; t < DVB / 8; ++t) {
      if (t < dv / 8) {
        float x0 = acc_o[t][2 * i] / l, x1 = acc_o[t][2 * i + 1] / l;
        if constexpr (HOOKED) {
          x0 = apply_hook(oepi, x0);
          x1 = apply_hook(oepi, x1);
        }
        out[t * 4] = pack_bf16(x0, x1);
      }
    }
  }
}

template <int DVB, int BKVB>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               int batch, int hq, int hkv, int m, int n, int d, int dv,
               int bq, int bkv, int masked, int window, float scale,
               size_t smem, cudaStream_t stream, const Hook& qpro,
               const Hook& kpro, const Hook& oepi) {
  const bool hooked = qpro.n || kpro.n || oepi.n;
  auto kernel =
      bkv % 16 ? (hooked ? attn_mma_kernel<DVB, BKVB, true, true>
                         : attn_mma_kernel<DVB, BKVB, true, false>)
               : (hooked ? attn_mma_kernel<DVB, BKVB, false, true>
                         : attn_mma_kernel<DVB, BKVB, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hq, m / bq, batch);
  const int threads = (bq + kMmaRows - 1) / kMmaRows * 32;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), hq, hkv, m, n, d,
      dv, bq, bkv, masked, window, scale, qpro, kpro, oepi);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// normalised entry, f32: the CUDA-core loop
// ---------------------------------------------------------------------

// 512 threads: long q tiles hold one block per SM in shared memory, so
// 16 warps hide the latency of the score loop's loads and shuffles
constexpr int kF32Threads = 512;

// Copy `n` contiguous elements from global to shared memory, 16 bytes a
// thread-step when both ends are 16-byte aligned.
__device__ void stage(float* dst, const float* src, int n) {
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

template <bool HOOKED>
__global__ void __launch_bounds__(kF32Threads) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int hq, int hkv,
    int m, int n, int d, int dv, int bq, int bkv, int masked, int window,
    float scale, Hook qpro, Hook kpro, Hook oepi) {
  const int row0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  constexpr int nt = kF32Threads;
  constexpr int n_warps = nt / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // layout == attention_smem_bytes(bq, bkv, d, dv, 4)
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_k = s_q + bq * d;
  float* s_v = s_k + bkv * d;
  float* s_s = s_v + bkv * dv;
  float* s_o = s_s + bq * bkv;
  float* s_m = s_o + bq * dv;
  float* s_l = s_m + bq;
  float* s_c = s_l + bq;

  const size_t row_base = (static_cast<size_t>(b) * hq + h) * m + row0;
  const size_t kv_base = (static_cast<size_t>(b) * hkv + hk) * n;
  const int tail = n - m + row0;  // position of this tile's row 0

  int j_begin = 0, j_end = n;
  if (masked && tail >= 0) {
    j_end = min(n, ((tail + bq - 1) / bkv + 1) * bkv);
    if (window > 0) j_begin = max(0, tail - window + 1) / bkv * bkv;
  }

  stage(s_q, q + row_base * d, bq * d);
  if constexpr (HOOKED) {
    if (qpro.n) {  // the q prologue, once; the kv loop's barrier follows
      __syncthreads();
      hook_tile(&qpro, s_q, d, bq, d);
    }
  }
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
    if constexpr (HOOKED) {
      if (kpro.n) {  // the k prologue on the tile's keys
        hook_tile(&kpro, s_k, d, bkv, d);
        __syncthreads();
      }
    }

    // scores: one warp per (row, key), lanes split the head dim
    for (int p = warp; p < bq * bkv; p += n_warps) {
      const int i = p / bkv;
      const int j = p % bkv;
      const float* qr = s_q + i * d;
      const float* kr = s_k + j * d;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32) acc = fmaf(qr[c], kr[c], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        float s = acc * scale;
        if (masked) {
          const int col = j0 + j;
          const int row = tail + i;
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

    // o = o * corr + P V
    for (int e = threadIdx.x; e < bq * dv; e += nt) {
      const int i = e / dv;
      const int c = e % dv;
      const float* pr = s_s + i * bkv;
      float acc = 0.f;
      for (int j = 0; j < bkv; ++j) acc = fmaf(pr[j], s_v[j * dv + c], acc);
      s_o[e] = s_o[e] * s_c[i] + acc;
    }
  }
  __syncthreads();

  // the o epilogue on o / l; a row with no key keeps the mean of v
  for (int e = threadIdx.x; e < bq * dv; e += nt) {
    const float l = s_l[e / dv];
    float x = s_o[e] / (l == 0.f ? 1.f : l);
    if constexpr (HOOKED) x = apply_hook(oepi, x);
    o[row_base * dv + e] = x;
  }
}

// ---------------------------------------------------------------------
// partial entry: GQA-grouped, split over kv
// ---------------------------------------------------------------------

constexpr int kPartialThreads = 256;
constexpr int kRowChunk = 4;  // rows a thread scores per pass over a key
// a stage of the kv ring holds max(1, kPartialStageKeys / bkv) kv
// tiles of bf16 (half as many keys of f32), so that small tiles still
// give every thread a key to score
constexpr int kPartialStageKeys = 128;

template <typename T>
__device__ __forceinline__ void load8(float (&f)[8], const T* p);
template <>
__device__ __forceinline__ void load8<bf16>(float (&f)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
template <>
__device__ __forceinline__ void load8<float>(float (&f)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The page pool the PAGED instantiation walks in place: k and v point
// at kv head 0 of page 0 (of this rank's head slice), page p's kv head
// h at p * page_stride + h * head_stride elements, its page_size rows
// of d (dv) contiguous; table (B rows of table_stride) holds the
// physical page of each of the chunk's `pages` logical pages from
// `first_page` on (-1: none); lengths (B,) the keys of each request.
struct PagedKV {
  const int* table;
  const int* lengths;
  long long k_page_stride, k_head_stride, v_page_stride, v_head_stride;
  int table_stride, pages, first_page, page_size;
  int stage_keys;  // bf16 keys a ring stage holds (twice as many bytes
                   // as kPartialStageKeys' where smaller)
};

// splits == 1: o_out/m_out/l_out are the outputs, dead rows zeroed.
// splits > 1: they are the scratch (splits, rows_total, ...) of raw
// states, merged by attn_merge_kernel.
//
// PAGED: k and v are the page pool (`pg`), walked in place.  Request
// b's query rows sit at positions lengths[b] - m .. lengths[b] - 1; the
// block reads only the logical pages [lo, ceil(len / page_size)) of
// the chunk, lo the first page of the window of the first row (0 with
// no window), in kv tiles of bkv keys from page lo's first key on, and
// split `blockIdx.x` takes an equal share of those tiles
// ([s * T / S, (s + 1) * T / S)), so that the host's split count needs
// no length.  A key's position is its logical page * page_size + its
// offset; a key on a page of -1 is not read and takes INVALID_POS,
// keys past the last page are not read and fail the causal mask.
// Otherwise (kv_pos, q_pos given) the contiguous kv shard is split
// into runs of `tiles_per_split` tiles.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(kPartialThreads) attn_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_pos,
    const int* __restrict__ q_pos, float* __restrict__ o_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int hq, int hkv,
    int m, int n, int d, int dv, int bq, int bkv, int tiles_per_split,
    int kv_pos_bstride, int q_pos_bstride, int masked, int window,
    float scale, PagedKV pg) {
  const int split = blockIdx.x;
  const int hk = blockIdx.y % hkv;
  const int row0 = blockIdx.y / hkv * bq;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int R = group * bq;  // rows of the block: the group's q tiles
  constexpr int nt = kPartialThreads;
  constexpr int n_warps = nt / 32;
  constexpr int vec = 16 / sizeof(T);
  const int ldk = d + vec;  // 16 B of padding: conflict-free row reads
  const int ldv = dv + vec;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // kv tiles a stage (PAGED: of the wrapper's stage size)
  const int st = max(1, (PAGED ? pg.stage_keys : kPartialStageKeys) * 2 /
                            static_cast<int>(sizeof(T)) / bkv);
  const int sk = st * bkv;                         // keys a stage

  // layout == attention_partial_smem_bytes(bq, bkv, d, dv, sizeof(T),
  // group)
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);        // 2 stages of sk x ldk
  T* s_v = s_k + 2 * sk * ldk;                // 2 stages of sk x ldv
  float* s_q = reinterpret_cast<float*>(s_v + 2 * sk * ldv);  // R x d
  float* s_o = s_q + R * d;                   // R x dv
  float* s_s = s_o + R * dv;                  // R x sk
  float* s_m = s_s + R * sk;
  float* s_l = s_m + R;
  float* s_c = s_l + R;                       // R x st

  // block row r: q-head hk * group + r / bq, query row row0 + r % bq
  auto out_row = [&](int r) {
    return (static_cast<size_t>(b) * hq + hk * group + r / bq) * m + row0 +
           r % bq;
  };
  const size_t kv_base = (static_cast<size_t>(b) * hkv + hk) * n;
  const int* rows_pos =
      PAGED ? nullptr
            : q_pos + static_cast<size_t>(b) * q_pos_bstride + row0;
  const int* cols =
      PAGED ? nullptr : kv_pos + static_cast<size_t>(b) * kv_pos_bstride;
  // key j of the walk: slot j of the shard, or (PAGED) the key at
  // position j; its first tile and how many
  int j_begin, n_tiles;
  int len = 0, key_end = 0;  // PAGED: the request's length, the walk's end
  const int* tbl = nullptr;
  if constexpr (PAGED) {
    len = pg.lengths[b];
    tbl = pg.table + static_cast<size_t>(b) * pg.table_stride;
    const int ps = pg.page_size;
    int lo = window > 0 ? max(0, len - m - window + 1) / ps : 0;
    int hi = len > 0 ? (len + ps - 1) / ps : 0;
    lo = max(lo, pg.first_page);
    hi = min(hi, pg.first_page + pg.pages);
    const int tiles = hi > lo ? ((hi - lo) * ps + bkv - 1) / bkv : 0;
    const int t0 = static_cast<int>(static_cast<long long>(split) * tiles /
                                    gridDim.x);
    const int t1 = static_cast<int>(
        static_cast<long long>(split + 1) * tiles / gridDim.x);
    j_begin = lo * ps + t0 * bkv;
    n_tiles = t1 - t0;
    key_end = hi * ps;
  } else {
    const int t_begin = split * tiles_per_split;
    n_tiles = min(n / bkv - t_begin, tiles_per_split);
    j_begin = t_begin * bkv;
  }
  // PAGED: the physical page of the key at position j, -1 where the
  // walk reads none (a page of -1, or past the walk's last page)
  auto page_of = [&](int j) {
    return j < key_end ? tbl[j / pg.page_size - pg.first_page] : -1;
  };
  // the query row of block row r's position
  auto row_pos = [&](int r) {
    if constexpr (PAGED)
      return len - m + row0 + r % bq;
    else
      return rows_pos[r % bq];
  };

  // the kv rows [j0, j0 + keys) into ring stage `stage`; PAGED: a key
  // the walk reads no page for is zero-filled
  auto load_kv = [&](int j0, int keys, int stage) {
    T* ks = s_k + stage * sk * ldk;
    T* vs = s_v + stage * sk * ldv;
    if constexpr (PAGED) {
      const int kc = d / vec, vc = dv / vec, ps = pg.page_size;
      for (int i = threadIdx.x; i < keys * kc; i += nt) {
        const int j = j0 + i / kc, p = page_of(j);
        const T* src = p < 0 ? k
                             : k + p * pg.k_page_stride +
                                   hk * pg.k_head_stride +
                                   static_cast<long long>(j % ps) * d +
                                   (i % kc) * vec;
        cp_async16(ks + (i / kc) * ldk + (i % kc) * vec, src, p >= 0);
      }
      for (int i = threadIdx.x; i < keys * vc; i += nt) {
        const int j = j0 + i / vc, p = page_of(j);
        const T* src = p < 0 ? v
                             : v + p * pg.v_page_stride +
                                   hk * pg.v_head_stride +
                                   static_cast<long long>(j % ps) * dv +
                                   (i % vc) * vec;
        cp_async16(vs + (i / vc) * ldv + (i % vc) * vec, src, p >= 0);
      }
    } else {
      const int kc = d / vec, vc = dv / vec;
      const T* kg = k + (kv_base + j0) * d;
      const T* vg = v + (kv_base + j0) * dv;
      for (int i = threadIdx.x; i < keys * kc; i += nt)
        cp_async16(ks + (i / kc) * ldk + (i % kc) * vec,
                   kg + (i / kc) * d + (i % kc) * vec);
      for (int i = threadIdx.x; i < keys * vc; i += nt)
        cp_async16(vs + (i / vc) * ldv + (i % vc) * vec,
                   vg + (i / vc) * dv + (i % vc) * vec);
    }
  };
  const int n_stages = (n_tiles + st - 1) / st;
  if (n_tiles > 0) load_kv(j_begin, min(st, n_tiles) * bkv, 0);
  cp_async_commit();

  for (int e = threadIdx.x; e < R * d; e += nt)
    s_q[e] = to_f32(q[out_row(e / d) * d + e % d]);
  for (int e = threadIdx.x; e < R * dv; e += nt) s_o[e] = 0.f;
  for (int r = threadIdx.x; r < R; r += nt) {
    s_m[r] = kNegInf;
    s_l[r] = 0.f;
  }

  for (int it = 0; it < n_stages; ++it) {
    const int ns = min(st, n_tiles - it * st);  // kv tiles in this stage
    const int keys = ns * bkv;
    const int j0 = j_begin + it * sk;
    if (it + 1 < n_stages)
      load_kv(j0 + sk, min(st, n_tiles - (it + 1) * st) * bkv, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const T* ks = s_k + (it & 1) * sk * ldk;
    const T* vs = s_v + (it & 1) * sk * ldv;

    // scores of every key of the stage: a thread takes one key for all
    // R rows, kRowChunk rows per pass over the key's row
    for (int j = threadIdx.x; j < keys; j += nt) {
      const T* kr = ks + j * ldk;
      int col;
      if constexpr (PAGED)
        col = page_of(j0 + j) < 0 ? kInvalidPos : j0 + j;
      else
        col = cols[j0 + j];
      for (int r0 = 0; r0 < R; r0 += kRowChunk) {
        float acc[kRowChunk] = {};
        for (int c = 0; c < d; c += 8) {
          float kf[8];
          load8(kf, kr + c);
#pragma unroll
          for (int i = 0; i < kRowChunk; ++i) {
            if (r0 + i < R) {
              const float* qr = s_q + (r0 + i) * d + c;
              const float4 qa = *reinterpret_cast<const float4*>(qr);
              const float4 qb = *reinterpret_cast<const float4*>(qr + 4);
              acc[i] = fmaf(qa.x, kf[0], acc[i]);
              acc[i] = fmaf(qa.y, kf[1], acc[i]);
              acc[i] = fmaf(qa.z, kf[2], acc[i]);
              acc[i] = fmaf(qa.w, kf[3], acc[i]);
              acc[i] = fmaf(qb.x, kf[4], acc[i]);
              acc[i] = fmaf(qb.y, kf[5], acc[i]);
              acc[i] = fmaf(qb.z, kf[6], acc[i]);
              acc[i] = fmaf(qb.w, kf[7], acc[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRowChunk; ++i) {
          const int r = r0 + i;
          if (r < R) {
            float s = acc[i] * scale;
            if (masked) {
              const int row = row_pos(r);
              bool keep = col <= row;
              if (window > 0) keep = keep && col > row - window;
              if (!keep) s = kNegInf;
            }
            s_s[r * sk + j] = s;
          }
        }
      }
    }
    __syncthreads();

    // online softmax, one kv tile after the other: one warp per row; P
    // rounded to T for P V, the sum of the unrounded P for l
    for (int r = warp; r < R; r += n_warps) {
      float m_run = s_m[r], l_run = s_l[r];
      for (int u = 0; u < ns; ++u) {
        float* sr = s_s + r * sk + u * bkv;
        float mx = kNegInf;
        for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, sr[j]);
        mx = warp_max(mx);
        const float m_new = fmaxf(m_run, mx);
        float sum = 0.f;
        for (int j = lane; j < bkv; j += 32) {
          const float p = expf(sr[j] - m_new);
          sr[j] = to_f32(from_f32<T>(p));
          sum += p;
        }
        sum = warp_sum(sum);
        const float corr = expf(m_run - m_new);
        l_run = l_run * corr + sum;
        m_run = m_new;
        if (lane == 0) s_c[r * st + u] = corr;
      }
      if (lane == 0) {
        s_m[r] = m_run;
        s_l[r] = l_run;
      }
    }
    __syncthreads();

    // o = o * corr + P V for each kv tile in turn, a thread per (row,
    // column pair)
    const int pairs = dv / 2;
    for (int e = threadIdx.x; e < R * pairs; e += nt) {
      const int r = e / pairs;
      const int c = (e % pairs) * 2;
      float* op = s_o + r * dv + c;
      float o0 = op[0], o1 = op[1];
      for (int u = 0; u < ns; ++u) {
        const float* pr = s_s + r * sk + u * bkv;
        const T* vt = vs + u * bkv * ldv + c;
        float a0 = 0.f, a1 = 0.f;
        for (int j = 0; j < bkv; ++j) {
          const float2 vv = load2(vt + j * ldv);
          a0 = fmaf(pr[j], vv.x, a0);
          a1 = fmaf(pr[j], vv.y, a1);
        }
        const float corr = s_c[r * st + u];
        o0 = o0 * corr + a0;
        o1 = o1 * corr + a1;
      }
      op[0] = o0;
      op[1] = o1;
    }
    __syncthreads();  // this stage and the scores are no longer read
  }

  if (gridDim.x == 1) {
    // rows masked across the whole shard accumulated exp(0) = 1 per
    // key: emit the merge identity (0, NEG_INF, 0) for them instead
    for (int e = threadIdx.x; e < R * dv; e += nt) {
      const bool dead = s_m[e / dv] <= kNegInf * 0.5f;
      o_out[out_row(e / dv) * dv + e % dv] = dead ? 0.f : s_o[e];
    }
    for (int r = threadIdx.x; r < R; r += nt) {
      const bool dead = s_m[r] <= kNegInf * 0.5f;
      m_out[out_row(r)] = s_m[r];
      l_out[out_row(r)] = dead ? 0.f : s_l[r];
    }
    return;
  }
  // raw state of this split; the merge zeroes dead rows
  const size_t rows_total = static_cast<size_t>(gridDim.z) * hq * m;
  const size_t base = split * rows_total;
  for (int e = threadIdx.x; e < R * dv; e += nt)
    o_out[(base + out_row(e / dv)) * dv + e % dv] = s_o[e];
  for (int r = threadIdx.x; r < R; r += nt) {
    m_out[base + out_row(r)] = s_m[r];
    l_out[base + out_row(r)] = s_l[r];
  }
}

// The log-sum-exp combine of the splits' raw states, in split order,
// then the merge identity for rows dead across the whole shard.  A
// thread per output element.
__global__ void attn_merge_kernel(const float* __restrict__ o_part,
                                  const float* __restrict__ m_part,
                                  const float* __restrict__ l_part,
                                  float* __restrict__ o,
                                  float* __restrict__ m_out,
                                  float* __restrict__ l_out, int splits,
                                  long long rows, int dv) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= rows * dv) return;
  const long long r = e / dv;
  const int c = static_cast<int>(e % dv);
  float mt = kNegInf;
  for (int s = 0; s < splits; ++s) mt = fmaxf(mt, m_part[s * rows + r]);
  float acc = 0.f, lt = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(m_part[s * rows + r] - mt);
    acc += o_part[(s * rows + r) * dv + c] * w;
    lt += l_part[s * rows + r] * w;
  }
  const bool dead = mt <= kNegInf * 0.5f;
  o[e] = dead ? 0.f : acc;
  if (c == 0) {
    m_out[r] = mt;
    l_out[r] = dead ? 0.f : lt;
  }
}

template <typename T, bool PAGED>
int launch_partial(const void* q, const void* k, const void* v,
                   const int* kv_pos, const int* q_pos, float* o,
                   float* m_run, float* l_run, float* o_part, float* m_part,
                   float* l_part, int batch, int hq, int hkv, int m, int n,
                   int d, int dv, int bq, int bkv, int splits,
                   int tiles_per_split, int kv_pos_bstride,
                   int q_pos_bstride, int masked, int window, float scale,
                   size_t smem, cudaStream_t stream, const PagedKV& pg) {
  auto kernel = attn_partial_kernel<T, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, hkv * (m / bq), batch);
  const bool merged = splits > 1;
  kernel<<<grid, kPartialThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_pos, q_pos, merged ? o_part : o,
      merged ? m_part : m_run, merged ? l_part : l_run, hq, hkv, m, n, d, dv,
      bq, bkv, tiles_per_split, kv_pos_bstride, q_pos_bstride, masked,
      window, scale, pg);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merged) return static_cast<int>(err);
  const long long rows = static_cast<long long>(batch) * hq * m;
  const int threads = 256;
  const long long blocks = (rows * dv + threads - 1) / threads;
  attn_merge_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      o_part, m_part, l_part, o, m_run, l_run, splits, rows, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One kv shard's raw state.  dtype: 0 = float32, 1 = bfloat16.  With
// splits > 1 the kv axis is cut into runs of `tiles_per_split` tiles
// whose raw states go to the scratch o_part (splits, B*Hq*M, Dv),
// m_part and l_part (splits, B*Hq*M) and are merged into o, m_run,
// l_run.  Returns cudaGetLastError() after the launches (0 on success);
// the caller validated every shape.
int attn_partial_launch(int dtype, const void* q, const void* k,
                        const void* v, const int* kv_pos, const int* q_pos,
                        float* o, float* m_run, float* l_run, float* o_part,
                        float* m_part, float* l_part, int batch, int hq,
                        int hkv, int m, int n, int d, int dv, int bq,
                        int bkv, int splits, int tiles_per_split,
                        int kv_pos_bstride, int q_pos_bstride, int masked,
                        int window, float scale, long long smem_bytes,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const PagedKV none{};
  if (dtype == 0)
    return launch_partial<float, false>(
        q, k, v, kv_pos, q_pos, o, m_run, l_run, o_part, m_part, l_part,
        batch, hq, hkv, m, n, d, dv, bq, bkv, splits, tiles_per_split,
        kv_pos_bstride, q_pos_bstride, masked, window, scale, smem, s, none);
  if (dtype == 1)
    return launch_partial<bf16, false>(
        q, k, v, kv_pos, q_pos, o, m_run, l_run, o_part, m_part, l_part,
        batch, hq, hkv, m, n, d, dv, bq, bkv, splits, tiles_per_split,
        kv_pos_bstride, q_pos_bstride, masked, window, scale, smem, s, none);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The partial state of paged decode attention over one chunk of the
// page table, read from the pools in place (attn_partial_kernel's
// PAGED instantiation; causal).  k_pages / v_pages: kv head 0 of page
// 0, strides in elements; table: the chunk's first column, rows of
// table_stride; `splits` blocks share each request's live tiles.
// Outputs and scratch as attn_partial_launch's.
int attn_partial_paged_launch(int dtype, const void* q, const void* k_pages,
                              const void* v_pages, const int* table,
                              const int* lengths, float* o, float* m_run,
                              float* l_run, float* o_part, float* m_part,
                              float* l_part, int batch, int hq, int hkv,
                              int m, int d, int dv, int bq, int bkv,
                              int splits, int table_stride, int pages,
                              int first_page, int page_size,
                              long long k_page_stride,
                              long long k_head_stride,
                              long long v_page_stride,
                              long long v_head_stride, int stage_keys,
                              int window, float scale, long long smem_bytes,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const PagedKV pg{table,         lengths,       k_page_stride,
                   k_head_stride, v_page_stride, v_head_stride,
                   table_stride,  pages,         first_page,
                   page_size,     stage_keys};
  const int n = pages * page_size;
  if (dtype == 0)
    return launch_partial<float, true>(
        q, k_pages, v_pages, nullptr, nullptr, o, m_run, l_run, o_part,
        m_part, l_part, batch, hq, hkv, m, n, d, dv, bq, bkv, splits, 0, 0,
        0, 1, window, scale, smem, s, pg);
  if (dtype == 1)
    return launch_partial<bf16, true>(
        q, k_pages, v_pages, nullptr, nullptr, o, m_run, l_run, o_part,
        m_part, l_part, batch, hq, hkv, m, n, d, dv, bq, bkv, splits, 0, 0,
        0, 1, window, scale, smem, s, pg);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The normalised attention O = softmax(q k^T * scale + mask) V with the
// query rows at the tail of the kv sequence; o in q's type.  dtype: 0 =
// float32 (CUDA cores), 1 = bfloat16 (tensor cores); qpro, kpro, oepi:
// the q and k prologues and the o epilogue (hook.cuh; n = 0: none).
// Returns cudaGetLastError() after the launch (0 on success); the caller
// validated every shape and tile.
int attn_launch(int dtype, const void* q, const void* k, const void* v,
                void* o, int batch, int hq, int hkv, int m, int n, int d,
                int dv, int bq, int bkv, int masked, int window, float scale,
                long long smem_bytes, void* stream, Hook qpro, Hook kpro,
                Hook oepi) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (dtype == 0) {
    auto kernel = qpro.n || kpro.n || oepi.n ? attn_f32_kernel<true>
                                             : attn_f32_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(m / bq, hq, batch), kF32Threads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, m, n,
        d, dv, bq, bkv, masked, window, scale, qpro, kpro, oepi);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // register buckets: see attention_tiles_ok in core/perf_model.py
  if (dv <= 64)
    return bkv <= 64
               ? launch_mma<64, 64>(q, k, v, o, batch, hq, hkv, m, n, d, dv,
                                    bq, bkv, masked, window, scale, smem, s,
                                    qpro, kpro, oepi)
               : launch_mma<64, 128>(q, k, v, o, batch, hq, hkv, m, n, d,
                                     dv, bq, bkv, masked, window, scale,
                                     smem, s, qpro, kpro, oepi);
  if (dv <= 128)
    return bkv <= 64
               ? launch_mma<128, 64>(q, k, v, o, batch, hq, hkv, m, n, d, dv,
                                     bq, bkv, masked, window, scale, smem, s,
                                     qpro, kpro, oepi)
               : launch_mma<128, 128>(q, k, v, o, batch, hq, hkv, m, n, d,
                                      dv, bq, bkv, masked, window, scale,
                                      smem, s, qpro, kpro, oepi);
  return launch_mma<256, 64>(q, k, v, o, batch, hq, hkv, m, n, d, dv, bq,
                             bkv, masked, window, scale, smem, s, qpro, kpro,
                             oepi);
}

const char* attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
