// The chain machine shared by the MLP kernel (mlp_chain.cu) and the
// GEMM-chain kernels (gemm_chain.cu), for Hopper (sm_90a).
//
// One block computes, for its m tile and its run of n blocks, the
// hidden tile act(A Wg) * (A Wu) (or act(A Wu)) over all of K into
// shared memory, then multiplies it into the down-projection's rows E
// chunk by E chunk.  The grid is (m tiles, E tiles, n splits x batch);
// with more than one split each block writes an f32 partial E and
// `mlp_merge_kernel` sums the partials in split order.  The design, its
// bound and what it leaves are written at the head of mlp_chain.cu.
//
// The two-GEMM chain E = (A B) D is this machine's ungated case with
// the identity activation (`kIdentity`, an internal act code no caller
// of the MLP entry passes): C accumulates in f32 over k, is rounded to
// D's type as the hidden tile, and E accumulates in f32 over n.  The
// three-GEMM chain runs the same up and down phases (`mma_up`,
// `mma_down`) in one block a (m tile, batch), keeps the whole E row on
// chip and runs a third phase G = E F (`chain3_mma_kernel` in
// gemm_chain.cu).
//
// Shared memory is exactly `mlp_smem_bytes` / `gemm_chain3_smem_bytes`
// in core/perf_model.py, and the bf16 tile rule `mlp_tiles_ok`.
//
// The stitching hooks (hook.cuh) cost no shared memory, and run only in
// the kernels' HOOKED instantiations, which the launch picks when a hook
// has steps: without one, the kernels are what they were.  The prologue
// runs on each A element once per use: in the bf16 machine on the A
// tile of a ring stage right after the stage lands (every stage holds a
// fresh copy of its A tile, so no element is hooked twice), rounded back
// to bf16 as the JAX kernel's hook returns the tile in its own type; in
// the f32 kernel on the staged A tile.  The epilogue runs on the
// finished f32 output before its one cast: in the block's store with one
// split, and in `mlp_merge_kernel` after the in-order sum with more (a
// block holds only a partial sum, and a non-linear epilogue of a
// partial is not the epilogue of the sum); never on the f32 partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hook.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;      // rows one thread carries (f32 kernel)
constexpr int kInFlight = 8;  // loads a thread issues before it waits
// the bf16 kernel: MLP_E_CHUNK and MLP_MAX_ROW_GROUPS of
// core/perf_model.py, and the most ring stages it takes (its waits
// name up to kMaxStages - 2 pending groups)
constexpr int kMaxStages = 16;
constexpr int kEChunk = 32 * kWarps;
constexpr int kMaxGroups = 9;
constexpr int kPad = 8;  // bf16 elements (16 B) after each shared row

// kIdentity: the GEMM chains' "activation", never an MLP's
enum Act { kSilu = 0, kGelu = 1, kRelu = 2, kIdentity = 3 };

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

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == kSilu) return x * (1.f / (1.f + expf(-x)));
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
  }
  if (act == kRelu) return fmaxf(x, 0.f);
  return x;
}

__device__ __forceinline__ int ceil16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous: `bytes` (0..16) are copied
// and the rest of the 16 zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0 .. kMaxStages - 2) committed groups
// are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
#define MLP_WAIT(N)                                                  \
  case N:                                                            \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); \
    break;
    MLP_WAIT(1) MLP_WAIT(2) MLP_WAIT(3) MLP_WAIT(4) MLP_WAIT(5) MLP_WAIT(6)
    MLP_WAIT(7) MLP_WAIT(8) MLP_WAIT(9) MLP_WAIT(10) MLP_WAIT(11)
    MLP_WAIT(12) MLP_WAIT(13) MLP_WAIT(14)
#undef MLP_WAIT
    default:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
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

// E (splits == 1) or this split's f32 partial E: element (row, col) of
// the block's output, `part` laid out (splits, B, M, H)
template <typename TA>
__device__ __forceinline__ void store_e(TA* __restrict__ e_out,
                                        float* __restrict__ part, int split,
                                        int splits, int b, int batch, int m,
                                        int h, int row, int col, float v) {
  if (splits > 1)
    part[((static_cast<size_t>(split) * batch + b) * m + row) * h + col] = v;
  else
    e_out[(static_cast<size_t>(b) * m + row) * h + col] = from_f32<TA>(v);
}

// Elements (row, col) and (row, col + 1) of the block's output, those
// below col_end, as one 8-byte (f32 partial) or 4-byte (bf16 E) store
// when both are in and the row stride keeps it aligned (col is even)
__device__ __forceinline__ void store_e2(bf16* __restrict__ e_out,
                                         float* __restrict__ part, int split,
                                         int splits, int b, int batch, int m,
                                         int h, int row, int col, int col_end,
                                         float v0, float v1) {
  if (col + 1 < col_end && (h & 1) == 0) {
    if (splits > 1)
      *reinterpret_cast<float2*>(
          part + ((static_cast<size_t>(split) * batch + b) * m + row) * h +
          col) = make_float2(v0, v1);
    else
      *reinterpret_cast<uint32_t*>(
          e_out + (static_cast<size_t>(b) * m + row) * h + col) =
          pack_bf16(v0, v1);
    return;
  }
  if (col < col_end)
    store_e(e_out, part, split, splits, b, batch, m, h, row, col, v0);
  if (col + 1 < col_end)
    store_e(e_out, part, split, splits, b, batch, m, h, row, col + 1, v1);
}

// ---------------------------------------------------------------------
// bf16: the tensor-core machine
// ---------------------------------------------------------------------

// Copy a (rows, cols) bf16 tile (cols a multiple of 8) whose row r
// starts at src + r * lds into dst (row stride ldd), zero where r >= vr
// or the column >= vc: 16-byte cp.async when src and lds allow it (the
// caller commits), else element copies.  A thread walks its 16-byte
// chunks with one division a call, not one a chunk: the copy's own
// instructions, not the bytes, set the time of a small tile.
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, int ldd,
                                          const bf16* __restrict__ src,
                                          long long lds, int rows, int cols,
                                          int vr, int vc) {
  const int cc = cols >> 3;  // chunks a row
  const bool vec =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (lds & 7) == 0;
  const int step_r = kThreads / cc, step_c = kThreads - step_r * cc;
  int r = threadIdx.x / cc, c = threadIdx.x - r * cc;
  while (r < rows) {
    const int c8 = c * 8;
    bf16* d = dst + r * ldd + c8;
    const int valid = r < vr ? min(8, vc - c8) : 0;  // may be negative
    if (vec) {
      cp_async16(d, valid > 0 ? src + r * lds + c8 : src,
                 valid > 0 ? valid * 2 : 0);
    } else {
      for (int x = 0; x < 8; ++x)
        d[x] = x < valid ? src[r * lds + c8 + x] : __float2bfloat16(0.f);
    }
    r += step_r;
    c += step_c;
    if (c >= cc) {
      c -= cc;
      ++r;
    }
  }
}

// One block's geometry in the tensor-core machine: bm, bn and bk padded
// to whole 16s, the shared row strides (each row padded by 16 bytes so
// that `ldmatrix` is free of bank conflicts), and the elements of one
// ring stage — the larger of an up stage (the A tile and the Wu, and
// Wg, tiles) and a down stage of `dr` rows by kEChunk columns, as
// perf_model.mlp_ring lays it out.
struct MmaGeom {
  int groups, bmp, bkp, bnp, ngr, lda, ldw, ldd, stage;
  __device__ __forceinline__ MmaGeom(int bm, int bn, int bk, int nw, int dr)
      : groups((bm + 15) / 16), bmp(groups * 16), bkp(ceil16(bk)),
        bnp(ceil16(bn)), ngr(bnp / 16), lda(bkp + kPad), ldw(bnp + kPad),
        ldd(kEChunk + kPad),
        stage(max(bmp * lda + nw * bkp * ldw, dr * ldd)) {}
};

// The up phase: hid (bmp rows, row stride ldh) = act(A Wg) * (A Wu),
// or act(A Wu), for the n blocks of bn in [n_begin, n_begin + n_len),
// each over all of K, rounded to bf16; block j of the run at column
// j * bnp.  A is the block's first row (row stride k, `rows` valid), Wu
// and Wg row-major (K, N).  Warp w owns the 16-column groups w, w + 8,
// ... of an n block (at most NB of them) for every row group (at most
// MB: bm <= 16 MB), so each Wu / Wg fragment is loaded once for all
// rows and each A fragment once for all its columns (an n block of
// fewer column groups than warps leaves warps idle; sharing a group's
// row groups among them slowed the MLP kernel by 4-6 % on an H100).
// Register arrays are sized by the buckets, loops unrolled and guarded
// by the real counts.  HOOKED: the prologue `pro` on each stage's A
// tile.  The caller synchronises before the ring is reused.
template <bool GATED, int MB, int NB, bool HOOKED>
__device__ __forceinline__ void mma_up(
    const MmaGeom& G, bf16* __restrict__ ring, int stages,
    bf16* __restrict__ hid, int ldh, const bf16* __restrict__ a_b,
    const bf16* __restrict__ wu_b, const bf16* __restrict__ wg_b, int rows,
    int n, int k, int bn, int bk, int n_begin, int n_len, int act,
    const Hook& pro) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int n_blocks = (n_len + bn - 1) / bn;
  const int k_tiles = (k + bk - 1) / bk;
  const int steps1 = n_blocks * k_tiles;
  auto load_up = [&](int t) {
    const int j = t / k_tiles, k0 = (t - j * k_tiles) * bk;
    const int n0 = n_begin + j * bn;
    const int kr = min(bk, k - k0), nc = min(bn, n - n0);
    bf16* st = ring + (t % stages) * G.stage;
    load_tile(st, G.lda, a_b + k0, k, G.bmp, G.bkp, rows, kr);
    load_tile(st + G.bmp * G.lda, G.ldw,
              wu_b + static_cast<size_t>(k0) * n + n0, n, G.bkp, G.bnp, kr,
              nc);
    if (GATED)
      load_tile(st + G.bmp * G.lda + G.bkp * G.ldw, G.ldw,
                wg_b + static_cast<size_t>(k0) * n + n0, n, G.bkp, G.bnp, kr,
                nc);
  };
  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps1) load_up(s);
    cp_async_commit();
  }
  float acc_u[MB][NB][2][4], acc_g[MB][NB][2][4];
  for (int t = 0; t < steps1; ++t) {
    cp_async_wait(stages - 2);
    __syncthreads();  // stage t landed; stage t - 1 is no longer read
    if (t + stages - 1 < steps1) load_up(t + stages - 1);
    cp_async_commit();
    const int j = t / k_tiles, kt = t - j * k_tiles;
    if constexpr (HOOKED) {
      if (pro.n) {  // the prologue on this stage's A tile, its valid part
        hook_tile(&pro, ring + (t % stages) * G.stage, G.lda, rows,
                  min(bk, k - kt * bk));
        __syncthreads();
      }
    }
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int q = 0; q < NB; ++q)
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              acc_u[i][q][f][x] = acc_g[i][q][f][x] = 0.f;
    }
    const bf16* sa = ring + (t % stages) * G.stage;
    const bf16* su = sa + G.bmp * G.lda;
    const bf16* sg = su + G.bkp * G.ldw;
    const int k_end = ceil16(min(bk, k - kt * bk));
    for (int kc = 0; kc < k_end; kc += 16) {
      uint32_t bu[NB][4], bg[NB][4];
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        if (warp + q * kWarps < G.ngr) {
          const int woff = (kc + (lane & 7) + ((lane >> 3) & 1) * 8) * G.ldw +
                           (warp + q * kWarps) * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bu[q], su + woff);
          if (GATED) ldmatrix_x4_trans(bg[q], sg + woff);
        }
      }
      if (warp >= G.ngr) continue;  // no column group for this warp
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        if (i < G.groups) {
          uint32_t af[4];
          ldmatrix_x4(af, sa + (i * 16 + (lane & 15)) * G.lda + kc +
                              (lane >> 4) * 8);
#pragma unroll
          for (int q = 0; q < NB; ++q) {
            if (warp + q * kWarps < G.ngr) {
              mma_bf16(acc_u[i][q][0], af, bu[q][0], bu[q][1]);
              mma_bf16(acc_u[i][q][1], af, bu[q][2], bu[q][3]);
              if (GATED) {
                mma_bf16(acc_g[i][q][0], af, bg[q][0], bg[q][1]);
                mma_bf16(acc_g[i][q][1], af, bg[q][2], bg[q][3]);
              }
            }
          }
        }
      }
    }
    if (kt == k_tiles - 1) {  // n block j done: its hidden, in bf16
#pragma unroll
      for (int i = 0; i < MB; ++i) {
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const int c16 = (warp + q * kWarps) * 16;
          if (i >= G.groups || c16 >= G.bnp) continue;
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float x0 = acc_u[i][q][f][2 * r];
              float x1 = acc_u[i][q][f][2 * r + 1];
              if (GATED) {
                x0 = act_fn(acc_g[i][q][f][2 * r], act) * x0;
                x1 = act_fn(acc_g[i][q][f][2 * r + 1], act) * x1;
              } else {
                x0 = act_fn(x0, act);
                x1 = act_fn(x1, act);
              }
              *reinterpret_cast<uint32_t*>(
                  hid + (i * 16 + g + r * 8) * ldh + j * G.bnp + c16 +
                  f * 8 + tig * 2) = pack_bf16(x0, x1);
            }
        }
      }
    }
  }
}

// The down phase: src (bmp rows of bf16 in shared memory, row stride
// lds, columns past n_len zero) times the first n_len rows of W
// (row-major, row stride ldw, in device memory), for the output columns
// [c_begin, c_end), one chunk of kEChunk columns at a time; warp w owns
// columns 32w .. 32w + 31 of a chunk for all rows.  A chunk of fewer
// live 32-column slices than warps shares each slice among kWarps /
// slices warps, each taking every such-th row group.  The W tiles come
// through the ring, `dr` rows a stage (zero past n_len and c_end).
// Each finished chunk goes to `store(row, col, v0, v1)`: the f32
// results at block row `row` (< bmp) and columns col, col + 1 (col even,
// any may lie past c_end; those are 0).  The caller synchronises before
// the ring is reused.
template <int MB, typename Store>
__device__ __forceinline__ void mma_down(
    const MmaGeom& G, bf16* __restrict__ ring, int stages, int dr,
    const bf16* __restrict__ src, int lds, const bf16* __restrict__ w,
    long long ldw, int n_len, int c_begin, int c_end, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int n_pad = ceil16(n_len);  // src columns past n_len are 0
  const int steps_per_chunk = (n_pad + dr - 1) / dr;
  const int chunks = (c_end - c_begin + kEChunk - 1) / kEChunk;
  const int steps2 = chunks * steps_per_chunk;
  auto load_down = [&](int t) {
    const int c = t / steps_per_chunk;
    const int r0 = (t - c * steps_per_chunk) * dr;
    const int c0 = c_begin + c * kEChunk;
    load_tile(ring + (t % stages) * G.stage, G.ldd,
              w + static_cast<size_t>(r0) * ldw + c0, ldw,
              min(dr, n_pad - r0), kEChunk, min(dr, n_len - r0), c_end - c0);
  };
  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps2) load_down(s);
    cp_async_commit();
  }
  float acc_e[MB][4][4];
  int slice = warp;  // the warp's 32-column slice of the chunk
  unsigned own = 0;  // and its row groups
  for (int t = 0; t < steps2; ++t) {
    cp_async_wait(stages - 2);
    __syncthreads();
    if (t + stages - 1 < steps2) load_down(t + stages - 1);
    cp_async_commit();
    const int c = t / steps_per_chunk, st = t - c * steps_per_chunk;
    const int r0 = st * dr;
    if (st == 0) {
#pragma unroll
      for (int mt = 0; mt < MB; ++mt)
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc_e[mt][f][x] = 0.f;
      const int live = c_end - c_begin - c * kEChunk;  // columns of chunk c
      if (live >= kEChunk) {
        slice = warp;
        own = (1u << G.groups) - 1;
      } else {
        const int slices = (live + 31) / 32, share = kWarps / slices;
        slice = warp % slices;
        own = 0;
        for (int i = warp / slices; i < G.groups && warp < share * slices;
             i += share)
          own |= 1u << i;
      }
    }
    const int cw0 = c_begin + c * kEChunk + slice * 32;
    if (own) {
      const bf16* sd = ring + (t % stages) * G.stage;
      const int r_end = min(dr, n_pad - r0);
      for (int kc = 0; kc < r_end; kc += 16) {
        uint32_t bd[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          ldmatrix_x4_trans(bd[q], sd + (kc + (lane & 7) +
                                         ((lane >> 3) & 1) * 8) * G.ldd +
                                       slice * 32 + q * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MB; ++mt) {
          if ((own >> mt) & 1) {
            uint32_t af[4];
            ldmatrix_x4(af, src + (mt * 16 + (lane & 15)) * lds + r0 + kc +
                                (lane >> 4) * 8);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              mma_bf16(acc_e[mt][2 * q], af, bd[q][0], bd[q][1]);
              mma_bf16(acc_e[mt][2 * q + 1], af, bd[q][2], bd[q][3]);
            }
          }
        }
      }
    }
    if (st == steps_per_chunk - 1) {  // the chunk is done
#pragma unroll
      for (int mt = 0; mt < MB; ++mt) {
        if ((own >> mt) & 1) {
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              store(mt * 16 + g + r * 8, cw0 + tig * 2 + f * 8,
                    acc_e[mt][f][2 * r], acc_e[mt][f][2 * r + 1]);
        }
      }
    }
  }
}

// The MLP kernel (and the two-GEMM chain, act = kIdentity, ungated):
// the block's hidden over its split's n range, then E chunk by chunk
// over the block's E columns into E or its split's partial; the
// prologue `pro` on A, the epilogue `epi` on E with one split (HOOKED).
template <bool GATED, int MB, int NB, bool HOOKED>
__global__ void __launch_bounds__(kThreads, 1) mlp_mma_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ wu,
    const bf16* __restrict__ wg, const bf16* __restrict__ wd,
    bf16* __restrict__ e_out, float* __restrict__ part, int m, int n, int k,
    int h, int bm, int bn, int bk, int be, int splits, int per, int stages,
    int dr, int act, Hook pro, Hook epi) {
  const int batch = gridDim.z / splits;
  const int split = blockIdx.z % splits;
  const int b = blockIdx.z / splits;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, m - row0);     // valid rows of this block
  const int col0 = blockIdx.y * be;
  const int col_end = min(h, col0 + be);  // E columns of this block
  const int n_begin = split * per * bn;
  const int n_len = min(per * bn, n - n_begin);  // > 0: no split is empty
  const MmaGeom G(bm, bn, bk, GATED ? 2 : 1, dr);
  const int ldh = per * G.bnp + kPad;

  // layout == mlp_smem_bytes(bm, bn, bk, be, 2, 2, GATED, per): the ring
  // of mlp_ring(bm, bn, bk, GATED), then the hidden tile (bmp, per * bnp)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* hid = ring + stages * G.stage;

  mma_up<GATED, MB, NB, HOOKED>(G, ring, stages, hid, ldh,
                        a + (static_cast<size_t>(b) * m + row0) * k,
                        wu + static_cast<size_t>(b) * k * n,
                        wg + static_cast<size_t>(b) * k * n, rows, n, k, bn,
                        bk, n_begin, n_len, act, pro);
  __syncthreads();  // every hidden column written; the ring is free
  mma_down<MB>(G, ring, stages, dr, hid, ldh,
               wd + (static_cast<size_t>(b) * n + n_begin) * h, h, n_len,
               col0, col_end, [&](int row, int col, float v0, float v1) {
                 if (row >= rows) return;
                 if constexpr (HOOKED) {
                   if (splits == 1) {  // E is whole: the epilogue, then E
                     v0 = apply_hook(epi, v0);
                     v1 = apply_hook(epi, v1);
                   }
                 }
                 store_e2(e_out, part, split, splits, b, batch, m, h,
                          row0 + row, col, col_end, v0, v1);
               });
}

// ---------------------------------------------------------------------
// f32 types: the CUDA-core kernel
// ---------------------------------------------------------------------

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

template <typename TA, typename TW, bool GATED, bool HOOKED>
__global__ void __launch_bounds__(kThreads, 2) mlp_f32_kernel(
    const TA* __restrict__ a, const TW* __restrict__ wu,
    const TW* __restrict__ wg, const TW* __restrict__ wd,
    TA* __restrict__ e_out, float* __restrict__ part, int m, int n, int k,
    int h, int bm, int bn, int bk, int be, int splits, int per, int act,
    Hook pro, Hook epi) {
  const int batch = gridDim.z / splits;
  const int split = blockIdx.z % splits;
  const int b = blockIdx.z / splits;
  const int row0 = blockIdx.x * bm;
  const int col0 = blockIdx.y * be;
  const int rows = min(bm, m - row0);  // valid rows of this block
  const int cols = min(be, h - col0);  // valid E columns of this block
  const int n_begin = split * per * bn;
  const int n_end = min(n, n_begin + per * bn);
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

  for (int n0 = n_begin; n0 < n_end; n0 += bn) {
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
      if constexpr (HOOKED) {
        if (pro.n) {  // the prologue on the staged A tile, its valid part
          hook_tile(&pro, s_a, bk, rows, kr);
          __syncthreads();
        }
      }

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

    // hidden = act(G) * U (or act(U)) in place of U, in f32: the
    // promoted type of an f32 operand and any weights
    for (int i = threadIdx.x; i < bm * bn; i += kThreads)
      s_u[i] = GATED ? act_fn(s_g[i], act) * s_u[i] : act_fn(s_u[i], act);
    __syncthreads();

    // E += hidden Wd: a thread owns E column c for kRows rows, one
    // (column, row chunk) pair a pass so that a narrow E tile still
    // spreads over the threads, kInFlight rows of Wd loaded before they
    // are used
    const int row_chunks = (rows + kRows - 1) / kRows;
    for (int p = threadIdx.x; p < cols * row_chunks; p += kThreads) {
      const int c = p % cols;
      const int r0 = (p / cols) * kRows;
      const TW* wcol = wd_b + static_cast<size_t>(n0) * h + c;
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
    __syncthreads();  // hidden is no longer read; E is complete so far
  }

  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    float v = s_e[r * be + c];
    if constexpr (HOOKED) {
      if (splits == 1) v = apply_hook(epi, v);
    }
    store_e(e_out, part, split, splits, b, batch, m, h, row0 + r, col0 + c,
            v);
  }
}

// ---------------------------------------------------------------------
// the merge: E = the epilogue of the sum of the splits' partial E in
// split order, cast once
// ---------------------------------------------------------------------

constexpr int kMergeBatch = 16;  // partial loads a thread has in flight

template <typename TA, bool HOOKED>
__global__ void mlp_merge_kernel(const float* __restrict__ part,
                                 TA* __restrict__ e, int splits,
                                 long long count, Hook epi) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= count) return;
  float acc = part[i];
  for (int s0 = 1; s0 < splits; s0 += kMergeBatch) {
    float v[kMergeBatch];
#pragma unroll
    for (int x = 0; x < kMergeBatch; ++x)
      v[x] = s0 + x < splits ? part[(s0 + x) * count + i] : 0.f;
#pragma unroll
    for (int x = 0; x < kMergeBatch; ++x)
      if (s0 + x < splits) acc += v[x];
  }
  if constexpr (HOOKED) acc = apply_hook(epi, acc);
  e[i] = from_f32<TA>(acc);
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls fn(Int<MB>(), Int<NB>()) with the register bucket of a bf16
// tile — MB row groups of 16 (1, 2, 4 or kMaxGroups) by NB 16-column
// groups a warp (1 or 2), the rule mlp_tiles_ok in core/perf_model.py
// states — and returns what it returns, or cudaErrorInvalidValue for a
// tile outside the rule.
template <typename Fn>
int with_bucket(int bm, int bn, Fn&& fn) {
  const int groups = (bm + 15) / 16;
  const bool two = (bn + 15) / 16 > kWarps;  // two column groups a warp
  if (groups > kMaxGroups || (bn + 15) / 16 > 2 * kWarps ||
      (groups > 4 && two))
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups <= 1)
    return two ? fn(Int<1>(), Int<2>()) : fn(Int<1>(), Int<1>());
  if (groups <= 2)
    return two ? fn(Int<2>(), Int<2>()) : fn(Int<2>(), Int<1>());
  if (groups <= 4)
    return two ? fn(Int<4>(), Int<2>()) : fn(Int<4>(), Int<1>());
  return fn(Int<kMaxGroups>(), Int<1>());
}

// The arguments of a launch of the machine that its kernels cannot
// take, whatever the tiles: a split, ring or grid out of range.
inline bool machine_args_bad(int batch, int h, int be, int splits, int per,
                             int stages, int dr, const void* part) {
  return splits < 1 || per < 1 || (splits > 1 && part == nullptr) ||
         stages < 2 || stages > kMaxStages || dr < 16 || dr % 16 ||
         static_cast<long long>(batch) * splits > 65535 ||
         (h + be - 1) / be > 65535;
}

template <typename TA, typename TW, bool GATED>
int launch(const void* a, const void* wu, const void* wg, const void* wd,
           void* e, float* part, int batch, int m, int n, int k, int h,
           int bm, int bn, int bk, int be, int splits, int per, int stages,
           int dr, int act, size_t smem, cudaStream_t stream,
           const Hook& pro, const Hook& epi) {
  constexpr bool mma = sizeof(TA) == 2 && sizeof(TW) == 2;
  const bool hooked = pro.n || epi.n;
  cudaError_t err;
  const dim3 grid((m + bm - 1) / bm, (h + be - 1) / be, batch * splits);
  if constexpr (mma) {
    err = static_cast<cudaError_t>(with_bucket(bm, bn, [&](auto mb, auto nb) {
      constexpr int MB = decltype(mb)::value, NB = decltype(nb)::value;
      auto kernel = hooked ? mlp_mma_kernel<GATED, MB, NB, true>
                           : mlp_mma_kernel<GATED, MB, NB, false>;
      const cudaError_t set = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (set != cudaSuccess) return static_cast<int>(set);
      kernel<<<grid, kThreads, smem, stream>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(wu),
          static_cast<const bf16*>(wg), static_cast<const bf16*>(wd),
          static_cast<bf16*>(e), part, m, n, k, h, bm, bn, bk, be, splits,
          per, stages, dr, act, pro, epi);
      return 0;
    }));
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    auto kernel = hooked ? mlp_f32_kernel<TA, TW, GATED, true>
                         : mlp_f32_kernel<TA, TW, GATED, false>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const TA*>(a), static_cast<const TW*>(wu),
        static_cast<const TW*>(wg), static_cast<const TW*>(wd),
        static_cast<TA*>(e), part, m, n, k, h, bm, bn, bk, be, splits, per,
        act, pro, epi);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(batch) * m * h;
  const long long blocks = (count + kThreads - 1) / kThreads;
  (epi.n ? mlp_merge_kernel<TA, true> : mlp_merge_kernel<TA, false>)<<<
      static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      part, static_cast<TA*>(e), splits, count, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TW>
int launch_gated(int gated, const void* a, const void* wu, const void* wg,
                 const void* wd, void* e, float* part, int batch, int m,
                 int n, int k, int h, int bm, int bn, int bk, int be,
                 int splits, int per, int stages, int dr, int act,
                 size_t smem, cudaStream_t stream, const Hook& pro,
                 const Hook& epi) {
  if (gated)
    return launch<TA, TW, true>(a, wu, wg, wd, e, part, batch, m, n, k, h,
                                bm, bn, bk, be, splits, per, stages, dr, act,
                                smem, stream, pro, epi);
  return launch<TA, TW, false>(a, wu, wg, wd, e, part, batch, m, n, k, h, bm,
                               bn, bk, be, splits, per, stages, dr, act,
                               smem, stream, pro, epi);
}

}  // namespace
