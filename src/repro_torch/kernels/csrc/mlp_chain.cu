// Fused (gated) MLP chain for Hopper (sm_90a), with the n axis split
// across blocks.
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
// bf16), E accumulated in f32 over the n blocks and cast once to A's
// type.  gelu is the tanh form (jax.nn.gelu's default).  Ragged edges
// are masked: zero-filled loads are exact because act(0) * 0 = 0 and
// act(0) = 0 for silu, gelu and relu, and no padded copy of any operand
// is made.  The JAX kernel's stitching hooks run here too: `prologue` on
// the valid part of each A tile, `epilogue` on the f32 E before its one
// cast, after the sum of the splits (chain_mma.cuh).
//
// Bound.  At decode (qwen3-8b: M = 4, K = H = 4096, N = 12288, bf16)
// the chain reads 302 MB of weights (Wg, Wu, Wd) and does 1.2 GFLOP:
// bound by bytes, 0.090 ms at 3.35 TB/s.  At M = 4096 it does 1.24
// TFLOP on the same bytes: bound by operations, 1.25 ms at 989 TFLOP/s.
//
// Design.
// * The n axis (the reduction axis of the down-projection) is split
//   across blocks: the grid is (m tiles, E tiles, n splits x batch) —
//   one E tile of the whole H for the flat class, H/bh of them for the
//   deep class — and each split is a run of `per` whole bn blocks.  So
//   at decode some 128 blocks each stream their own slice of the
//   weights, once, where the unsplit grid had 8 blocks re-reading all
//   of Wg and Wu.  The split count is `perf_model.mlp_splits`, the rule
//   the tuner prices; the wrapper never takes one from the caller.
// * A block computes the hidden tiles of its split once, over all of
//   K, into shared memory, then multiplies them into Wd's rows for its
//   n range one E chunk of 256 columns at a time (accumulators in
//   registers, no E row on chip) and writes its f32 partial E to a
//   workspace the wrapper allocates.  `mlp_merge_kernel` sums the
//   partials in split order and casts once: no atomics, so two runs of
//   one call are bitwise equal.  With one split the block writes E.
// * bf16 (`mlp_mma_kernel`): both products on `mma.sync.m16n8k16` (bf16
//   in, f32 accumulate), operands through `ldmatrix` (the weights,
//   row-major (k, n), through `ldmatrix.trans`).  A ring of 16-byte
//   `cp.async` copies — 3 to 8 stages, as many as keep 64 KB in flight
//   — stages the A, Wu and Wg k-tiles, then the Wd tiles of the
//   down-projection.  The up-projection's
//   accumulators stay in registers (a warp owns 16-column groups for
//   all rows), act x gate and the rounding to bf16 happen there, and
//   the hidden tile goes to shared memory once, as the A operand of the
//   down-projection, whose warps own 32 columns of an E chunk of 256
//   for all rows and store two neighbouring E columns at once (an E
//   tile narrower than a chunk shares each live 32-column slice among
//   several warps, each taking some of the row groups).  Rows
//   past M, columns past N and the padding of
//   bm, bn and bk to whole 16s are zero-filled.  Rows are padded by 16
//   bytes so that `ldmatrix` is free of bank conflicts.
// * f32 types (f32 A with f32 or bf16 weights — the stitched-ln2 case
//   — and bf16 A with f32 weights; `mlp_f32_kernel`) keep CUDA-core
//   arithmetic, because f32 parity allows no TF32, on the same split
//   grid: A, Wu and Wg tiles staged with 16-byte loads, a thread owns a
//   column of the up-projection for 8 rows, Wd streamed per thread for
//   a (column, 8 rows) pair, the f32 E tile in shared memory.
// Shared memory is exactly `mlp_smem_bytes` in core/perf_model.py, and
// the bf16 kernel's tile rule `mlp_tiles_ok`; Rule 4 of the tuner and
// the Python wrapper both check them.
//
// What this leaves: `wgmma` and TMA (the warpgroup product is the only
// way to the full tensor-core rate, which the compute-bound M = 4096
// would need; at decode the kernel is bound by bytes and the lever is
// the split); warp specialisation, since one block an SM overlaps its
// copies with its products only through the ring; and the partial E a
// split costs (splits x M x H x 8 bytes, written and merged): at
// prefill (M = 144) it is as large as the weights it splits, which a
// cluster reduction in distributed shared memory would keep on chip.
//
// The machine (both kernels, the merge and the launch) lives in
// chain_mma.cuh, which gemm_chain.cu shares for the GEMM chains.

#include "chain_mma.cuh"

extern "C" {

// a_dtype / w_dtype: 0 = float32, 1 = bfloat16 (E takes a's type);
// act: 0 = silu, 1 = gelu (tanh form), 2 = relu; be: the E tile width
// (bh for the deep class, H for the flat class); the n axis in `splits`
// runs of `per` bn blocks, whose f32 partial E go to `part` (splits, B,
// M, H) and are merged into e (part unused with one split); stages, dr:
// the bf16 kernel's ring, perf_model.mlp_ring (unused by the f32
// kernel); pro, epi: the prologue on A and the epilogue on E
// (chain_mma.cuh; n = 0: none).  Returns
// cudaGetLastError() after the launches (0 on success); the caller
// validated every shape, tile, the split and the shared-memory size.
int mlp_chain_launch(int a_dtype, int w_dtype, int gated, int act,
                     const void* a, const void* wu, const void* wg,
                     const void* wd, void* e, void* part, int batch, int m,
                     int n, int k, int h, int bm, int bn, int bk, int be,
                     int splits, int per, int stages, int dr,
                     long long smem_bytes, void* stream, Hook pro,
                     Hook epi) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (act < kSilu || act > kRelu ||
      machine_args_bad(batch, h, be, splits, per, stages, dr, part))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  if (a_dtype == 0 && w_dtype == 0)
    return launch_gated<float, float>(gated, a, wu, wg, wd, e, p, batch, m,
                                      n, k, h, bm, bn, bk, be, splits, per,
                                      stages, dr, act, smem, s, pro, epi);
  if (a_dtype == 0 && w_dtype == 1)
    return launch_gated<float, bf16>(gated, a, wu, wg, wd, e, p, batch, m,
                                     n, k, h, bm, bn, bk, be, splits, per,
                                     stages, dr, act, smem, s, pro, epi);
  if (a_dtype == 1 && w_dtype == 0)
    return launch_gated<bf16, float>(gated, a, wu, wg, wd, e, p, batch, m,
                                     n, k, h, bm, bn, bk, be, splits, per,
                                     stages, dr, act, smem, s, pro, epi);
  if (a_dtype == 1 && w_dtype == 1)
    return launch_gated<bf16, bf16>(gated, a, wu, wg, wd, e, p, batch, m, n,
                                    k, h, bm, bn, bk, be, splits, per, stages,
                                    dr, act, smem, s, pro, epi);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
