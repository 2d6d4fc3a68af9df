// The stitching hooks of the fused kernels: a tile-local elementwise
// expression from a closed vocabulary, interpreted step by step in f32
// (kernels/hooks.py `Elementwise`, which builds this struct and computes
// the same steps in torch for the plain versions).
//
// The JAX package's kernels take any traced callable as a hook
// (src/repro/kernels/gemm_chain.py `_chain_kernel`, attention.py
// `_attn_kernel`); a CUDA kernel takes this struct by value instead, so
// one compiled kernel serves every hook.  Each kernel is instantiated
// twice, with and without hooks (a `HOOKED` template flag the launcher
// picks from the structs): a launch without a hook runs the code the
// kernel had before the hooks, register allocation included, and the
// hooked instantiations call the steps' code out of line (`hook_steps`,
// `hook_tile`: compiled once a source; inlined into every instantiation
// it doubled the sources' build time).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct Hook {
  int n;       // steps, 0 .. 8; 0 = no hook
  int op[8];   // HookOp codes
  float c[8];  // the constant of mul / add / max / min
};

// OPS of kernels/hooks.py
enum HookOp {
  kHookMul = 0,
  kHookAdd = 1,
  kHookMax = 2,
  kHookMin = 3,
  kHookTanh = 4,
  kHookSigmoid = 5,
  kHookExp = 6,
  kHookSquare = 7,
  kHookRelu = 8,
  kHookSilu = 9,
  kHookGelu = 10,
};

__device__ __forceinline__ float hook_op(int op, float c, float x) {
  switch (op) {
    case kHookMul: return x * c;
    case kHookAdd: return x + c;
    case kHookMax: return fmaxf(x, c);
    case kHookMin: return fminf(x, c);
    case kHookTanh: return tanhf(x);
    case kHookSigmoid: return 1.f / (1.f + expf(-x));
    case kHookExp: return expf(x);
    case kHookSquare: return x * x;
    case kHookRelu: return fmaxf(x, 0.f);
    case kHookSilu: return x * (1.f / (1.f + expf(-x)));
    case kHookGelu: {
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return x * (0.5f * (1.f + tanhf(k * (x + 0.044715f * (x * x * x)))));
    }
    default: return x;
  }
}

// every step of *h on x, in f32
__device__ __noinline__ float hook_steps(const Hook* h, float x) {
  const int n = h->n;
  for (int i = 0; i < n; ++i) x = hook_op(h->op[i], h->c[i], x);
  return x;
}

// the hook on one value (hooked instantiations only)
__device__ __forceinline__ float apply_hook(const Hook& h, float x) {
  return h.n ? hook_steps(&h, x) : x;
}

__device__ __forceinline__ float hook_load(float x) { return x; }
__device__ __forceinline__ float hook_load(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void hook_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void hook_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

// *h on the (rows, cols) tile at p (row stride ld) in shared memory, in
// place, each element rounded back to its type; every thread of the
// block calls it, and the caller synchronises after
template <typename T>
__device__ __noinline__ void hook_tile(const Hook* h, T* p, int ld,
                                       int rows, int cols) {
  const Hook s = *h;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    T* e = p + r * ld + (i - r * cols);
    float x = hook_load(*e);
    for (int j = 0; j < s.n; ++j) x = hook_op(s.op[j], s.c[j], x);
    hook_store(e, x);
  }
}
