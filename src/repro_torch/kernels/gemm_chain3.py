"""The fused three-GEMM chain G = ((A B) D) F: the CUDA kernel
``fused_gemm_chain3`` (``csrc/gemm_chain.cu``) and its plain PyTorch
version.

In bf16 the MLP machine of ``fused_gemm_chain`` (``csrc/chain_mma.cuh``)
on tensor cores, one block per (m tile, batch) and no n split: C of all
of N on chip, then the whole (bm, H) E row, rounded to F's type, then
G = E F written once.  In f32 a CUDA-core kernel with the same rounding
points.  Neither C nor E reaches device memory.  The JAX kernel's
stitching hooks run inside: ``prologue`` on A at load, ``epilogue`` on
the f32 G before its cast (``hooks.Elementwise`` expressions).

A CUDA tensor launches the kernel or raises; only a CPU tensor runs the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.perf_model import (H100, gemm_chain3_ring,
                               gemm_chain3_smem_bytes)
from . import hooks
from .gemm_chain import (_DTYPE_CODES, _check_chain, check_tile_rule,
                         fused_gemm_chain_plain)


def fused_gemm_chain3(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
                      f: torch.Tensor, bm: int = 128, bn: int = 128,
                      bk: int = 128,
                      prologue: Optional[hooks.Elementwise] = None,
                      epilogue: Optional[hooks.Elementwise] = None
                      ) -> torch.Tensor:
    """G = ((A B) D) F fused.  a: (B, M, K), b: (B, K, N), d: (B, N, H),
    f: (B, H, G), one type, float32 or bfloat16; returns G (B, M, G) in
    a's type.  H and G stay whole; the tiles are clamped to the dims
    and must then divide them, and in bf16 lie inside the tile rule of
    the tensor-core machine (``perf_model.mlp_tiles_ok``).  ``prologue``
    runs on A, ``epilogue`` on G."""
    pro = hooks.check(prologue, "prologue")
    epi = hooks.check(epilogue, "epilogue")
    bm, bn, bk = _check_chain((a, b, d, f), bm, bn, bk)
    n, h = b.shape[2], d.shape[2]
    nbytes = a.element_size()
    check_tile_rule(bm, bn, n, nbytes, nbytes)
    smem = gemm_chain3_smem_bytes(bm, bn, bk, n, h, nbytes)
    if smem > H100.smem_per_block:
        raise ValueError(f"tiles (bm, bn, bk) = {(bm, bn, bk)} with H={h} "
                         f"need {smem} B of shared memory per block > "
                         f"{H100.smem_per_block}")
    dev = a.device
    if dev.type == "cpu":
        return fused_gemm_chain3_plain(a, b, d, f, bn, pro, epi)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch(a, b, d, f, bm, bn, bk, smem, pro, epi)


def _launch(a, b, d, f, bm, bn, bk, smem, pro=None, epi=None):
    from . import _build

    lib = _build.load("gemm_chain")
    fn = lib.gemm_chain3_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 11 + [ctypes.c_longlong,
                                            ctypes.c_void_p]
                   + [hooks.HookStruct] * 2)
    bsz, m, k = a.shape
    n, h, g = b.shape[2], d.shape[2], f.shape[2]
    stages, _, rows = gemm_chain3_ring(bm, bn, bk, n, h)
    out = torch.empty((bsz, m, g), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(_DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
             d.data_ptr(), f.data_ptr(), out.data_ptr(), bsz, m, n, k, h, g,
             bm, bn, bk, stages, rows, int(smem), stream, hooks.as_c(pro),
             hooks.as_c(epi))
    _build.check_launch(lib, "gemm_chain3_launch", err, "chain_error_string")
    fused_gemm_chain3.launches += 1
    hooks.note(fused_gemm_chain3, pro, epi)
    return out


fused_gemm_chain3.launches = 0
fused_gemm_chain3.hooked = {}


def fused_gemm_chain3_plain(a: torch.Tensor, b: torch.Tensor,
                            d: torch.Tensor, f: torch.Tensor, bn: int,
                            prologue: Optional[hooks.Elementwise] = None,
                            epilogue: Optional[hooks.Elementwise] = None
                            ) -> torch.Tensor:
    """``fused_gemm_chain3``'s plain PyTorch version: E as
    ``fused_gemm_chain_plain`` computes it (C rounded to d's type per n
    block of ``bn``, E summed in f32) from the prologue of A, rounded to
    f's type, times F in f32, the epilogue on that f32 G, cast to a's
    type."""
    e = fused_gemm_chain_plain(hooks.apply(prologue, a), b, d, bn)
    g = torch.bmm(e.to(f.dtype).float(), f.float())
    return hooks.apply(epilogue, g).to(a.dtype)
