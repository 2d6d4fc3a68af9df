"""The fused GEMM chains of the MLP and the paper's Table II: the CUDA
kernels ``fused_mlp_chain`` (``csrc/mlp_chain.cu``) and
``fused_gemm_chain`` (``csrc/gemm_chain.cu``), one machine in
``csrc/chain_mma.cuh``, with their plain PyTorch versions.

    E = (act(A Wg) * (A Wu)) Wd        fused_mlp_chain, gated
    E = act(A Wu) Wd                   fused_mlp_chain, ungated
    E = (A B) D                        fused_gemm_chain

each computed in one kernel, so the intermediate block never reaches
device memory.  The schedule class and tiles (style, bm, bn, bk, bh)
come from MCFuser's analytical search (``core.api.fuse_mlp_chain`` /
``fuse_gemm_chain``): ``deep`` launches one block per (m tile, bh-wide
E tile) and recomputes the first product for each; ``flat`` launches
one block per m tile for the whole E row.  Both kernels also split the
n axis across blocks (``perf_model.mlp_splits``, the rule the tuner
prices; the GEMM chain is the machine's ungated case with the identity
activation) and merge the splits' f32 partial E in split order.

A CUDA tensor launches the kernel or raises; only a CPU tensor runs the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.perf_model import (H100, mlp_hidden_bytes, mlp_ring,
                               mlp_smem_bytes, mlp_splits, mlp_tiles_ok)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2}
STYLES = ("deep", "flat")


def act_fn(name: str):
    """The activation as the JAX package defines it (``jax.nn.gelu``
    defaults to the tanh form, torch's ``F.gelu`` to erf)."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}; expected one of "
                     f"{sorted(_ACT_CODES)}")


def clamp_tiles(m: int, n: int, k: int, h: int, bm: int, bn: int, bk: int,
                bh: int, style: str) -> tuple[int, int, int, int]:
    """Tiles no larger than the dims; the flat class keeps the whole E
    row, so its E tile is H.  Tiles need not divide the dims: the
    kernel masks the ragged edges."""
    be = h if style == "flat" else min(bh, h)
    return min(bm, m), min(bn, n), min(bk, k), be


def _check(a, wu, wd, wg, act, bm, bn, bk, bh, style):
    """Raise on anything the CUDA kernel does not take; returns the
    clamped tiles (bm, bn, bk, be), the split (splits, n blocks per
    split) from ``mlp_splits``; raises past a block's shared memory."""
    if style not in STYLES:
        raise ValueError(f"unknown style {style!r}; expected {STYLES}")
    act_fn(act)
    if a.ndim != 3 or wu.ndim != 3 or wd.ndim != 3:
        raise ValueError("a, wu and wd must be (B, M, K), (B, K, N) and "
                         "(B, N, H)")
    b, m, k = a.shape
    n, h = wu.shape[2], wd.shape[2]
    if wu.shape != (b, k, n) or wd.shape != (b, n, h) or (
            wg is not None and wg.shape != wu.shape):
        raise ValueError(
            f"a {tuple(a.shape)}, wu {tuple(wu.shape)}, wd "
            f"{tuple(wd.shape)}"
            + ("" if wg is None else f", wg {tuple(wg.shape)}")
            + " do not chain")
    ws = (wu, wd) if wg is None else (wu, wd, wg)
    if a.dtype not in _DTYPE_CODES or wu.dtype not in _DTYPE_CODES or any(
            w.dtype != wu.dtype for w in ws):
        raise TypeError(f"a and the weights must be float32 or bfloat16, "
                        f"the weights of one type; got {a.dtype} / "
                        f"{[w.dtype for w in ws]}")
    if not all(t.is_contiguous() for t in (a, *ws)):
        raise ValueError("a and the weights must be contiguous")
    devices = {t.device for t in (a, *ws)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    if min(bm, bn, bk, bh) < 1 or 0 in (m, n, k, h):
        raise ValueError(f"tiles and dims must be positive: tiles "
                         f"{(bm, bn, bk, bh)}, dims {(m, n, k, h)}")
    tiles = clamp_tiles(m, n, k, h, bm, bn, bk, bh, style)
    split, _ = _machine_split(b, m, n, k, h, tiles, a.element_size(),
                              wu.element_size(), wg is not None, style,
                              False)
    return tiles, split


def check_tile_rule(bm: int, bn: int, n: int, a_bytes: int,
                    w_bytes: int) -> None:
    """Raise on clamped tiles outside ``perf_model.mlp_tiles_ok``, the
    tile rule of the machine's bf16 tensor-core kernels."""
    if not mlp_tiles_ok(bm, bn, n, a_bytes, w_bytes):
        raise ValueError(f"tiles (bm, bn) = {(bm, bn)} are not tiles of "
                         f"the bf16 kernel (bm <= 144 with bn <= 128, or "
                         f"bm <= 64 with bn <= 256; bn a multiple of 16 "
                         f"or all of N={n})")


def _machine_split(b, m, n, k, h, tiles, a_bytes, w_bytes, gated, style,
                   squeeze):
    """The split (splits, n blocks per split) ``mlp_splits`` gives the
    MLP machine at clamped ``tiles`` (bm, bn, bk, E tile), and its
    shared memory (``squeeze``: the GEMM chain's ring, which gives up
    stages to fit); raises on a tile outside the bf16 tile rule or past
    a block's shared memory."""
    check_tile_rule(tiles[0], tiles[1], n, a_bytes, w_bytes)
    split = mlp_splits(b, m, n, k, h, *tiles, a_bytes, w_bytes, gated,
                       squeeze=squeeze)
    smem = mlp_smem_bytes(*tiles, a_bytes, w_bytes, gated, split[1],
                          squeeze)
    if smem > H100.smem_per_block:
        raise ValueError(f"tiles (bm, bn, bk, E tile) = {tiles} "
                         f"({style}) need {smem} B of shared memory per "
                         f"block > {H100.smem_per_block}")
    return split, smem


def fused_mlp_chain(a: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                    wg: Optional[torch.Tensor] = None, act: str = "silu",
                    bm: int = 16, bn: int = 128, bk: int = 32,
                    bh: int = 128, style: str = "deep") -> torch.Tensor:
    """E = (act(A Wg) * (A Wu)) Wd fused (``wg=None``: act(A Wu) Wd).

    a: (B, M, K) float32 or bfloat16; wu/wg: (B, K, N), wd: (B, N, H),
    float32 or bfloat16 (one type).  Returns E (B, M, H) in a's type.
    Both up-projections accumulate in f32, the hidden block rounds to
    the promoted weight type and E accumulates in f32 over the n blocks.
    The n axis is cut into the splits ``perf_model.mlp_splits`` gives at
    these tiles; each split's f32 partial E is summed in split order and
    cast once (the plain version on a CPU tensor takes the same split).
    """
    (bm, bn, bk, be), (splits, _) = _check(a, wu, wd, wg, act, bm, bn, bk,
                                           bh, style)
    dev = a.device
    if dev.type == "cpu":
        return fused_mlp_chain_plain(a, wu, wd, wg, act, bn, splits)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch(a, wu, wd, wg, act, bm, bn, bk, be, splits)


fused_mlp_chain.launches = 0


def _machine_launch(a, wu, wd, gated, bm, bn, bk, be, splits, squeeze):
    """What one launch of the MLP machine needs beside its operands, on
    clamped tiles with the n blocks cut into ``splits`` runs as the
    plain versions cut them (``squeeze``: the GEMM chain's ring, which
    gives up stages to fit): (E, the splits' f32 partial E or None,
    (b, m, n, k, h, bm, bn, bk, be, splits, per, stages, Wd rows a
    ring stage), shared memory, the stream)."""
    b, m, k = a.shape
    n, h = wu.shape[2], wd.shape[2]
    per = -(-(-(-n // bn)) // splits)
    splits = -(-(-(-n // bn)) // per)
    smem = mlp_smem_bytes(bm, bn, bk, be, a.element_size(),
                          wu.element_size(), gated, per, squeeze)
    if smem > H100.smem_per_block:
        raise ValueError(f"{splits} splits of {per} n blocks need {smem} B "
                         f"of shared memory per block")
    stages, _, wd_rows = mlp_ring(
        bm, bn, bk, gated, mlp_hidden_bytes(bm, bn) if squeeze else None)
    e = torch.empty((b, m, h), dtype=a.dtype, device=a.device)
    # the splits' f32 partial E, summed in split order by the merge
    part = (torch.empty((splits, b, m, h), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    dims = (b, m, n, k, h, bm, bn, bk, be, splits, per, stages, wd_rows)
    return e, part, dims, int(smem), stream


def _launch(a, wu, wd, wg, act, bm, bn, bk, be, splits=1):
    """Launch the kernel (and, with more than one split, the merge) on
    clamped tiles, with the n blocks cut into ``splits`` runs as the
    plain version cuts them."""
    from . import _build

    lib = _build.load("mlp_chain")
    fn = lib.mlp_chain_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 13 + [ctypes.c_longlong,
                                            ctypes.c_void_p])
    e, part, dims, smem, stream = _machine_launch(
        a, wu, wd, wg is not None, bm, bn, bk, be, splits, False)
    err = fn(_DTYPE_CODES[a.dtype], _DTYPE_CODES[wu.dtype],
             int(wg is not None), _ACT_CODES[act], a.data_ptr(),
             wu.data_ptr(), (wu if wg is None else wg).data_ptr(),
             wd.data_ptr(), e.data_ptr(),
             None if part is None else part.data_ptr(), *dims, smem, stream)
    _build.check_launch(lib, "mlp_chain_launch", err, "mlp_error_string")
    fused_mlp_chain.launches += 1
    return e


def fused_mlp_chain_plain(a: torch.Tensor, wu: torch.Tensor,
                          wd: torch.Tensor, wg: Optional[torch.Tensor],
                          act: str, bn: int, splits: int = 1) -> torch.Tensor:
    """The kernel's plain PyTorch version, with its rounding points:
    f32 up-projections per n block of ``bn``, the hidden block rounded
    to the promoted weight type, E summed in f32 over the n blocks and
    cast once to a's type.  With ``splits`` > 1 the n blocks are cut
    into that many runs of equal length (the last may be shorter), as
    the kernel cuts them: each run's f32 partial E is summed over its
    blocks from zero, and the partials in split order.  One f32 product
    per n block (not per k tile), so a full-width call on the card takes
    milliseconds."""
    return _chain_plain(a, wu, wd, wg, act_fn(act), bn, splits)


def _chain_plain(a, wu, wd, wg, f, bn: int, splits: int) -> torch.Tensor:
    """The plain MLP machine with the activation ``f``: what
    ``fused_mlp_chain_plain`` describes."""
    hidden_t = torch.promote_types(a.dtype, wu.dtype)
    n = wu.shape[2]
    step = -(-(-(-n // bn)) // splits) * bn
    af = a.float()
    e = None
    for s0 in range(0, n, step):
        part = torch.zeros(a.shape[0], a.shape[1], wd.shape[2],
                           dtype=torch.float32, device=a.device)
        for n0 in range(s0, min(n, s0 + step), bn):
            u = torch.bmm(af, wu[:, :, n0:n0 + bn].float())
            hid = (f(u) if wg is None
                   else f(torch.bmm(af, wg[:, :, n0:n0 + bn].float())) * u)
            part += torch.bmm(hid.to(hidden_t).float(),
                              wd[:, n0:n0 + bn].float())
        e = part if e is None else e + part
    return e.to(a.dtype)


def _check_chain(tensors, bm: int, bn: int, bk: int) -> tuple:
    """Raise on a gemm chain the CUDA kernels do not take: ``tensors``
    (A, B, D[, F]) must chain as (B, M, K), (B, K, N), (B, N, H)[,
    (B, H, G)], share float32 or bfloat16, be contiguous and on one
    device.  Returns the (bm, bn, bk) tiles clamped to the dims, which
    must then divide them, as the JAX kernels assert."""
    if any(t.ndim != 3 for t in tensors):
        raise ValueError("the chain's operands must be 3-D (batch first)")
    a = tensors[0]
    bsz, m, k = a.shape
    want, rows = [], k
    for t in tensors[1:]:
        want.append((bsz, rows, t.shape[2]))
        rows = t.shape[2]
    got = [tuple(t.shape) for t in tensors[1:]]
    if got != want:
        raise ValueError(f"operands {[tuple(a.shape)] + got} do not chain")
    if a.dtype not in _DTYPE_CODES or any(t.dtype != a.dtype
                                          for t in tensors):
        raise TypeError(f"the operands must share float32 or bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the operands must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    n = tensors[1].shape[2]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(f"tiles (bm, bn, bk) = {(bm, bn, bk)} must divide "
                         f"(M, N, K) = {(m, n, k)}")
    return bm, bn, bk


def check_gemm_chain(a, b, d, bm: int, bn: int, bk: int, bh: int,
                     style: str) -> tuple:
    """Raise on anything ``fused_gemm_chain``'s kernel does not take;
    returns the clamped tiles (bm, bn, bk, E tile), the n split
    (splits, n blocks per split) ``perf_model.mlp_splits`` gives them,
    ungated with the squeezed ring, and their shared-memory bytes.
    Reads only shapes, types and devices."""
    if style not in STYLES:
        raise ValueError(f"unknown style {style!r}; expected {STYLES}")
    bm, bn, bk = _check_chain((a, b, d), bm, bn, bk)
    bsz, m, k = a.shape
    n, h = b.shape[2], d.shape[2]
    bh = min(bh, h)
    if bh < 1 or h % bh:
        raise ValueError(f"tile bh={bh} must divide H={h}")
    tiles = (bm, bn, bk, h if style == "flat" else bh)
    split, smem = _machine_split(bsz, m, n, k, h, tiles, a.element_size(),
                                 a.element_size(), False, style, True)
    return tiles, split, smem


def fused_gemm_chain(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
                     bm: int = 128, bn: int = 128, bk: int = 128,
                     bh: int = 128, style: str = "flat") -> torch.Tensor:
    """E = (A B) D fused.  a: (B, M, K), b: (B, K, N), d: (B, N, H), one
    type, float32 or bfloat16; returns E (B, M, H) in a's type.

    ``style="flat"`` keeps the whole (bm, H) E row on chip (schedule
    class ``n(k,h)``; ``bh`` is only checked); ``"deep"`` launches one
    block per (m tile, bh-wide E tile) and recomputes C for each (class
    ``nk``).  Tiles are clamped to the dims and must then divide them.
    C accumulates in f32 over k and is rounded to d's type before C D;
    E accumulates in f32 over the n blocks.  The n axis is cut into the
    splits ``perf_model.mlp_splits`` gives at these tiles; each split's
    f32 partial E is summed in split order and cast once (the plain
    version on a CPU tensor takes the same split)."""
    (bm, bn, bk, be), (splits, _), _ = check_gemm_chain(a, b, d, bm, bn,
                                                        bk, bh, style)
    dev = a.device
    if dev.type == "cpu":
        return fused_gemm_chain_plain(a, b, d, bn, splits)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch_chain(a, b, d, bm, bn, bk, be, splits)


fused_gemm_chain.launches = 0


def _launch_chain(a, b, d, bm, bn, bk, be, splits=1):
    """Launch the MLP machine with the identity activation, ungated (and,
    with more than one split, the merge) on clamped tiles, with the n
    blocks cut into ``splits`` runs as the plain version cuts them; one
    count a call."""
    from . import _build

    lib = _build.load("gemm_chain")
    fn = lib.gemm_chain_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 13 + [ctypes.c_longlong,
                                            ctypes.c_void_p])
    e, part, dims, smem, stream = _machine_launch(a, b, d, False, bm, bn,
                                                  bk, be, splits, True)
    err = fn(_DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
             d.data_ptr(), e.data_ptr(),
             None if part is None else part.data_ptr(), *dims, smem, stream)
    _build.check_launch(lib, "gemm_chain_launch", err, "chain_error_string")
    fused_gemm_chain.launches += 1
    return e


def fused_gemm_chain_plain(a: torch.Tensor, b: torch.Tensor,
                           d: torch.Tensor, bn: int,
                           splits: int = 1) -> torch.Tensor:
    """``fused_gemm_chain``'s plain PyTorch version, with its rounding
    points: C per n block of ``bn`` in f32 (one product over the whole
    k, not per k tile), rounded to d's type, E summed in f32 over the n
    blocks and cast once to a's type.  With ``splits`` > 1 the n blocks
    are cut into that many runs as the kernel cuts them, each run's f32
    partial E summed from zero and the partials in split order."""
    return _chain_plain(a, b, d, None, lambda x: x, bn, splits)
