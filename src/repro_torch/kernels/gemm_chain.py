"""The fused (gated) MLP chain: the CUDA kernel ``fused_mlp_chain``
(``csrc/mlp_chain.cu``) and its plain PyTorch version.

    E = (act(A Wg) * (A Wu)) Wd        (gated, ``wg`` given)
    E = act(A Wu) Wd                   (ungated)

computed in one kernel, so the d_ff-wide hidden block never reaches
device memory.  The schedule class and tiles (style, bm, bn, bk, bh)
come from MCFuser's analytical search (``core.api.fuse_mlp_chain``):
``deep`` launches one block per (m tile, bh-wide E tile) and recomputes
the up-projection for each; ``flat`` launches one block per m tile and
keeps the whole E row on chip.

A CUDA tensor launches the kernel or raises; only a CPU tensor runs the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.perf_model import H100, mlp_smem_bytes

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
    clamped tiles (bm, bn, bk, be) and their shared-memory bytes."""
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
    if min(bm, bn, bk, bh) < 1:
        raise ValueError(f"tiles must be positive: {(bm, bn, bk, bh)}")
    tiles = clamp_tiles(m, n, k, h, bm, bn, bk, bh, style)
    smem = mlp_smem_bytes(*tiles, a.element_size(), wu.element_size(),
                          wg is not None)
    if smem > H100.smem_per_block:
        raise ValueError(f"tiles (bm, bn, bk, E tile) = {tiles} "
                         f"({style}) need {smem} B of shared memory per "
                         f"block > {H100.smem_per_block}")
    return tiles, smem


def fused_mlp_chain(a: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                    wg: Optional[torch.Tensor] = None, act: str = "silu",
                    bm: int = 16, bn: int = 128, bk: int = 32,
                    bh: int = 128, style: str = "deep") -> torch.Tensor:
    """E = (act(A Wg) * (A Wu)) Wd fused (``wg=None``: act(A Wu) Wd).

    a: (B, M, K) float32 or bfloat16; wu/wg: (B, K, N), wd: (B, N, H),
    float32 or bfloat16 (one type).  Returns E (B, M, H) in a's type.
    Both up-projections accumulate in f32, the hidden block rounds to
    the promoted weight type and E accumulates in f32 over the n blocks.
    """
    (bm, bn, bk, be), smem = _check(a, wu, wd, wg, act, bm, bn, bk, bh,
                                    style)
    dev = a.device
    if dev.type == "cpu":
        return fused_mlp_chain_plain(a, wu, wd, wg, act, bn)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch(a, wu, wd, wg, act, bm, bn, bk, be, smem)


fused_mlp_chain.launches = 0


def _launch(a, wu, wd, wg, act, bm, bn, bk, be, smem):
    from . import _build

    lib = _build.load("mlp_chain")
    fn = lib.mlp_chain_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 9 + [ctypes.c_longlong,
                                           ctypes.c_void_p])
    b, m, k = a.shape
    n, h = wu.shape[2], wd.shape[2]
    e = torch.empty((b, m, h), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(_DTYPE_CODES[a.dtype], _DTYPE_CODES[wu.dtype],
             int(wg is not None), _ACT_CODES[act], a.data_ptr(),
             wu.data_ptr(), (wu if wg is None else wg).data_ptr(),
             wd.data_ptr(), e.data_ptr(), b, m, n, k, h, bm, bn, bk, be,
             int(smem), stream)
    if err:
        lib.mlp_error_string.restype = ctypes.c_char_p
        lib.mlp_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError("mlp_chain_launch failed: "
                           + lib.mlp_error_string(err).decode())
    fused_mlp_chain.launches += 1
    return e


def fused_mlp_chain_plain(a: torch.Tensor, wu: torch.Tensor,
                          wd: torch.Tensor, wg: Optional[torch.Tensor],
                          act: str, bn: int) -> torch.Tensor:
    """The kernel's plain PyTorch version, with its rounding points:
    f32 up-projections per n block of ``bn``, the hidden block rounded
    to the promoted weight type, E summed in f32 over the n blocks and
    cast once to a's type.  One f32 product per n block (not per k
    tile), so a full-width call on the card takes milliseconds."""
    f = act_fn(act)
    hidden_t = torch.promote_types(a.dtype, wu.dtype)
    n = wu.shape[2]
    af = a.float()
    e = torch.zeros(a.shape[0], a.shape[1], wd.shape[2],
                    dtype=torch.float32, device=a.device)
    for n0 in range(0, n, bn):
        u = torch.bmm(af, wu[:, :, n0:n0 + bn].float())
        hid = (f(u) if wg is None
               else f(torch.bmm(af, wg[:, :, n0:n0 + bn].float())) * u)
        e += torch.bmm(hid.to(hidden_t).float(),
                       wd[:, n0:n0 + bn].float())
    return e.to(a.dtype)

