"""The card's published peaks, and the operations and bytes of one
launch of a kernel, counted from shapes.

Nothing here asks the program: each count is what the data of a run
needs (live query rows and keys, real rows), in the configuration's own
type, each input byte read once and each output byte written once.  The
operations of a whole prefill or decoded token belong to the
architecture (``prefill_flops`` and ``decode_flops`` of its module in
``portbench/reference``).
"""
from __future__ import annotations

#: NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the
#: full 700 W power limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS[dtype]


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)


def mlp_launch(m: dict, rows: int) -> tuple:
    """(flops, bytes) of one fused gated MLP launch over ``rows`` real
    rows: X read, the three weights read, E written."""
    d, f = m["d_model"], m["d_ff"]
    it = ITEMSIZE[m.get("dtype", "bfloat16")]
    flops = 2.0 * 3 * rows * d * f
    nbytes = (3 * d * f + 2 * rows * d) * it
    return flops, nbytes


def attn_decode_launch(m: dict, keys: list) -> tuple:
    """(flops, bytes) of one layer's paged decode attention over the live
    slots, one query row each reading ``keys[i]`` keys: q read, each
    live key's k and v read, o written."""
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    dh = m.get("head_dim") or m["d_model"] // hq
    it = ITEMSIZE[m.get("dtype", "bfloat16")]
    total = float(sum(keys))
    flops = 4.0 * hq * dh * total
    nbytes = (2 * hkv * dh * total + 2 * len(keys) * hq * dh) * it
    return flops, nbytes
