"""Operations and bytes of the served work, counted from shapes, and the
card's published peaks.

Nothing here asks the program: each count is what the data of a run
needs (live query rows and keys, real prompt tokens, the experts a
token is routed to), in the configuration's own type, each input byte
read once and each output byte written once.  Norms, rope, softmax and
the residual adds are elementwise and left out of the FLOP counts.
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


def _dims(m: dict) -> tuple:
    dh = m.get("head_dim") or m["d_model"] // m["n_heads"]
    return m["d_model"], m["n_heads"], m["n_kv_heads"], dh


def proj_flops(m: dict) -> float:
    """One token's q/k/v and output projections in one layer."""
    d, hq, hkv, dh = _dims(m)
    return 2.0 * d * (hq * dh + 2 * hkv * dh) + 2.0 * hq * dh * d


def ffn_flops(m: dict) -> float:
    """One token's feed-forward in one layer: the gated MLP, or the
    router and the ``top_k`` experts it is routed to."""
    d, f = m["d_model"], m["d_ff"]
    mats = 3 if m.get("act", "swiglu") in ("swiglu", "geglu") else 2
    moe = m.get("moe")
    if moe is None:
        return 2.0 * mats * d * f
    return 2.0 * d * moe["n_experts"] + moe["top_k"] * 2.0 * mats * d * f


def attn_core_flops(m: dict, keys: float) -> float:
    """Scores and the weighted sum of one query row over ``keys`` keys
    in one layer."""
    _, hq, _, dh = _dims(m)
    return 4.0 * hq * dh * keys


def lm_head_flops(m: dict) -> float:
    return 2.0 * m["d_model"] * m["vocab"]


def prefill_flops(m: dict, length: int) -> float:
    """A prompt of ``length`` real tokens: every token through every
    layer, causal attention over its live pairs (row i reads i + 1
    keys), and the logits of the last token."""
    pairs = length * (length + 1) / 2
    per_layer = length * (proj_flops(m) + ffn_flops(m)) \
        + attn_core_flops(m, pairs)
    return m["n_layers"] * per_layer + lm_head_flops(m)


def decode_flops(m: dict, keys: int) -> float:
    """One decoded token whose query reads ``keys`` keys (its position
    plus one) in every layer, and its logits."""
    per_layer = proj_flops(m) + ffn_flops(m) + attn_core_flops(m, keys)
    return m["n_layers"] * per_layer + lm_head_flops(m)


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
    _, hq, hkv, dh = _dims(m)
    it = ITEMSIZE[m.get("dtype", "bfloat16")]
    total = float(sum(keys))
    flops = attn_core_flops(m, total)
    nbytes = (2 * hkv * dh * total + 2 * len(keys) * hq * dh) * it
    return flops, nbytes
