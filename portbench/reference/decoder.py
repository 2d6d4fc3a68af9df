"""The architecture ``decoder``: a decoder-only transformer whose every
layer is rope GQA attention followed by a SwiGLU MLP or a softmax-top-k
mixture of experts.  A configuration file without an ``"architecture"``
key names this one.

Like every module of ``portbench/reference``, it gives the harness all
it knows of the architecture (``harness/spec.architecture`` finds it by
name):

- ``layout(m)``: the weight leaves, in drawing order
  (``harness/weights.make`` draws them);
- ``logits(m, params, seqs, rows, fp8=False)``: the plain reference,
  float32 throughout (TF32 off), computed a layer at a time over every
  sequence it is given, and with ``fp8=True`` the control;
- ``prefill_flops(m, length)`` and ``decode_flops(m, keys)``: the
  operations of the served work, counted from shapes as
  ``harness/cost`` counts a kernel's;
- ``attention_layers(m)``: how many layers' attention reads the paged
  KV cache.

It follows the configuration file's ``model`` as the two sources
describe their architectures, with the departures the files state:

- Qwen3 (dense): pre-norm blocks of GQA attention and a SwiGLU MLP;
  q and k are RMS-normalised per head, then rotated (rope, the
  half-split form, base ``rope_theta``); the unembedding is untied.
- OLMoE (mixture of experts): the same attention block (per-head q/k
  norm: a stated departure), then token-choice routing: a softmax over
  the router's logits, the ``top_k`` experts of highest probability
  (the lower index first among equals), their probabilities
  renormalised to sum to one (a stated departure), each expert a
  SwiGLU MLP.  No assignment is dropped.
- Every rmsnorm scales by ``1 + w``: a parametrisation of the weight,
  not a change of the function.

It reads only the weights the benchmark made, and the prompts and the
served tokens it is asked to judge; it imports nothing of the program.
``fp8=True`` is the control: every weight product's two operands are
rounded to float8 e4m3 (per output column for the weights, per row for
the activations) before a float32 product, as a W8A8 serving path
computes.

Weights (``layout``): the embedding N(0, 1); every input projection
N(0, 1 / fan_in); the attention output and the MLP's down projection
also divided by sqrt(2 * n_layers), so the residual stream stays near
unit size over the depth, as a trained model's does; the unembedding
N(0, 1 / d_model), so logits are of unit size; the router
N(0, 1 / d_model) in float32; each rmsnorm weight w (the scale is
1 + w) N(0, 0.1^2).

Counts: each is what the data of a run needs (live query rows and keys,
real prompt tokens, the experts a token is routed to); norms, rope,
softmax and the residual adds are elementwise and left out.
"""
from __future__ import annotations

import math

import torch

F8_MAX = 448.0


def layout(m: dict) -> list:
    """(path, shape, kind, scale) of every leaf, in drawing order: kind
    "mat" for the served type, "f32" for the float32 leaves."""
    d, v, f = m["d_model"], m["vocab"], m["d_ff"]
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    dh = m.get("head_dim") or d // hq
    out_scale = 1.0 / math.sqrt(2 * m["n_layers"])
    leaves = [(("embed",), (v, d), "mat", 1.0),
              (("lm_head",), (d, v), "mat", 1.0 / math.sqrt(d)),
              (("final_norm", "w"), (d,), "f32", 0.1)]
    for i in range(m["n_layers"]):
        L = ("layers", i)
        leaves += [
            (L + ("ln1", "w"), (d,), "f32", 0.1),
            (L + ("ln2", "w"), (d,), "f32", 0.1),
            (L + ("mix", "wq"), (d, hq * dh), "mat", 1 / math.sqrt(d)),
            (L + ("mix", "wk"), (d, hkv * dh), "mat", 1 / math.sqrt(d)),
            (L + ("mix", "wv"), (d, hkv * dh), "mat", 1 / math.sqrt(d)),
            (L + ("mix", "wo"), (hq * dh, d), "mat",
             out_scale / math.sqrt(hq * dh)),
        ]
        if m.get("qk_norm"):
            leaves += [(L + ("mix", "q_norm"), (dh,), "f32", 0.1),
                       (L + ("mix", "k_norm"), (dh,), "f32", 0.1)]
        moe = m.get("moe")
        e = (moe["n_experts"],) if moe else ()
        if moe:
            leaves.append((L + ("ff", "router"), (d, e[0]), "f32",
                           1 / math.sqrt(d)))
        leaves += [
            (L + ("ff", "w_gate"), e + (d, f), "mat", 1 / math.sqrt(d)),
            (L + ("ff", "w_up"), e + (d, f), "mat", 1 / math.sqrt(d)),
            (L + ("ff", "w_down"), e + (f, d), "mat",
             out_scale / math.sqrt(f)),
        ]
    return leaves


def attention_layers(m: dict) -> int:
    """Every layer's attention reads the paged KV cache."""
    return m["n_layers"]


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


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Mat:
    """Weight products in float32, or through float8 operands."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)
        return _q8(t, -2) if self.fp8 else t

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _q8(x, -1)
        return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, dh); pos: (S,) — the half-split rotation."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, rows: int = 512) -> torch.Tensor:
    """Causal attention of one sequence, q: (S, Hq, dh), k/v: (S, Hkv,
    dh), kv head h // (Hq / Hkv) serving q head h; in blocks of query
    rows."""
    s, hq, dh = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)     # (H, S, dh)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1)
    out = torch.empty_like(qt)
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, rows):
        b = min(s, a + rows)
        sc = (qt[:, a:b] @ k[:, :b].transpose(1, 2)) / math.sqrt(dh)
        mask = keys[None, :b] > torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, a:b] = torch.softmax(sc, dim=-1) @ v[:, :b]
    return out.transpose(0, 1)


def _moe(p: dict, h: torch.Tensor, m: dict, mat: _Mat) -> torch.Tensor:
    moe = m["moe"]
    probs = torch.softmax(h @ p["router"].to(torch.float32), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :moe["top_k"]], topi[:, :moe["top_k"]]
    topw = topw / topw.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(moe["n_experts"]):
        tok, slot = (topi == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = mat(torch.nn.functional.silu(mat(x, mat.w(p["w_gate"][e])))
                * mat(x, mat.w(p["w_up"][e])), mat.w(p["w_down"][e]))
        out.index_add_(0, tok, y * topw[tok, slot][:, None])
    return out


def _layer(p: dict, xs: list, m: dict, mat: _Mat) -> list:
    d, hq, hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    dh = m.get("head_dim") or d // hq
    eps, theta = m["norm_eps"], m["rope_theta"]
    mix = {k: mat.w(p["mix"][k]) for k in ("wq", "wk", "wv", "wo")}
    out = []
    for x in xs:
        s = x.shape[0]
        pos = torch.arange(s, device=x.device)
        h = rmsnorm(x, p["ln1"]["w"], eps)
        q = mat(h, mix["wq"]).reshape(s, hq, dh)
        k = mat(h, mix["wk"]).reshape(s, hkv, dh)
        v = mat(h, mix["wv"]).reshape(s, hkv, dh)
        if m.get("qk_norm"):
            q = rmsnorm(q, p["mix"]["q_norm"], eps)
            k = rmsnorm(k, p["mix"]["k_norm"], eps)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        out.append(x + mat(_attention(q, k, v).reshape(s, hq * dh),
                           mix["wo"]))
    del mix
    rows = torch.cat(out)
    h = rmsnorm(rows, p["ln2"]["w"], eps)
    if m.get("moe"):
        y = _moe(p["ff"], h, m, mat)
    else:
        ff = {k: mat.w(p["ff"][k]) for k in ("w_gate", "w_up", "w_down")}
        y = torch.empty_like(h)
        for a in range(0, h.shape[0], 2048):
            hb = h[a:a + 2048]
            y[a:a + 2048] = mat(torch.nn.functional.silu(
                mat(hb, ff["w_gate"])) * mat(hb, ff["w_up"]), ff["w_down"])
        del ff
    return list((rows + y).split([x.shape[0] for x in out]))


@torch.no_grad()
def logits(m: dict, params: dict, seqs: list, rows: list,
           fp8: bool = False) -> torch.Tensor:
    """Logits (R, V), float32, at the given rows of the given sequences.

    seqs: 1-D int64 token tensors on the weights' device; rows: for each
    sequence the positions whose next-token logits are wanted, in order.
    The result stacks them sequence after sequence."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mat = _Mat(fp8)
    emb = params["embed"]
    xs = [emb[t].to(torch.float32) for t in seqs]
    for p in params["layers"]:
        xs = _layer(p, xs, m, mat)
    h = torch.cat([x[r] for x, r in zip(xs, rows)])
    h = rmsnorm(h, params["final_norm"]["w"], m["norm_eps"])
    head = params["lm_head"]
    out = torch.empty(h.shape[0], head.shape[1], dtype=torch.float32,
                      device=h.device)
    for a in range(0, head.shape[1], 16384):
        out[:, a:a + 16384] = mat(h, mat.w(head[:, a:a + 16384]))
    return out
