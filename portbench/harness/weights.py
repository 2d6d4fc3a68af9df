"""The served model's weights, made by the benchmark from the run's seed.

The tree is the parameter layout ``repro_torch.models.lm.LM`` takes
(``embed``, ``final_norm``, ``lm_head``, and per layer ``ln1``, ``mix``,
``ln2``, ``ff``), and the same tensors are what the plain reference
reads.  They are drawn on the device by a ``torch.Generator`` seeded
from ``--seed``, in two calls: one normal draw in the served type for
every matrix, one in float32 for the norms' and the router's weights;
each leaf is then a view of its draw, scaled in place.

Scales: the embedding N(0, 1); every input projection N(0, 1 / fan_in);
the attention output and the MLP's down projection also divided by
sqrt(2 * n_layers), so the residual stream stays near unit size over
the depth, as a trained model's does; the unembedding N(0, 1 / d_model),
so logits are of unit size; the router N(0, 1 / d_model) in float32;
each rmsnorm weight w (the scale is 1 + w) N(0, 0.1^2).
"""
from __future__ import annotations

import math

import torch


def _layout(m: dict) -> list:
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


def make(m: dict, seed: int, device) -> dict:
    """The weights of model config ``m`` (the configuration file's
    ``model`` dict) for ``seed``, on ``device``."""
    device = torch.device(device)
    dt = getattr(torch, m["dtype"])
    leaves = _layout(m)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = {}
    for kind, typ in (("mat", dt), ("f32", torch.float32)):
        n = sum(math.prod(s) for _, s, k, _ in leaves if k == kind)
        flat[kind] = torch.randn(n, generator=gen, dtype=typ, device=device)
    params: dict = {"layers": [{"ln1": {}, "ln2": {}, "mix": {}, "ff": {}}
                               for _ in range(m["n_layers"])]}
    params["final_norm"] = {}
    off = {"mat": 0, "f32": 0}
    for path, shape, kind, scale in leaves:
        n = math.prod(shape)
        t = flat[kind][off[kind]:off[kind] + n].view(shape)
        off[kind] += n
        t.mul_(scale)
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = t
    return params
