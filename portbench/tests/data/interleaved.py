"""A test-only architecture, found through ``spec.architecture``'s
``where``: the ``decoder`` with attention only in the layers whose
``pattern`` entry (repeated over the depth) is ``"attn"``; every other
layer holds its norm and its MLP alone.  It stands for a hybrid whose
attention is in a few layers, and is built from files of its own and
the ``decoder`` module, as a new architecture would be."""
from __future__ import annotations

import torch

from portbench.reference import decoder as D


def _attends(m: dict, i: int) -> bool:
    pat = m["pattern"]
    return pat[i % len(pat)] == "attn"


def layout(m: dict) -> list:
    return [leaf for leaf in D.layout(m)
            if leaf[0][0] != "layers" or _attends(m, leaf[0][1])
            or leaf[0][2] not in ("ln1", "mix")]


def attention_layers(m: dict) -> int:
    return sum(_attends(m, i) for i in range(m["n_layers"]))


def _mlp_layer(p: dict, xs: list, m: dict, mat) -> list:
    rows = torch.cat(xs)
    h = D.rmsnorm(rows, p["ln2"]["w"], m["norm_eps"])
    ff = {k: mat.w(p["ff"][k]) for k in ("w_gate", "w_up", "w_down")}
    y = mat(torch.nn.functional.silu(mat(h, ff["w_gate"]))
            * mat(h, ff["w_up"]), ff["w_down"])
    return list((rows + y).split([x.shape[0] for x in xs]))


@torch.no_grad()
def logits(m: dict, params: dict, seqs: list, rows: list,
           fp8: bool = False) -> torch.Tensor:
    mat = D._Mat(fp8)
    xs = [params["embed"][t].to(torch.float32) for t in seqs]
    for i, p in enumerate(params["layers"]):
        xs = (D._layer if _attends(m, i) else _mlp_layer)(p, xs, m, mat)
    h = torch.cat([x[r] for x, r in zip(xs, rows)])
    h = D.rmsnorm(h, params["final_norm"]["w"], m["norm_eps"])
    return mat(h, mat.w(params["lm_head"]))


def prefill_flops(m: dict, length: int) -> float:
    pairs = length * (length + 1) / 2
    return (attention_layers(m) * (length * D.proj_flops(m)
                                   + D.attn_core_flops(m, pairs))
            + m["n_layers"] * length * D.ffn_flops(m) + D.lm_head_flops(m))


def decode_flops(m: dict, keys: int) -> float:
    return (attention_layers(m) * (D.proj_flops(m)
                                   + D.attn_core_flops(m, keys))
            + m["n_layers"] * D.ffn_flops(m) + D.lm_head_flops(m))
