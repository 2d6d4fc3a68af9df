"""The served model's weights, made by the benchmark from the run's seed.

The leaves, their shapes and scales are the architecture's
(``layout(m)`` of its module in ``portbench/reference``), laid into the
tree ``repro_torch.models.lm.LM`` takes: a leaf's path names its dict
keys, an integer a list's index (``("layers", 3, "mix", "wq")``).  The
same tensors are what the plain reference reads.  They are drawn on the
device by a ``torch.Generator`` seeded from ``--seed``, in two calls:
one normal draw in the served type for every "mat" leaf, one in float32
for every "f32" leaf, each in the layout's order; each leaf is then a
view of its draw, scaled in place.
"""
from __future__ import annotations

import math

import torch


def _tree(node):
    """Nested dicts into the program's tree: a dict keyed 0..n-1 becomes
    a list."""
    if not isinstance(node, dict):
        return node
    out = {k: _tree(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def make(arch, m: dict, seed: int, device) -> dict:
    """The weights of model config ``m`` (the configuration file's
    ``model`` dict) of architecture module ``arch`` for ``seed``, on
    ``device``."""
    device = torch.device(device)
    dt = getattr(torch, m["dtype"])
    leaves = arch.layout(m)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = {}
    for kind, typ in (("mat", dt), ("f32", torch.float32)):
        n = sum(math.prod(s) for _, s, k, _ in leaves if k == kind)
        flat[kind] = torch.randn(n, generator=gen, dtype=typ, device=device)
    params: dict = {}
    off = {"mat": 0, "f32": 0}
    for path, shape, kind, scale in leaves:
        n = math.prod(shape)
        t = flat[kind][off[kind]:off[kind] + n].view(shape)
        off[kind] += n
        t.mul_(scale)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return _tree(params)
