"""The log-sum-exp combine of partial-softmax states — the single-device
part of the JAX package's ``dist/ring_dispatch.py``; the mesh regimes
come with the distributed slice."""
from __future__ import annotations

import torch


def merge_partials(a, b):
    """Associative merge of two partial-softmax states.

    Each state is ``(o_unnorm, m, l)`` as emitted by
    ``fused_attention_partial`` (stat tensors broadcastable against
    ``o_unnorm``'s leading dims).  Commutative and associative — shard
    order cannot change the result beyond f32 rounding — with identity
    ``(0, NEG_INF, 0)``, which is what fully-masked shards emit."""
    oa, ma, la = a
    ob, mb, lb = b
    m = torch.maximum(ma, mb)
    ca = torch.exp(ma - m)
    cb = torch.exp(mb - m)
    return oa * ca + ob * cb, m, la * ca + lb * cb


def finalize_partials(o: torch.Tensor, l: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Normalize a (fully merged) partial state into the attention
    output; rows masked everywhere (l == 0) come out as zeros, matching
    the fused kernel's fully-masked-row convention."""
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l).to(dtype)
