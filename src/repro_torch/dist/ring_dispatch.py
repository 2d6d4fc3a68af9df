"""Ring (kv-sequence-sharded) attention — the port of the JAX package's
``dist/ring_dispatch.py``.

The spatial regime (``kernels.ops``) shards attention over batch and
heads, free of collectives; the ring regime splits the kv axis — the
chain's cross-op reduction — over the tp-or-model mesh dim, runs the
partial-softmax kernel (``kernels.attention.fused_attention_partial``)
on each rank's kv block at its GLOBAL positions, and combines the
per-rank ``(o_unnorm, m, l)`` triples with the log-sum-exp merge.

The combine is the JAX package's: an all-reduce MAX of the per-row max,
each rank's partial rescaled once against it, then all-reduce sums of
the rescaled numerator (at the query dtype, the bytes the tuner
prices) and of the f32 denominator.  ``pipelined=True`` replaces the
two sums by the software-pipelined ring the tuner prices under
``MeshSpec(pipelined=True)``: the rows chunked ``n`` ways, a ring
reduce-scatter of ``n - 1`` hops (``collectives.Axis.shift``, the JAX
package's ``ppermute``), each owner finalising its chunk, and a ring
all-gather of ``n - 1`` more hops.  Each chunk folds the same addends
as the serial sum, from a rotated first rank, so the two agree to a
few f32 ulps, and every rank returns the same bits.
``combine_partials`` is the order-canonical host-level spec of the
serial combine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .collectives import Axis, axis
from .sharding import Rules, mesh_shape, ring_dispatch_spec


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """One viable ring dispatch: where the kv axis splits and the
    MeshSpec the tuner prices it under."""

    spec: object                  # core.perf_model.MeshSpec
    batch_axes: tuple[str, ...]
    axis: str                     # mesh dim carrying the kv split
    n_shards: int


def plan_ring_attention(rules: Rules, mesh, *, batch: int, kv_len: int,
                        feature_dims: tuple[int, ...] = (),
                        ici_bw: Optional[float] = None
                        ) -> Optional[RingPlan]:
    """The ring regime for this mesh, or None when no mesh dim can split
    ``kv_len`` evenly (then only the spatial regime exists)."""
    spec, baxes, ax = ring_dispatch_spec(rules, mesh, batch=batch,
                                         kv_len=kv_len,
                                         feature_dims=feature_dims,
                                         ici_bw=ici_bw)
    if ax is None:
        return None
    return RingPlan(spec=spec, batch_axes=baxes, axis=ax,
                    n_shards=mesh_shape(mesh)[ax])


def ring_group(q_heads: int, kv_heads: int, q_len: int) -> int:
    """The GQA group the ring's partial kernel runs at: the model's for
    one query row (a decode step), 1 for more rows — the kv heads
    repeated to the q heads — since a block holds ``group x bq`` query
    rows and at a prefill's or a forward's rows those of a whole group
    do not fit the kernel's shared memory.  The tuner prices the ring
    regime at this group (``core.api.fuse_attention_regimes``)."""
    return q_heads // kv_heads if q_len == 1 else 1


# ---------------------------------------------------------------------------
# the log-sum-exp combine: pure functions
# ---------------------------------------------------------------------------

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


def combine_partials(parts, dtype: torch.dtype) -> torch.Tensor:
    """Order-canonical combine of per-shard partial states — the
    arithmetic of the serial combine as a pure function.

    ``parts``: iterable of ``(shard_index, (o_unnorm, m, l))`` in any
    arrival order.  The global max is an exact, order-free reduction;
    each shard is rescaled once against it (not the iterative
    ``merge_partials`` fold); the rescaled addends are summed left to
    right in shard-index order.  So the result is bitwise the same for
    every arrival order.  ``dtype`` is the wire type the numerator is
    cast to before summing, as ``ring_attention``'s."""
    parts = [p for _, p in sorted(parts, key=lambda sp: sp[0])]
    if not parts:
        raise ValueError("combine_partials needs at least one shard")
    m_glob = parts[0][1]
    for _, m, _ in parts[1:]:
        m_glob = torch.maximum(m_glob, m)
    num = den = None
    for o, m, l in parts:
        corr = torch.exp(m - m_glob)
        ni = (o * corr).to(dtype)
        di = l * corr
        num = ni if num is None else num + ni
        den = di if den is None else den + di
    return finalize_partials(num.float(), den, dtype)


def _ring_combine_pipelined(num: torch.Tensor, den: torch.Tensor, ax: Axis,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """The pipelined combine: a ring reduce-scatter of the rescaled
    ``(num, den)`` partials, the owner's finalize, a ring all-gather of
    the finished chunks.  ``num``: (..., Dv) at the wire type, ``den``:
    (...) f32, both already rescaled by ``exp(m_local - m_glob)``; the
    rows (the flattened leading dims) must divide over the ring.  Chunk
    ``c``'s accumulator starts at rank ``c + 1`` and folds left to right
    around the ring, and rank ``c`` ends owning it."""
    n, d = ax.size, ax.index
    lead, dv = num.shape[:-1], num.shape[-1]
    rows = math.prod(lead)
    if rows % n:
        raise ValueError(f"{rows} rows do not chunk over a ring of {n}")
    c = rows // n
    x = num.reshape(n, c, dv)
    y = den.reshape(n, c)
    acc_n, acc_d = x[(d - 1) % n], y[(d - 1) % n]
    for t in range(n - 1):
        acc_n, acc_d = ax.shift(acc_n), ax.shift(acc_d)
        idx = (d - 2 - t) % n
        acc_n = acc_n + x[idx]
        acc_d = acc_d + y[idx]
    own = finalize_partials(acc_n.float(), acc_d[..., None], out_dtype)
    out = torch.empty((n, c, dv), dtype=out_dtype, device=num.device)
    out[d] = own
    cur = own
    for t in range(n - 1):
        cur = ax.shift(cur)
        out[(d - 1 - t) % n] = cur
    return out.reshape(*lead, dv)


def ring_combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, ax: Axis,
             wire: torch.dtype, out_dtype: torch.dtype,
             pipelined: bool) -> torch.Tensor:
    """The executed combine of one rank's partial (o, m, l) over ``ax``:
    all-reduce MAX of m, a single rescale, then the serial all-reduce
    sums (the numerator at ``wire``) or the pipelined ring.  The
    output has o's shape, whole on every rank of ``ax``."""
    m_glob = ax.all_reduce(m, op="max")
    corr = torch.exp(m - m_glob)
    num = (o * corr).to(wire)
    den = l * corr
    if pipelined:
        return _ring_combine_pipelined(num, den[..., 0], ax, out_dtype)
    num, den = _sum_both(ax, num, den)
    return finalize_partials(num.float(), den, out_dtype)


def _sum_both(ax: Axis, num: torch.Tensor, den: torch.Tensor) -> tuple:
    """The all-reduce sums of ``num`` (..., Dv) and ``den`` (..., 1): one
    collective where they share a type."""
    if num.dtype != den.dtype:
        return ax.all_reduce(num), ax.all_reduce(den)
    both = ax.all_reduce(torch.cat([num, den], dim=-1))
    return both[..., :-1], both[..., -1:]


def _partial(q, k, v, kv_pos, q_pos, *, causal: bool, window: int,
             scale: float, bq: int, bkv: int, kernel: bool) -> tuple:
    """This rank's partial (o, m, l): the partial kernel under its guard
    (``kernels.ops._guarded``, served by the one-pass oracle when
    degraded) where ``kernel`` and the tensors are on the card, its
    plain version on a CPU tensor, else the oracle.  The packed
    (o, m, l) is what the guard's shadow compares."""
    from ..kernels import ref
    from ..kernels.attention import fused_attention_partial
    from ..kernels.ops import _dtype_name, _guarded

    def _oracle():
        return ref.partial_attention_ref(q, k, v, kv_pos, q_pos, causal,
                                         window, scale)

    if not kernel:
        return _oracle()

    def _run():
        return torch.cat(fused_attention_partial(
            q, k, v, kv_pos, q_pos, bq=bq, bkv=bkv, causal=causal,
            window=window, scale=scale), dim=-1)

    dv = v.shape[-1]
    fp = ("attn-ring", tuple(q.shape), tuple(k.shape), causal, window, bq,
          bkv, _dtype_name(q))
    packed = _guarded(fp, _run, lambda: torch.cat(_oracle(), dim=-1))
    return packed[..., :dv], packed[..., dv:dv + 1], packed[..., dv + 1:]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis_name: str, causal: bool = False,
                   window: int = 0, scale: Optional[float] = None,
                   bq: int = 128, bkv: int = 128,
                   pipelined: bool = False) -> torch.Tensor:
    """softmax(Q K^T) V with the kv sequence split over ``axis_name``;
    the output is whole on every rank of that dim.

    q: (B, Hq, M, D), k/v: (B, Hkv, N, D/Dv) — this rank's batch rows,
    every head, the WHOLE kv sequence; the rank keeps its block of
    ``N / n`` keys (N % n == 0: callers gate with
    ``plan_ring_attention``).  ``bq``/``bkv`` are the tiles the tuner
    picked for the local sub-problem, at the GQA group ``ring_group``
    gives (more than one query row: kv heads repeated to the q heads).
    Queries sit at the tail of the global kv sequence, and each rank
    masks by global positions, so causal and window boundaries inside a
    block are exact.  The partial kernel runs on the card, its plain
    version on a CPU tensor.  ``pipelined``: the ring combine (module
    doc); callers gate on ``B * Hq * M`` divisible by the dim's size."""
    ax = axis(mesh, axis_name)
    b, hq, m, d = q.shape
    n = k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kl, vl = ax.shard(k, 2), ax.shard(v, 2)
    if ring_group(hq, k.shape[1], m) == 1:
        group = hq // k.shape[1]
        kl, vl = (kl.repeat_interleave(group, dim=1),
                  vl.repeat_interleave(group, dim=1))
    kl, vl = kl.contiguous(), vl.contiguous()
    n_loc = n // ax.size
    kv_pos = ax.index * n_loc + torch.arange(n_loc, dtype=torch.int32,
                                             device=q.device)
    q_pos = n - m + torch.arange(m, dtype=torch.int32, device=q.device)
    o, mm, ll = _partial(q.contiguous(), kl, vl, kv_pos, q_pos,
                         causal=causal, window=window, scale=scale, bq=bq,
                         bkv=bkv, kernel=True)
    return ring_combine(o, mm, ll, ax, q.dtype, q.dtype, pipelined)


def paged_ring_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                positions: torch.Tensor, *, window: int,
                                scale: float, mesh, axis_name: str,
                                pipelined: bool = False,
                                kernel: bool = False,
                                block: Optional[tuple] = None
                                ) -> torch.Tensor:
    """Paged decode attention with the page-table COLUMNS (the kv
    reduction at page granularity) split over ``axis_name``.

    q: (B, Hq, 1, D), every head; k_pages/v_pages: (n_pages, Hkv, ps,
    D), the pools WHOLE on every rank (the engine's writes land alike
    on each), of which each rank gathers only its ``max_pages / n``
    columns of every request's table; page_table: (B, max_pages),
    max_pages divisible by the dim's size (callers gate); positions:
    (B,) each request's current row (-1 = inactive slot).

    Each rank's partial softmax over its gathered columns is
    ``_partial``'s: with ``kernel`` on a CUDA tensor the partial kernel
    at the engine's tiles ``block``, else the one-pass oracle.  The
    combine is ``ring_attention``'s, with the numerator summed in f32
    on the serial ring and at the query type on the pipelined one, as
    in the JAX package.  Callers of ``pipelined``
    gate on ``B * Hq`` divisible by the dim's size."""
    from ..kernels.attention import INVALID_POS
    from ..serving.kv_pages import gather_pages, paged_kv_positions

    ax = axis(mesh, axis_name)
    ps = k_pages.shape[2]
    tbl = ax.shard(page_table, 1)
    mpl = tbl.shape[1]
    kk = gather_pages(k_pages, tbl)          # (B, Hkv, mpl*ps, D)
    vv = gather_pages(v_pages, tbl)
    kv_pos = paged_kv_positions(tbl, ps, invalid=INVALID_POS,
                                first_page=ax.index * mpl)
    rows = positions.to(torch.int32)[:, None]        # (B, 1) == (B, M)
    bq, bkv = block if block is not None else (1, 128)
    o, m_loc, l_loc = _partial(q.contiguous(), kk, vv, kv_pos, rows,
                               causal=True, window=window, scale=scale,
                               bq=bq, bkv=bkv, kernel=kernel and q.is_cuda)
    wire = q.dtype if pipelined else torch.float32
    return ring_combine(o, m_loc, l_loc, ax, wire, q.dtype, pipelined)
